"""xLSTM-350M [arXiv:2405.04517]: mLSTM blocks with sparse sLSTM blocks
(approximately the paper's [7:1] ratio), no separate FFN (d_ff=0)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm_350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304, head_dim=256,
    slstm_at=(5, 13, 21),
)
