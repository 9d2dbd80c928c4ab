"""StarCoder2-7B [arXiv:2402.19173]: GQA, RoPE, LN + GELU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2_7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152, head_dim=128,
    act="gelu", norm="ln", rope_theta=100000.0,
)
