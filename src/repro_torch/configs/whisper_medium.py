"""Whisper-medium backbone [arXiv:2212.04356]: encoder-decoder; the conv
frontend is a stub, as the reference's: a batch carries precomputed
frame embeddings (``enc_embeds``, 1024 wide)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper_medium", family="encdec",
    n_layers=24, n_encoder_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    act="gelu", norm="ln", frontend_seq=1500,
)
