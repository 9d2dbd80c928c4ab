"""LLaVA-NeXT-34B backbone [hf:llava-hf/llava-v1.6-34b-hf]: a Yi-34B-like
decoder; the anyres vision tiling is a stub, as the reference's: a batch
carries precomputed patch embeddings (``patches``, 576 of them, 1024
wide), which the projector maps ahead of the prompt."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000, head_dim=128,
    frontend_seq=576, rope_theta=5_000_000.0,
)
