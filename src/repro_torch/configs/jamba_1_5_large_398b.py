"""Jamba-1.5-Large 398B [arXiv:2403.19887]: Mamba+attention 1:7 interleave,
MoE (16 experts, top-2) on every other layer."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba_1_5_large_398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab_size=65536, head_dim=128,
    n_experts=16, experts_per_token=2, moe_every=2,
    attn_every=8, ssm_state=16, ssm_conv=4, ssm_expand=2,
    optimizer="adafactor",
)
