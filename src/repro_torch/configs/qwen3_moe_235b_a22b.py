"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-*]: 128 experts, top-8, per-expert
d_ff=1536."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3_moe_235b_a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab_size=151936, head_dim=128,
    n_experts=128, experts_per_token=8,
    rope_theta=1_000_000.0, optimizer="adafactor",
)
