"""Llama-4-Scout 17B-A16E [hf:meta-llama]: MoE 16 experts top-1 with an
always-on shared expert; the early-fusion frontend is out of the
backbone's scope."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_scout_17b_a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    n_experts=16, experts_per_token=1, shared_expert=True,
    rope_theta=500000.0,
)
