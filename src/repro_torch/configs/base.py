"""Config system of the port: model and approximation configs.

Mirrors ``repro.configs.base`` for the dense serve path.  ``ApproxConfig``
keeps the reference's ``mul``/``div``/``on_*`` semantics but drops its
per-site ``backends`` map and the ``RAPID_BACKEND`` environment
variable: the port has one dispatch path, and the device of the tensor
decides it (a CPU tensor takes each kernel's plain PyTorch version, a
CUDA tensor launches the kernel).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["ARCH_IDS", "ApproxConfig", "ModelConfig", "EXACT", "RAPID",
           "get_config"]

# the architectures this slice ports (dense family only)
ARCH_IDS = ("h2o_danube_1_8b", "yi_6b", "minicpm_2b")


@dataclass(frozen=True)
class ApproxConfig:
    """Where and how the RAPID units replace exact arithmetic."""

    mul_scheme: Optional[str] = None   # None/"exact" | "mitchell" | "rapid3/5/10"
    div_scheme: Optional[str] = None   # None/"exact" | "mitchell" | "rapid3/5/9"
    # which matmuls route through the logarithmic multiplier
    on_mlp: bool = True
    on_attn_proj: bool = True
    on_logits: bool = False
    # which divisions route through the logarithmic divider
    on_softmax: bool = True
    on_norm: bool = True

    @property
    def active(self) -> bool:
        return self.mul_scheme not in (None, "exact") or self.div_scheme not in (
            None, "exact")

    def mul(self, site: str) -> Optional[str]:
        if self.mul_scheme in (None, "exact"):
            return None
        return self.mul_scheme if getattr(self, f"on_{site}") else None

    def div(self, site: str) -> Optional[str]:
        if self.div_scheme in (None, "exact"):
            return None
        return self.div_scheme if getattr(self, f"on_{site}") else None


EXACT = ApproxConfig()
RAPID = ApproxConfig(mul_scheme="rapid10", div_scheme="rapid9")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense (the only family this slice ports)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    act: str = "silu"  # silu (swiglu)
    norm: str = "rms"
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    sliding_window: int = 0  # 0 = full attention
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    approx: ApproxConfig = field(default_factory=ApproxConfig)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256, as the reference."""
        return -(-self.vocab_size // 256) * 256

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's sizes)."""
        return self.with_(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            head_dim=32,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
        )


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    return mod.CONFIG
