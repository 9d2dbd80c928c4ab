"""Shared arithmetic dispatch for the three end-to-end applications.

The port of ``repro.apps.arith``.  Each app runs under a named
:class:`Variant` that fixes which multiplier / divider every stage uses
-- accurate, RAPID, plain Mitchell, or the truncated DRUM/AAXD baselines
-- mirroring the paper's end-to-end comparison matrix (SSV-B).

The scheme-routed arms go through the port's ops: ``mul`` through
:func:`~repro_torch.core.float_approx.approx_mul`, ``div`` through
:func:`~repro_torch.core.ops.qdiv` (kernel K6 on operands broadcast to
one shape), ``matmul`` / ``matmul_batched`` through ``qmatmul`` /
``qmatmul_batched`` (kernel K1).  The reference's backend registry has
no counterpart: the tensors' device picks kernel (CUDA) or plain
version (CPU).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import float_approx as fa
from repro_torch.core import ops
from repro_torch.core.truncated import aaxd_div_f32, drum_mul_f32

__all__ = ["Variant", "VARIANTS", "psnr"]


@dataclass(frozen=True)
class Variant:
    name: str
    mul_kind: str  # exact | scheme name | drum
    div_kind: str  # exact | scheme name | aaxd

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.mul_kind == "exact":
            return a * b
        if self.mul_kind == "drum":
            return drum_mul_f32(a, b)
        return fa.approx_mul(a, b, self.mul_kind)

    def div(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.div_kind == "exact":
            return a / b
        if self.div_kind == "aaxd":
            return aaxd_div_f32(a, b)
        a = torch.as_tensor(a, dtype=torch.float32)
        b = torch.as_tensor(b, dtype=torch.float32, device=a.device)
        a, b = torch.broadcast_tensors(a, b)
        return ops.qdiv(a, b, self.div_kind)

    def matmul(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x: [..., K]; w: [K, N] -> [..., N] through the variant's
        multiplier."""
        if self.mul_kind == "exact":
            return x @ w
        if self.mul_kind == "drum":
            return self.mul(x[..., :, None], w).sum(dim=-2)
        return ops.qmatmul(x, w, self.mul_kind)

    def matmul_batched(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Batched [*B, M, K] x [*B, K, N] through the variant multiplier."""
        if self.mul_kind == "exact":
            return a @ b
        if self.mul_kind == "drum":
            prod = self.mul(a[..., :, :, None], b[..., None, :, :])
            return prod.sum(dim=-2)
        return ops.qmatmul_batched(a, b, self.mul_kind)


VARIANTS = {
    "accurate": Variant("accurate", "exact", "exact"),
    "rapid": Variant("rapid", "rapid10", "rapid9"),
    "rapid5": Variant("rapid5", "rapid5", "rapid5"),
    "mitchell": Variant("mitchell", "mitchell", "mitchell"),
    "truncated": Variant("truncated", "drum", "aaxd"),
}


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def psnr(ref, test, peak: float) -> float:
    """Peak signal-to-noise ratio in dB (inf for identical inputs), on
    the host: a QoR metric, not an approximated datapath."""
    mse = float(np.mean(np.square(_host_f32(ref) - _host_f32(test))))
    if mse == 0:
        return float("inf")
    return 10.0 * math.log10(peak * peak / mse)
