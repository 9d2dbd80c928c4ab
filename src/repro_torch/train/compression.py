"""Gradient compression with error feedback (int8, per-tensor scale).

The port of the numerics level of ``repro.train.compression``:
``ef_compress`` quantises a gradient tree, each leaf plus its carried
residual, to int8 resolution and returns the new residuals (error
feedback, which keeps the optimizer unbiased in expectation);
``ef_state`` makes the zero residuals.  The collective level, the
reference's ``compressed_psum`` (an int8 all-gather inside a
data-parallel shard_map), waits for the port's ``torch.distributed``
data parallelism.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map

__all__ = ["ef_state", "ef_compress"]


def ef_state(params):
    """Zero f32 residual tree matching the parameter tree."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_dequant(g: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp_min(g.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def ef_compress(grads, residuals):
    """Quantise grads + residuals to int8 resolution; returns
    (compressed grads, new residuals), trees like ``grads``."""
    if isinstance(grads, dict):
        pairs = {k: ef_compress(grads[k], residuals[k]) for k in grads}
        return ({k: c for k, (c, _) in pairs.items()},
                {k: r for k, (_, r) in pairs.items()})
    if isinstance(grads, list):
        pairs = [ef_compress(g, r) for g, r in zip(grads, residuals)]
        return [c for c, _ in pairs], [r for _, r in pairs]
    target = grads.float() + residuals
    deq = _quant_dequant(target)
    return deq.to(grads.dtype), target - deq
