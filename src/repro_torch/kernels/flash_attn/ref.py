"""Plain PyTorch semantics of single-token (decode) attention.

The port of ``repro.kernels.flash_attn.ref`` and the plain version of
kernel K4.  One query token per (batch, kv-head) row attends to a cache
of ``C`` slots whose absolute positions live in ``slot_positions``
(INT32_MAX marks an empty slot, which causality masks out).  The score
and value contractions are exact f32; only the combine divide is
approximate (RAPID when ``scheme`` is set).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import float_approx as fa
from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR

__all__ = ["SOFTMAX_FLOOR", "canon_posq", "decode_stats", "decode_attn_ref"]


def canon_posq(pos, device=None) -> torch.Tensor:
    """Current-position arg (int | [B] | [B, 1]) -> int32, broadcastable
    against [B, C] slot maps."""
    posq = torch.as_tensor(pos, dtype=torch.int32, device=device)
    if posq.ndim == 1:
        posq = posq[:, None]
    return posq


def decode_stats(qf, kc, vc, sp, posq, window: int):
    """Per-row softmax stats (m, l, acc) for one decode step.

    qf: [B, KV, G, hd] pre-scaled f32 queries; kc/vc: [B, C, KV, hd];
    sp: [B, C] absolute slot positions; posq: scalar or [B, 1].
    Fully-masked rows yield m = -inf, l = 0, acc = 0.
    """
    s = torch.einsum("bkgh,bckh->bkgc", qf, kc.float())
    mask = sp <= posq
    if window:
        mask &= sp > posq - window
    s = torch.where(mask[:, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1)
    p = torch.where(torch.isfinite(m)[..., None], torch.exp(s - m[..., None]),
                    0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgc,bckh->bkgh", p, vc.float())
    return m, l, acc


def decode_attn_ref(qf, k_cache, v_cache, slot_positions, pos, window: int,
                    scheme: Optional[str], *,
                    floor: float = SOFTMAX_FLOOR) -> torch.Tensor:
    """Exact-stats decode attention with the floored softmax combine.
    Returns [B, KV, G, hd] f32; fully-masked rows give 0."""
    posq = canon_posq(pos, qf.device)
    _, l, acc = decode_stats(qf, k_cache, v_cache, slot_positions, posq,
                             window)
    l = torch.clamp_min(l, floor)[..., None]
    if scheme:
        return fa.log_div_f32(acc, l, fa.div_lut_device(scheme, qf.device))
    return acc / l
