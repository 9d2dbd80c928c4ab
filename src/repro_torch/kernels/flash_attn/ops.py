"""K4 wrapper: fused flash-decode attention with the RAPID combine divide.

The port of ``repro.kernels.flash_attn``.  ``flash_decode_attn`` takes
qf ``[B, KV, G, hd]`` pre-scaled f32 queries against caches
``[B, C, KV, hd]`` (bf16 or f32), slot positions ``[B, C]`` int32
(INT32_MAX marks an empty slot) and the current position ``pos`` (int,
``[B]`` or ``[B, 1]``); returns ``[B, KV, G, hd]`` f32: the score and
value contractions exact f32, the combine divide ``acc / max(l, floor)``
RAPID when ``scheme`` is set.

* CPU tensors run the plain version :func:`flash_decode_plain`.
* CUDA tensors launch ``csrc/flash_attn.cu`` (replacing the Pallas
  ``flash_decode_pallas``, ``src/repro/kernels/flash_attn/flash_attn.py``),
  one CTA per (batch, kv-head) row, reading the caches in their own
  layout and type.  ``flash_decode_attn.launches`` counts launches.

The plain version runs the kernel's own order of operations -- an
online softmax over chunks of :data:`CHUNK` cache slots, each dot and
each sum taken in index order, one rounding per op -- so on the card
the kernel is bit-equal to it, and a model's greedy tokens cannot part
between the two routes.  It is therefore a transcription of the
kernel's algorithm, not an independent check of it: the independent
reference for K4 is the JAX package's one-max formulation,
``repro.kernels.flash_attn.ref.decode_attn_ref``, to which
``tests/test_torch_kernels.py`` holds the plain version on the CPU
(rtol 1e-5, atol 1e-6).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build
from repro_torch.kernels._launch import on_cuda, ptr, require, stream
from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR

__all__ = ["CHUNK", "flash_decode_attn", "flash_decode_plain"]


def _positions(pos, b: int, device) -> torch.Tensor:
    """pos (int | [B] | [B, 1]) -> contiguous int32 [B] on ``device``."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos).to(device=device, dtype=torch.int32)
    return p.reshape(-1).expand(b).contiguous() if p.numel() == 1 \
        else p.reshape(b).contiguous()


# cache slots per step of the kernel's online softmax: BC in
# csrc/flash_attn.cu, which the wrapper's first launch reads back and
# checks (a CPU-only run never sees the .cu's value)
CHUNK = 32
_chunk_checked = False


def _check_kernel_chunk() -> None:
    global _chunk_checked
    bc = _build.function("flash_attn", "rapid_flash_decode_chunk", [])()
    if bc != CHUNK:
        raise RuntimeError(f"flash_attn.cu walks the cache in chunks of {bc} "
                           f"slots, the plain version in chunks of {CHUNK}")
    _chunk_checked = True


def flash_decode_plain(qf, k_cache, v_cache, slot_positions, pos,
                       window: int = 0, scheme: Optional[str] = None, *,
                       floor: float = SOFTMAX_FLOOR) -> torch.Tensor:
    """Plain PyTorch version of K4, in the kernel's order (any device).

    Scores are exact f32 dots summed over ``hd`` in index order; masked
    slots (position past ``pos``, outside the window, INT32_MAX) score
    -inf.  The cache is walked in chunks of :data:`CHUNK` slots, zero
    padded, folding each into the running (m, l, acc) with the chunk's
    weights summed in slot order.  Fully-masked rows give 0.
    """
    B, KV, G, hd = qf.shape
    C = k_cache.shape[1]
    pad = (-C) % CHUNK
    posq = _positions(pos, B, qf.device)[:, None]
    valid = slot_positions <= posq
    if window:
        valid &= slot_positions > posq - window
    valid = F.pad(valid, (0, pad), value=False)[:, None, None, :]
    kt = F.pad(k_cache.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 3, 1)
    vt = F.pad(v_cache.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    dot = torch.zeros((B, KV, G, C + pad), device=qf.device)
    for d in range(hd):  # [B, KV, G, 1] x [B, KV, 1, Cp]
        dot = dot + qf[..., d, None] * kt[:, :, None, d, :]
    s = torch.where(valid, dot, -torch.inf)

    m = torch.full((B, KV, G), -torch.inf, device=qf.device)
    l = torch.zeros((B, KV, G), device=qf.device)
    acc = torch.zeros((B, KV, G, hd), device=qf.device)
    for c0 in range(0, C + pad, CHUNK):
        sc = s[..., c0:c0 + CHUNK]
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.where(torch.isfinite(m_new)[..., None],
                        torch.exp(sc - m_new[..., None]), 0.0)
        total = torch.zeros_like(l)
        pv = torch.zeros_like(acc)
        for j in range(CHUNK):
            total = total + p[..., j]
            pv = pv + p[..., j, None] * vt[:, :, None, c0 + j, :]
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * corr + total
        acc = acc * corr[..., None] + pv
        m = m_new
    den = torch.where(l < floor, floor, l)[..., None]
    if scheme:
        return fa.log_div_f32(acc, den, fa.div_lut_device(scheme, qf.device))
    return acc / den


def flash_decode_attn(qf: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, slot_positions: torch.Tensor,
                      pos, window: int = 0, scheme: Optional[str] = None, *,
                      floor: float = SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused single-token attention; same contract as
    :func:`flash_decode_plain`."""
    if not on_cuda(qf, k_cache, v_cache, slot_positions):
        return flash_decode_plain(qf, k_cache, v_cache, slot_positions, pos,
                                  window, scheme, floor=floor)
    b, kv, g, hd = qf.shape
    c = k_cache.shape[1]
    require(qf, "qf", torch.float32)
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"caches must be bf16 or f32, got {k_cache.dtype}")
    require(k_cache, "k_cache", k_cache.dtype, (b, c, kv, hd))
    require(v_cache, "v_cache", k_cache.dtype, (b, c, kv, hd))
    require(slot_positions, "slot_positions", torch.int32, (b, c))
    if not _chunk_checked:
        _check_kernel_chunk()
    posv = _positions(pos, b, qf.device)
    lut = fa.div_lut_device(scheme, qf.device) if scheme else None
    out = torch.empty_like(qf)
    fn = _build.function("flash_attn", "rapid_flash_decode",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(ptr(qf), ptr(k_cache), ptr(v_cache), ptr(slot_positions),
             ptr(posv), ptr(lut), ptr(out), b * kv, c, kv, g, hd, int(window),
             float(floor), int(k_cache.dtype == torch.bfloat16),
             stream(qf.device))
    _build.check(err, "flash_decode")
    flash_decode_attn.launches += 1
    return out


flash_decode_attn.launches = 0
