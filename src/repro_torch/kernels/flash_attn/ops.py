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
  ``flash_decode_pallas``, ``src/repro/kernels/flash_attn/flash_attn.py``):
  one block per (row, segment), where a row is a (batch, kv-head) pair
  and a segment a run of whole cache chunks; the last block of a row to
  finish combines the row's segments.  One launch a call, counted in
  ``flash_decode_attn.launches`` (through ``count_launch``, so a CUDA
  graph's replays count too).  A build or launch error raises.

Order of operations, shared by the kernel and the plain version, with
the geometry from ``kernels/spec.py`` (``resolve_spec("flash_attn",
(rows, C))``: chunk ``bk``, segment ``bn`` slots):

1. each segment folds its chunks in order with the online softmax:
   scores are exact f32 dots summed over ``hd`` in index order (masked
   slots -inf); ``m_new = max(m, max of the chunk)``; the chunk's
   weights ``p = exp(s - m_new)`` are summed by halving (slot j plus
   slot j + bk/2, then again, as a warp's butterfly); ``pv`` sums
   ``p * v`` in slot order; ``l = l * corr + sum``, ``acc = acc * corr +
   pv`` with ``corr = exp(m - m_new)`` (0 while m is -inf).  A chunk
   with no live slot is skipped: it leaves (m, l, acc) as they were;
2. the segments combine as the reference's sequence-sharded flash
   decode does (``src/repro/models/layers.py`` ``shmap_body``):
   ``m_g = max_i m_i``, ``corr_i = exp(m_i - m_g)`` (0 where m_i is
   -inf), ``l_g`` and ``acc_g`` the sums of ``l_i * corr_i`` and
   ``acc_i * corr_i`` in segment order from 0;
3. ``acc_g / max(l_g, floor)``, RAPID or IEEE.  A fully masked row
   gives 0.

On the card the kernel is bit-equal to the plain version, so a model's
greedy tokens cannot part between the two routes.  The plain version is
a transcription of the kernel's algorithm, not an independent check of
it: the independent reference for K4 is the JAX package's one-max
formulation, ``repro.kernels.flash_attn.ref.decode_attn_ref``, to which
``tests/test_torch_kernels.py`` holds the plain version on the CPU
(rtol 1e-5, atol 1e-6).
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build
from repro_torch.kernels._launch import (count_launch, on_cuda, ptr,
                                         require, stream)
from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR
from repro_torch.kernels.spec import (FLASH_CHUNK, FLASH_MAX_SEGMENT_CHUNKS,
                                      KernelSpec, resolve_spec)

__all__ = ["flash_decode_attn", "flash_decode_plain"]


def _positions(pos, b: int, device) -> torch.Tensor:
    """pos (int | [B] | [B, 1]) -> contiguous int32 [B] on ``device``."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos).to(device=device, dtype=torch.int32)
    return p.reshape(-1).expand(b).contiguous() if p.numel() == 1 \
        else p.reshape(b).contiguous()


def _halving_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) by halving: the kernel's
    warp butterfly, in which every lane ends with the same bits."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def flash_decode_plain(qf, k_cache, v_cache, slot_positions, pos,
                       window: int = 0, scheme: Optional[str] = None, *,
                       floor: float = SOFTMAX_FLOOR,
                       spec: Optional[KernelSpec] = None) -> torch.Tensor:
    """Plain PyTorch version of K4, in the kernel's order (any device).

    The cache is zero padded to whole chunks; the per-row skip of a
    chunk with no live slot is a ``where`` that keeps the old state.
    """
    B, KV, G, hd = qf.shape
    C = k_cache.shape[1]
    ks = resolve_spec("flash_attn", (B * KV, C), spec)
    bc, seg_chunks = ks.bk, ks.bn // ks.bk
    n_chunks = -(-C // bc)
    pad = n_chunks * bc - C
    posq = _positions(pos, B, qf.device)[:, None]
    valid = slot_positions <= posq
    if window:
        valid &= slot_positions > posq - window
    valid = F.pad(valid, (0, pad), value=False)
    live = valid.reshape(B, n_chunks, bc).any(dim=-1)  # [B, n_chunks]
    kt = F.pad(k_cache.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 3, 1)
    vt = F.pad(v_cache.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 1, 3)
    dot = torch.zeros((B, KV, G, C + pad), device=qf.device)
    for d in range(hd):  # [B, KV, G, 1] x [B, KV, 1, Cp]
        dot = dot + qf[..., d, None] * kt[:, :, None, d, :]
    s = torch.where(valid[:, None, None, :], dot, -torch.inf)

    parts = []
    for c_lo in range(0, n_chunks, seg_chunks):
        m = torch.full((B, KV, G), -torch.inf, device=qf.device)
        l = torch.zeros((B, KV, G), device=qf.device)
        acc = torch.zeros((B, KV, G, hd), device=qf.device)
        for ci in range(c_lo, min(c_lo + seg_chunks, n_chunks)):
            c0 = ci * bc
            sc = s[..., c0:c0 + bc]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.where(torch.isfinite(m_new)[..., None],
                            torch.exp(sc - m_new[..., None]), 0.0)
            pv = torch.zeros_like(acc)
            for j in range(bc):
                pv = pv + p[..., j, None] * vt[:, :, None, c0 + j, :]
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            keep = live[:, ci, None, None]
            l = torch.where(keep, l * corr + _halving_sum(p), l)
            acc = torch.where(keep[..., None], acc * corr[..., None] + pv,
                              acc)
            m = torch.where(keep, m_new, m)
        parts.append((m, l, acc))

    m_g = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_g = torch.zeros_like(m_g)
    acc_g = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
        l_g = l_g + l * corr
        acc_g = acc_g + acc * corr[..., None]
    den = torch.where(l_g < floor, floor, l_g)[..., None]
    if scheme:
        return fa.log_div_f32(acc_g, den,
                              fa.div_lut_device(scheme, qf.device))
    return acc_g / den


# the kernel's compiled chunk and segment limit, read back from
# csrc/flash_attn.cu at the first launch and held against kernels/spec.py
# (a CPU-only run never sees the .cu's values)
_geometry_checked = False


def _check_kernel_geometry() -> None:
    global _geometry_checked
    fn = _build.function("flash_attn", "rapid_flash_decode_geometry",
                         [ctypes.POINTER(ctypes.c_int)] * 2)
    bc, max_seg = ctypes.c_int(), ctypes.c_int()
    fn(ctypes.byref(bc), ctypes.byref(max_seg))
    if (bc.value, max_seg.value) != (FLASH_CHUNK, FLASH_MAX_SEGMENT_CHUNKS):
        raise RuntimeError(
            f"flash_attn.cu compiles chunks of {bc.value} slots and segments "
            f"of at most {max_seg.value} chunks; kernels/spec.py plans "
            f"{FLASH_CHUNK} and {FLASH_MAX_SEGMENT_CHUNKS}")
    _geometry_checked = True


# per card: one int32 ticket per row, zero between launches (the last
# block of a row resets its ticket), grown as more rows come.  A tensor
# that more rows outgrew stays alive in _RETIRED_TICKETS: a CUDA graph
# captured while it was current replays on its address, so freeing it
# would let the allocator hand that memory to another tensor
_TICKETS: Dict[torch.device, torch.Tensor] = {}
_RETIRED_TICKETS: List[torch.Tensor] = []


def _tickets(device: torch.device, rows: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < rows:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("flash_decode: the ticket tensor grows during "
                               "a CUDA-graph capture; run the step once "
                               "before capturing it")
        if t is not None:
            _RETIRED_TICKETS.append(t)
        t = torch.zeros(max(rows, 256), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _launch(qf, k_cache, v_cache, slot_positions, posv, lut, window: int,
            floor: float, bk: int, bn: int) -> torch.Tensor:
    """One launch of the kernel at chunk ``bk`` and segment ``bn`` slots,
    which it refuses (the launch raises) unless it compiled them."""
    if not _geometry_checked:
        _check_kernel_geometry()
    b, kv, g, hd = qf.shape
    c = k_cache.shape[1]
    rows = b * kv
    n_seg = max(1, -(-c // bn))
    out = torch.empty_like(qf)
    work = torch.empty(rows * n_seg * g * (hd + 4), dtype=torch.float32,
                       device=qf.device)
    fn = _build.function("flash_attn", "rapid_flash_decode",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(ptr(qf), ptr(k_cache), ptr(v_cache), ptr(slot_positions),
             ptr(posv), ptr(lut), ptr(work), ptr(_tickets(qf.device, rows)),
             ptr(out), rows, c, kv, g, hd, int(window), bk, bn, float(floor),
             int(k_cache.dtype == torch.bfloat16), stream(qf.device))
    _build.check(err, "flash_decode")
    count_launch(flash_decode_attn)
    return out


def flash_decode_attn(qf: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, slot_positions: torch.Tensor,
                      pos, window: int = 0, scheme: Optional[str] = None, *,
                      floor: float = SOFTMAX_FLOOR,
                      spec: Optional[KernelSpec] = None) -> torch.Tensor:
    """Fused single-token attention; same contract as
    :func:`flash_decode_plain`.  On the card: ``hd`` a multiple of 8
    (bf16) or 4 (f32), at most 128; ``G`` at most 16; caches starting on
    a 16 B boundary."""
    if not on_cuda(qf, k_cache, v_cache, slot_positions):
        return flash_decode_plain(qf, k_cache, v_cache, slot_positions, pos,
                                  window, scheme, floor=floor, spec=spec)
    b, kv, g, hd = qf.shape
    c = k_cache.shape[1]
    require(qf, "qf", torch.float32)
    if k_cache.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"caches must be bf16 or f32, got {k_cache.dtype}")
    require(k_cache, "k_cache", k_cache.dtype, (b, c, kv, hd))
    require(v_cache, "v_cache", k_cache.dtype, (b, c, kv, hd))
    require(slot_positions, "slot_positions", torch.int32, (b, c))
    if (hd * k_cache.element_size()) % 16 or hd > 128 or not 1 <= g <= 16:
        raise ValueError(f"flash_decode on the card takes head_dim rows of "
                         f"whole 16 B (at most 128) and 1-16 queries a kv "
                         f"head; got head_dim {hd} in {k_cache.dtype}, G {g}")
    if (k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError("flash_decode: caches must start on a 16 B boundary")
    ks = resolve_spec("flash_attn", (b * kv, c), spec)
    posv = _positions(pos, b, qf.device)
    lut = fa.div_lut_device(scheme, qf.device) if scheme else None
    return _launch(qf, k_cache, v_cache, slot_positions, posv, lut, window,
                   floor, ks.bk, ks.bn)


flash_decode_attn.launches = 0
