"""K4 wrapper: fused flash-decode attention with the RAPID combine divide.

``flash_decode_attn`` has the contract of :func:`.ref.decode_attn_ref`:
qf ``[B, KV, G, hd]`` pre-scaled f32 queries against caches
``[B, C, KV, hd]`` (bf16 or f32), slot positions ``[B, C]`` int32 and
the current position ``pos`` (int, ``[B]`` or ``[B, 1]``); returns
``[B, KV, G, hd]`` f32.

* CPU tensors run the plain version :func:`flash_decode_plain`.
* CUDA tensors launch ``csrc/flash_attn.cu`` (replacing the Pallas
  ``flash_decode_pallas``, ``src/repro/kernels/flash_attn/flash_attn.py``),
  one CTA per (batch, kv-head) row, reading the caches in their own
  layout and type.  ``flash_decode_attn.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build
from repro_torch.kernels._launch import on_cuda, ptr, require, stream
from repro_torch.kernels.flash_attn.ref import (SOFTMAX_FLOOR,
                                                decode_attn_ref)

__all__ = ["flash_decode_attn", "flash_decode_plain"]

flash_decode_plain = decode_attn_ref


def _positions(pos, b: int, device) -> torch.Tensor:
    """pos (int | [B] | [B, 1]) -> contiguous int32 [B] on ``device``."""
    if isinstance(pos, int):
        return torch.full((b,), pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(pos).to(device=device, dtype=torch.int32)
    return p.reshape(-1).expand(b).contiguous() if p.numel() == 1 \
        else p.reshape(b).contiguous()


def flash_decode_attn(qf: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, slot_positions: torch.Tensor,
                      pos, window: int = 0, scheme: Optional[str] = None, *,
                      floor: float = SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused single-token attention; same contract as ``decode_attn_ref``."""
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
