"""Truncation-based approximate baselines (DRUM / AAXD style).

The port of ``repro.core.truncated``: the dynamically-truncated DRUM
multiplier [47] and AAXD divider [37] the paper compares against, as
their float-mantissa analogue -- keep k-1 mantissa MSBs, set the next
bit to 1 (DRUM's midpoint unbiasing), operate exactly, restore the
sign.  Works on the float32 bit view, bit-equal to the reference.

The reference runs under XLA, which flushes subnormal inputs and results
to zero (on the CPU and the TPU alike): a subnormal operand compares
equal to 0 and a subnormal product or quotient becomes 0.  torch flushes
nothing, so these functions flush explicitly, on every device.
"""
from __future__ import annotations

import torch

__all__ = ["drum_mul_f32", "aaxd_div_f32"]

_ABS = 0x7FFFFFFF
_SIGN = -0x80000000
_FRAC = 23
_MIN_NORMAL = 0x00800000


def _bits(x: torch.Tensor) -> torch.Tensor:
    """float32 bits with subnormals flushed to a signed zero."""
    b = x.contiguous().view(torch.int32)
    return torch.where((b & _ABS) < _MIN_NORMAL, b & _SIGN, b)


def _truncate_mantissa(bits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep k-1 mantissa MSBs, set the k-th to 1 (midpoint unbiasing)."""
    drop = _FRAC - (k - 1)
    mask = -1 << drop
    mid = 1 << (drop - 1)
    return (bits & mask) | mid


def _with_sign(x: torch.Tensor, sign: torch.Tensor) -> torch.Tensor:
    """|x| flushed to 0 below the smallest normal, with ``sign``."""
    m = x.view(torch.int32) & _ABS
    return (torch.where(m < _MIN_NORMAL, 0, m) | sign).view(torch.float32)


def drum_mul_f32(a: torch.Tensor, b: torch.Tensor, k: int = 6) -> torch.Tensor:
    """DRUM-k style approximate product on f32 (broadcasting ok)."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    ba, bb = _bits(a), _bits(b)
    sign = (ba ^ bb) & _SIGN
    fa = _truncate_mantissa(ba & _ABS, k).view(torch.float32)
    fb = _truncate_mantissa(bb & _ABS, k).view(torch.float32)
    out = _with_sign(fa * fb, sign)
    return torch.where(((ba & _ABS) == 0) | ((bb & _ABS) == 0), 0.0, out)


def aaxd_div_f32(a: torch.Tensor, b: torch.Tensor, k: int = 8) -> torch.Tensor:
    """AAXD-style approximate quotient on f32 (truncate both operands)."""
    a, b = torch.broadcast_tensors(a.float(), b.float())
    ba, bb = _bits(a), _bits(b)
    sign = (ba ^ bb) & _SIGN
    fa = _truncate_mantissa(ba & _ABS, k).view(torch.float32)
    fb = _truncate_mantissa(bb & _ABS, max(2, k // 2)).view(torch.float32)
    out = _with_sign(fa / fb, sign)
    out = torch.where((ba & _ABS) == 0, 0.0, out)
    return torch.where((bb & _ABS) == 0,
                       torch.inf * torch.sign(ba.view(torch.float32)), out)
