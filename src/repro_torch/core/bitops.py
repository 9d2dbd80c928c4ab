"""Integer bit-manipulation primitives of the RAPID integer units.

The port of ``repro.core.bitops``: :func:`smear32`, :func:`popcount32`
and :func:`ilog2` on integer tensors (32-bit lanes), and the numpy
:func:`ilog2_np` with uint64 headroom for the oracles.  On the card the
integer kernels find the leading one with ``31 - __clz(v)``
(``csrc/rapid_int.cu``), which equals :func:`ilog2` for every v >= 1.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["ilog2", "ilog2_np", "popcount32", "smear32"]

_MASK32 = 0xFFFFFFFF


def smear32(v: torch.Tensor) -> torch.Tensor:
    """Smear the leading one of each 32-bit lane down to bit 0."""
    v = v | (v >> 1)
    v = v | (v >> 2)
    v = v | (v >> 4)
    v = v | (v >> 8)
    v = v | (v >> 16)
    return v


def popcount32(v: torch.Tensor) -> torch.Tensor:
    """Population count of the low 32 bits of each lane (SWAR).

    Runs in int64 and masks, where the reference relies on the int32
    multiply wrapping; returns int64.
    """
    v = v.long() & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def ilog2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for positive int32 lanes (-1 for v == 0); int64.

    The software leading-one detector: smear + popcount, as the
    reference computes it on the TPU's vector unit.
    """
    return popcount32(smear32(v.to(torch.int32))) - 1


def ilog2_np(v: np.ndarray) -> np.ndarray:
    """Numpy mirror of :func:`ilog2` with uint64 support (for oracles)."""
    v = np.asarray(v)
    x = v.astype(np.uint64).copy()
    for shift in (1, 2, 4, 8, 16, 32):
        x |= x >> np.uint64(shift)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333)
    )
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    out = ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int64)
    return out - 1
