"""K9 wrapper: the paper's integer RAPID multiplier.

``rapid_mul(a, b, scheme, n_bits)`` is the elementwise approximate
product of unsigned ints below ``2**n_bits`` (n_bits <= 16), with
broadcasting, returned as ``torch.uint32``, the reference's dtype and
value (saturated at 2**32 - 1; 0 where an operand is 0).  A caller that
needs arithmetic on it casts first (``.long()``, ``.double()``): torch
has no uint32 add or max.

* CPU tensors run the plain version, :func:`rapid_mul_plain`
  (``core.mitchell.mitchell_mul``).
* CUDA tensors launch ``csrc/rapid_int.cu`` (replacing the Pallas
  ``rapid_mul_pallas``, ``src/repro/kernels/rapid_mul/rapid_mul.py``):
  an elementwise stream of 12 B a pair (two int32 operands in, one
  uint32 result out) in 16 B vectors, the next vector of each operand
  loaded before a thread computes this one, 256 threads a block, one
  wave of blocks at most (``kernels/spec.py::int_geometry``); the
  unit's arithmetic is the reference's sequence with the rewrites
  proved in the kernel's header.

``rapid_mul.launches`` counts kernel launches (not plain calls).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mitchell, schemes
from repro_torch.kernels import _rapid_int
from repro_torch.kernels._launch import count_launch, on_cuda

__all__ = ["rapid_mul", "rapid_mul_plain", "DEFAULT_SCHEME"]

DEFAULT_SCHEME = "rapid10"


def rapid_mul_plain(a: torch.Tensor, b: torch.Tensor,
                    scheme: Optional[str] = None, n_bits: int = 16):
    """Plain PyTorch version of K9 (any device)."""
    return mitchell.mitchell_mul(
        a, b, schemes.MUL_SCHEMES[scheme or DEFAULT_SCHEME], n_bits)


def rapid_mul(a: torch.Tensor, b: torch.Tensor, scheme: Optional[str] = None,
              n_bits: int = 16) -> torch.Tensor:
    """Elementwise RAPID approximate product of unsigned ints < 2**n_bits
    (uint32)."""
    if not on_cuda(a, b):
        return rapid_mul_plain(a, b, scheme, n_bits)
    if not 1 <= n_bits <= 16:
        raise ValueError(f"rapid_mul: 1 <= n_bits <= 16, got {n_bits}")
    sch = schemes.MUL_SCHEMES[scheme or DEFAULT_SCHEME]
    out = _rapid_int.launch("rapid_mul_int", a, b, sch, n_bits - 1, n_bits)
    if out.numel():
        count_launch(rapid_mul)
    return out


rapid_mul.launches = 0
