"""K9 wrapper: the paper's integer RAPID multiplier.

``rapid_mul(a, b, scheme, n_bits)`` is the elementwise approximate
product of unsigned ints below ``2**n_bits`` (n_bits <= 16), with
broadcasting, returned as int64 holding the reference's uint32 value
(saturated at 2**32 - 1; 0 where an operand is 0).

* CPU tensors run the plain version, :func:`rapid_mul_plain`
  (``core.mitchell.mitchell_mul``).
* CUDA tensors launch ``csrc/rapid_int.cu`` (replacing the Pallas
  ``rapid_mul_pallas``, ``src/repro/kernels/rapid_mul/rapid_mul.py``).

``rapid_mul.launches`` counts kernel launches (not plain calls).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mitchell, schemes
from repro_torch.kernels import _rapid_int
from repro_torch.kernels._launch import on_cuda

__all__ = ["rapid_mul", "rapid_mul_plain", "DEFAULT_SCHEME"]

DEFAULT_SCHEME = "rapid10"


def rapid_mul_plain(a: torch.Tensor, b: torch.Tensor,
                    scheme: Optional[str] = None, n_bits: int = 16):
    """Plain PyTorch version of K9 (any device)."""
    return mitchell.mitchell_mul(
        a, b, schemes.MUL_SCHEMES[scheme or DEFAULT_SCHEME], n_bits)


def rapid_mul(a: torch.Tensor, b: torch.Tensor, scheme: Optional[str] = None,
              n_bits: int = 16) -> torch.Tensor:
    """Elementwise RAPID approximate product of unsigned ints < 2**n_bits."""
    if not on_cuda(a, b):
        return rapid_mul_plain(a, b, scheme, n_bits)
    if not 1 <= n_bits <= 16:
        raise ValueError(f"rapid_mul: 1 <= n_bits <= 16, got {n_bits}")
    sch = schemes.MUL_SCHEMES[scheme or DEFAULT_SCHEME]
    out = _rapid_int.launch("rapid_mul_int", a, b,
                            mitchell.lut_device(sch, n_bits - 1, a.device),
                            n_bits)
    if out.numel():
        rapid_mul.launches += 1
    return out


rapid_mul.launches = 0
