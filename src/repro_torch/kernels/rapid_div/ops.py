"""K10 wrapper: the paper's integer RAPID 2N-by-N divider.

``rapid_div(a, b, scheme, n_bits)`` is the elementwise approximate
quotient of unsigned ``a < 2**(2*n_bits)`` by ``b < 2**n_bits``
(2 * n_bits <= 31), with broadcasting, returned as ``torch.uint32``, the
reference's dtype and value: ``b == 0`` gives ``2**(2*n_bits) - 1``
(also when ``a == 0``), ``a == 0`` otherwise 0.

* CPU tensors run the plain version, :func:`rapid_div_plain`
  (``core.mitchell.mitchell_div``).
* CUDA tensors launch ``csrc/rapid_int.cu`` (replacing the Pallas
  ``rapid_div_pallas``, ``src/repro/kernels/rapid_div/rapid_div.py``),
  the same 12 B a pair stream as K9 (``kernels/rapid_mul/ops.py``).

``rapid_div.launches`` counts kernel launches (not plain calls).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import mitchell, schemes
from repro_torch.kernels import _rapid_int
from repro_torch.kernels._launch import count_launch, on_cuda

__all__ = ["rapid_div", "rapid_div_plain", "DEFAULT_SCHEME"]

DEFAULT_SCHEME = "rapid9"


def rapid_div_plain(a: torch.Tensor, b: torch.Tensor,
                    scheme: Optional[str] = None, n_bits: int = 8):
    """Plain PyTorch version of K10 (any device)."""
    return mitchell.mitchell_div(
        a, b, schemes.DIV_SCHEMES[scheme or DEFAULT_SCHEME], n_bits)


def rapid_div(a: torch.Tensor, b: torch.Tensor, scheme: Optional[str] = None,
              n_bits: int = 8) -> torch.Tensor:
    """Elementwise RAPID a / b: a < 2**(2*n_bits), b < 2**n_bits
    (uint32)."""
    if not on_cuda(a, b):
        return rapid_div_plain(a, b, scheme, n_bits)
    if not 1 <= n_bits or 2 * n_bits > 31:
        raise ValueError(f"rapid_div: 1 <= n_bits, 2 * n_bits <= 31, got "
                         f"{n_bits}")
    sch = schemes.DIV_SCHEMES[scheme or DEFAULT_SCHEME]
    out = _rapid_int.launch("rapid_div_int", a, b, sch, 2 * n_bits - 1,
                            n_bits)
    if out.numel():
        count_launch(rapid_div)
    return out


rapid_div.launches = 0
