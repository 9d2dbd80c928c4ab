"""Shared launch of the integer RAPID units K9 / K10 (``csrc/rapid_int.cu``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import ptr, stream

__all__ = ["launch"]


def launch(fn_name: str, a: torch.Tensor, b: torch.Tensor,
           lut: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Broadcast ``a`` and ``b``, hand them to the kernel as contiguous
    int32 and return its int64 results in the broadcast shape.  Integer
    operands only; their values must lie inside the unit's contract."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"{fn_name}: {name} must be an integer tensor, "
                            f"got {t.dtype}")
    a, b = torch.broadcast_tensors(a, b)
    a32 = a.to(torch.int32).contiguous()
    b32 = b.to(torch.int32).contiguous()
    out = torch.empty(a.shape, dtype=torch.int64, device=a.device)
    if out.numel() == 0:
        return out
    fn = _build.function("rapid_int", fn_name,
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                  ctypes.c_int,
                                                  ctypes.c_void_p])
    err = fn(ptr(a32), ptr(b32), ptr(lut), ptr(out), out.numel(), n_bits,
             stream(a.device))
    _build.check(err, fn_name)
    return out
