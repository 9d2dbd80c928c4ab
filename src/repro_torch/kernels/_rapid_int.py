"""Shared launch of the integer RAPID units K9 / K10 (``csrc/rapid_int.cu``).

The kernel streams 12 B a pair: two int32 operands in, one uint32 result
out, as the reference's kernels.  Its geometry comes from
``kernels/spec.py`` (:func:`~repro_torch.kernels.spec.int_split`,
:func:`~repro_torch.kernels.spec.int_geometry`): 16 B vectors, a head and
a tail of single elements where the pointers are not 16 B aligned, and
one wave of blocks at most.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from repro_torch.core import mitchell
from repro_torch.kernels import _build
from repro_torch.kernels._launch import ptr, result_like, sm_count, stream
from repro_torch.kernels.spec import int_geometry, int_split

__all__ = ["ARGTYPES", "launch", "sm_count"]

#: the C entry points' arguments: a, b, lut, out, total, head, n_bits,
#: blocks_per_sm, threads, grid, wide, stream
ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
            + [ctypes.c_int] * 5 + [ctypes.c_void_p])


@lru_cache(maxsize=None)
def _lut_in_contract(scheme: mitchell.ErrorScheme, frac_bits: int) -> bool:
    """The kernel's proof that a mantissa is never negative (so the
    reference's clamp at 0 never binds) needs every LUT coefficient above
    -2^frac_bits; the registered schemes' lie within half of that."""
    return int(mitchell.lut_host(scheme, frac_bits).min()) > -(1 << frac_bits)


def launch(fn_name: str, a: torch.Tensor, b: torch.Tensor,
           scheme: mitchell.ErrorScheme, frac_bits: int,
           n_bits: int) -> torch.Tensor:
    """Broadcast ``a`` and ``b``, hand them to the kernel as contiguous
    int32 and return its uint32 results in the broadcast shape.  Integer
    operands only; their values must lie inside the unit's contract."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype.is_floating_point or t.dtype.is_complex \
                or t.dtype == torch.bool:
            raise TypeError(f"{fn_name}: {name} must be an integer tensor, "
                            f"got {t.dtype}")
    if not _lut_in_contract(scheme, frac_bits):
        raise ValueError(f"{fn_name}: scheme {scheme.name!r} has a "
                         f"coefficient <= -1, outside the kernel's proof")
    a, b = torch.broadcast_tensors(a, b)
    a32 = a.to(torch.int32).contiguous()
    b32 = b.to(torch.int32).contiguous()
    if a32.data_ptr() % 16 == b32.data_ptr() % 16:
        out = result_like(a32, torch.uint32)
    else:
        out = torch.empty(a.shape, dtype=torch.uint32, device=a.device)
    total = out.numel()
    if total == 0:
        return out
    head, _, _ = int_split(total, a32.data_ptr(), b32.data_ptr(),
                           out.data_ptr())
    geom = int_geometry(total, sm_count(a.device.index or 0), head)
    fn = _build.function("rapid_int", fn_name, ARGTYPES)
    err = fn(ptr(a32), ptr(b32),
             ptr(mitchell.lut_device(scheme, frac_bits, a.device)), ptr(out),
             total, head, n_bits, geom.blocks_per_sm, geom.threads, geom.grid,
             int(geom.wide), stream(a.device))
    _build.check(err, fn_name)
    return out
