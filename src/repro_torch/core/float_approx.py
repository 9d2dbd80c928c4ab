"""RAPID logarithmic arithmetic on IEEE-754 float32, in PyTorch.

The port of ``repro.core.float_approx``.  Bit-casting a positive float
to an integer yields Mitchell's log approximation (scaled by 2^23,
biased by 127 << 23), so the Mitchell+RAPID units become

    bits(a) + bits(b) - BIAS + coeff[idx(a), idx(b)]      (multiply)
    bits(a) - bits(b) + BIAS + coeff[idx(a), idx(b)]      (divide)

with ``idx`` the 4 MSBs of the mantissa.  These functions are the plain
versions every kernel of the port is held against, and they match the
reference bit for bit: the overflow test relies on int32 two's-complement
wrap, which torch's int32 add gives on both CPU and CUDA (each op is its
own kernel, so no compiler sees the add and the sign test together).

:func:`approx_mul` / :func:`approx_div` are the public elementwise ops
by scheme name, forward only; their straight-through gradients (as
``torch.autograd.Function``) come with the training slice.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Union

import numpy as np
import torch

from repro_torch.core import mitchell, schemes
from repro_torch.core.mitchell import ErrorScheme

__all__ = [
    "mul_lut",
    "div_lut",
    "mul_lut_device",
    "div_lut_device",
    "log_mul_f32",
    "log_div_f32",
    "log_recip_f32",
    "approx_mul",
    "approx_div",
]

_F32_FRAC = 23
_F32_BIAS = 127 << 23
_F32_ABS = 0x7FFFFFFF
_F32_SIGN = -0x80000000
_MIN_NORMAL = 0x00800000
_INF_BITS = 0x7F800000

SchemeArg = Union[ErrorScheme, str]


def _as_scheme(kind: str, scheme: SchemeArg) -> ErrorScheme:
    if isinstance(scheme, str):
        table = schemes.MUL_SCHEMES if kind == "mul" else schemes.DIV_SCHEMES
        return table[scheme]
    if scheme.kind != kind:
        raise ValueError(f"scheme {scheme.name!r} is a {scheme.kind} scheme, "
                         f"not {kind}")
    return scheme


def mul_lut(scheme: SchemeArg) -> np.ndarray:
    """(256,) int32 coefficient LUT for f32 multiply (host, memoized)."""
    return mitchell.lut_host(_as_scheme("mul", scheme), _F32_FRAC)


def div_lut(scheme: SchemeArg) -> np.ndarray:
    """(256,) int32 coefficient LUT for f32 divide (host, memoized)."""
    return mitchell.lut_host(_as_scheme("div", scheme), _F32_FRAC)


@lru_cache(maxsize=None)
def _lut_on(kind: str, scheme: ErrorScheme, device: str) -> torch.Tensor:
    host = mul_lut(scheme) if kind == "mul" else div_lut(scheme)
    return torch.tensor(host, dtype=torch.int32, device=device)


def mul_lut_device(scheme: SchemeArg, device="cpu") -> torch.Tensor:
    """(256,) int32 multiply LUT on ``device``, uploaded once."""
    return _lut_on("mul", _as_scheme("mul", scheme), str(torch.device(device)))


def div_lut_device(scheme: SchemeArg, device="cpu") -> torch.Tensor:
    """(256,) int32 divide LUT on ``device``, uploaded once."""
    return _lut_on("div", _as_scheme("div", scheme), str(torch.device(device)))


def _bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        raise TypeError(f"RAPID float ops take float32, got {x.dtype}")
    return x.contiguous().view(torch.int32)


def _coeff(m1: torch.Tensor, m2: torch.Tensor, lut: torch.Tensor):
    i1 = (m1 >> (_F32_FRAC - 4)) & 0xF
    i2 = (m2 >> (_F32_FRAC - 4)) & 0xF
    return lut[(i1 * 16 + i2).long()]


def _finish(s: torch.Tensor, sign: torch.Tensor, dead: torch.Tensor):
    """Clamp under/overflow, apply sign, zero the dead lanes, bitcast."""
    s = torch.where(s >= _INF_BITS, _INF_BITS, s)
    s = torch.where(s < _MIN_NORMAL, 0, s)  # flush subnormal
    s = torch.where(dead, 0, s)
    return (s | sign).view(torch.float32)


def log_mul_f32(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor):
    """Elementwise RAPID approximate a*b for float32 (broadcasting ok).

    Flush-to-zero for subnormals, 0*x == 0 (including 0*inf), inf
    propagates, exponent overflow saturates to inf.
    """
    a, b = torch.broadcast_tensors(a, b)
    ba, bb = _bits(a), _bits(b)
    sign = (ba ^ bb) & _F32_SIGN
    m1, m2 = ba & _F32_ABS, bb & _F32_ABS
    half = m1 - _F32_BIAS
    s = half + m2 + _coeff(m1, m2, lut)
    # int32 wrap: (m1 - BIAS) + m2 overflowed iff both halves were
    # non-negative yet the sum is negative -> real exponent past inf
    wrapped = (half >= 0) & (s < 0)
    s = torch.where(wrapped | (m1 >= _INF_BITS) | (m2 >= _INF_BITS),
                    _INF_BITS, s)
    dead = (m1 < _MIN_NORMAL) | (m2 < _MIN_NORMAL)  # 0 * x == 0
    return _finish(s, sign, dead)


def log_div_f32(a: torch.Tensor, b: torch.Tensor, lut: torch.Tensor):
    """Elementwise RAPID approximate a/b for float32. b==0 -> +-inf."""
    a, b = torch.broadcast_tensors(a, b)
    ba, bb = _bits(a), _bits(b)
    sign = (ba ^ bb) & _F32_SIGN
    m1, m2 = ba & _F32_ABS, bb & _F32_ABS
    diff = m1 - m2
    s = diff + _F32_BIAS + _coeff(m1, m2, lut)
    wrapped = (diff >= 0) & (s < 0)  # huge / tiny past inf
    s = torch.where(wrapped | (m1 >= _INF_BITS), _INF_BITS, s)
    s = torch.where(m2 < _MIN_NORMAL, _INF_BITS, s)  # x / 0
    dead = m1 < _MIN_NORMAL  # 0 / x == 0
    return _finish(s, sign, dead)


def log_recip_f32(b: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """Approximate 1/b (division with dividend fraction fixed at zero)."""
    return log_div_f32(torch.ones_like(b), b, lut)


def approx_mul(a: torch.Tensor, b: torch.Tensor,
               scheme: SchemeArg = "rapid10") -> torch.Tensor:
    """RAPID ``a * b`` by scheme name, computed in f32, in ``a``'s dtype
    (broadcasting ok).  Forward only."""
    lut = mul_lut_device(scheme, a.device)
    return log_mul_f32(a.float(), b.float(), lut).to(a.dtype)


def approx_div(a: torch.Tensor, b: torch.Tensor,
               scheme: SchemeArg = "rapid9") -> torch.Tensor:
    """RAPID ``a / b`` by scheme name, computed in f32, in ``a``'s dtype
    (broadcasting ok).  Forward only."""
    lut = div_lut_device(scheme, a.device)
    return log_div_f32(a.float(), b.float(), lut).to(a.dtype)
