"""Bit-exact Mitchell logarithmic multiplier / divider with RAPID error
reduction: the port of ``repro.core.mitchell``.

* Scheme data: an :class:`ErrorScheme` maps the (i1, i2) cell -- the 4
  MSBs of each operand's fraction -- to a group id and one signed
  coefficient per group; :func:`lut_host` bakes that into the flat
  (256,) int32 table the float log-domain ops and the kernels gather
  from, and :func:`lut_device` uploads it once per device.
* The numpy oracles :func:`mitchell_mul_np` / :func:`mitchell_div_np`
  (uint64 headroom; copied from the reference).
* The torch integer units :func:`mitchell_mul` (n_bits <= 16) and
  :func:`mitchell_div` (2 * n_bits <= 31): the plain versions of the
  integer kernels K9 / K10 (``kernels/rapid_mul``, ``kernels/rapid_div``).
  The reference computes in int32 with uint32 results; these compute in
  int64, mask to 32 bits where the reference relies on the uint32 wrap,
  and return the reference's uint32 (converted once, at the end).

Algorithm (paper Eq. 1-7).  For N-bit unsigned A with leading one at k:
``A = 2^k (1 + x)``; Mitchell approximates ``log2(A) ~= k + x``.  The
product's log is the sum of the two parts, plus RAPID's coefficient
``c`` (a third addend, from the LUT); the anti-log is a shift.  All
shifts truncate, as the hardware barrel shifter does.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Literal, Tuple

import numpy as np
import torch

from repro_torch.core.bitops import ilog2, ilog2_np

__all__ = ["ErrorScheme", "MITCHELL_MUL", "MITCHELL_DIV", "lut_host",
           "lut_device", "mitchell_mul_np", "mitchell_div_np",
           "mitchell_mul", "mitchell_div", "mul_terms", "div_terms",
           "UINT32_MAX"]

UINT32_MAX = 0xFFFFFFFF


@dataclass(frozen=True)
class ErrorScheme:
    """A RAPID error-reduction scheme (coefficients in units of the
    operand fraction, c in (-0.5, 0.5))."""

    name: str
    kind: Literal["mul", "div"]
    assign: tuple  # (16,16) nested tuple of ints -> group id
    coeffs: tuple  # (G,) floats

    @property
    def n_coeffs(self) -> int:
        return len(self.coeffs)

    def lut(self, frac_bits: int) -> np.ndarray:
        """Flat (256,) int64 LUT of fixed-point coefficients at ``frac_bits``."""
        a = np.asarray(self.assign, dtype=np.int64).reshape(16, 16)
        c = np.asarray(self.coeffs, dtype=np.float64)
        return np.round(c[a] * (1 << frac_bits)).astype(np.int64).reshape(-1)


# Plain Mitchell == the degenerate single-coefficient-zero scheme.
_ZERO_ASSIGN = tuple(tuple(0 for _ in range(16)) for _ in range(16))
MITCHELL_MUL = ErrorScheme("mitchell", "mul", _ZERO_ASSIGN, (0.0,))
MITCHELL_DIV = ErrorScheme("mitchell", "div", _ZERO_ASSIGN, (0.0,))


@lru_cache(maxsize=None)
def lut_host(scheme: ErrorScheme, frac_bits: int) -> np.ndarray:
    """Memoized read-only (256,) int32 host LUT per (scheme, width)."""
    lut = scheme.lut(frac_bits).astype(np.int32)
    lut.setflags(write=False)
    return lut


@lru_cache(maxsize=None)
def _lut_on(scheme: ErrorScheme, frac_bits: int, device: str) -> torch.Tensor:
    return torch.tensor(lut_host(scheme, frac_bits), dtype=torch.int32,
                        device=device)


def lut_device(scheme: ErrorScheme, frac_bits: int, device="cpu"
               ) -> torch.Tensor:
    """(256,) int32 LUT per (scheme, width) on ``device``, uploaded once."""
    return _lut_on(scheme, frac_bits, str(torch.device(device)))


# --------------------------------------------------------------------------
# numpy oracle (uint64 headroom; exact for operands up to 32 bits)
# --------------------------------------------------------------------------

def _frac_align_np(v: np.ndarray, k: np.ndarray, frac_bits: int) -> np.ndarray:
    """Fraction bits of v (below the leading one), left-aligned to frac_bits."""
    frac = v.astype(np.int64) - (np.int64(1) << k)
    return frac << (frac_bits - k)


def mitchell_mul_np(
    a: np.ndarray,
    b: np.ndarray,
    scheme: ErrorScheme = MITCHELL_MUL,
    n_bits: int = 16,
    quantize: bool = True,
) -> np.ndarray:
    """Approximate a*b for unsigned operands (< 2**n_bits). Exact zeros.

    ``quantize=True`` matches the hardware barrel shifter (integer output,
    truncating).  ``quantize=False`` returns the full fixed-point value as
    float64 -- the convention of the paper's Table III accuracy numbers.
    """
    assert scheme.kind == "mul"
    a = np.asarray(a, dtype=np.uint64).astype(np.int64)
    b = np.asarray(b, dtype=np.uint64).astype(np.int64)
    F = n_bits - 1
    lut = scheme.lut(F)

    k1 = ilog2_np(np.maximum(a, 1))
    k2 = ilog2_np(np.maximum(b, 1))
    f1 = _frac_align_np(a, k1, F)
    f2 = _frac_align_np(b, k2, F)
    i1 = (f1 >> (F - 4)) & 0xF
    i2 = (f2 >> (F - 4)) & 0xF
    c = lut[i1 * 16 + i2]

    s = f1 + f2 + c
    ksum = k1 + k2
    one = np.int64(1) << F
    # branch: s < 2^F  ->  2^ksum * (1 + s/2^F) ; else 2^(ksum+1) * (s/2^F)
    carry = s >= one
    mant = np.where(carry, s, s + one).astype(np.uint64)  # in [2^F, 2.25*2^F)
    shift = ksum + carry.astype(np.int64) - F
    # guard negative coefficients driving s below 0 in near-zero-fraction cells
    mant = np.maximum(mant.astype(np.int64), 0).astype(np.uint64)
    if not quantize:
        val = mant.astype(np.float64) * np.exp2(shift.astype(np.float64))
        return np.where((a == 0) | (b == 0), 0.0, val)
    pos = np.maximum(shift, 0).astype(np.uint64)
    neg = np.maximum(-shift, 0).astype(np.uint64)
    res = (mant << pos) >> neg
    return np.where((a == 0) | (b == 0), np.uint64(0), res)


def mitchell_div_np(
    a: np.ndarray,
    b: np.ndarray,
    scheme: ErrorScheme = MITCHELL_DIV,
    n_bits: int = 16,
    quantize: bool = True,
) -> np.ndarray:
    """Approximate a/b (truncated) for unsigned a < 2**(2*n_bits), b < 2**n_bits.

    Follows the paper's 2N-by-N divider; b == 0 returns the saturated max.
    ``quantize=False`` returns the full fixed-point quotient (float64).
    """
    assert scheme.kind == "div"
    a = np.asarray(a, dtype=np.uint64).astype(np.int64)
    b = np.asarray(b, dtype=np.uint64).astype(np.int64)
    F = 2 * n_bits - 1
    lut = scheme.lut(F)

    k1 = ilog2_np(np.maximum(a, 1))
    k2 = ilog2_np(np.maximum(b, 1))
    f1 = _frac_align_np(a, k1, F)
    f2 = _frac_align_np(b, k2, F)
    i1 = (f1 >> (F - 4)) & 0xF
    i2 = (f2 >> (F - 4)) & 0xF
    c = lut[i1 * 16 + i2]

    s = f1 - f2 + c
    kdiff = k1 - k2
    one = np.int64(1) << F
    borrow = s < 0
    # branch: s >= 0 -> 2^kdiff * (1 + s/2^F) ; else 2^(kdiff-1) * (2 + s/2^F)
    mant = np.where(borrow, s + 2 * one, s + one)
    mant = np.maximum(mant, 0)
    shift = kdiff - borrow.astype(np.int64) - F
    if not quantize:
        val = mant.astype(np.float64) * np.exp2(shift.astype(np.float64))
        val = np.where(a == 0, 0.0, val)
        return np.where(b == 0, np.inf, val)
    pos = np.maximum(shift, 0).astype(np.uint64)
    neg = np.minimum(np.maximum(-shift, 0), 63).astype(np.uint64)
    res = (mant.astype(np.uint64) << pos) >> neg
    res = np.where(a == 0, np.uint64(0), res)
    sat = np.uint64((1 << (2 * n_bits)) - 1)
    return np.where(b == 0, sat, res)


# --------------------------------------------------------------------------
# torch integer units (the plain versions of K9 / K10)
# --------------------------------------------------------------------------

def _align_and_index(v: torch.Tensor, frac_bits: int):
    """Leading one k, fraction aligned to ``frac_bits`` and its 4 MSBs.

    ``v == 0`` takes k = 0 and a fraction of -2^frac_bits, as in the
    reference (the unit's result is masked afterwards).  Below 4
    fraction bits the reference's right shift by a negative amount is
    XLA's sign fill, i.e. a shift by 31.
    """
    k = ilog2(torch.clamp_min(v, 1))
    f = (v - (1 << k)) << (frac_bits - k)
    top = (f >> (frac_bits - 4)) if frac_bits >= 4 else (f >> 63)
    return k, f, top & 0xF


def _operands(a, b):
    if a.dtype.is_floating_point or b.dtype.is_floating_point \
            or a.dtype == torch.bool or b.dtype == torch.bool:
        raise TypeError(f"integer operands expected, got {a.dtype}, {b.dtype}")
    return torch.broadcast_tensors(a.long(), b.long())


def mul_terms(a: torch.Tensor, b: torch.Tensor, scheme: ErrorScheme,
              n_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The multiplier's mantissa and anti-log shift (int64) before the
    barrel shift, for int64 operands < 2**n_bits."""
    F = n_bits - 1
    lut = lut_device(scheme, F, a.device).long()
    k1, f1, i1 = _align_and_index(a, F)
    k2, f2, i2 = _align_and_index(b, F)
    s = f1 + f2 + lut[i1 * 16 + i2]
    one = 1 << F
    carry = (s >= one).long()
    mant = torch.clamp_min(torch.where(carry == 1, s, s + one), 0)
    return mant, k1 + k2 + carry - F


def div_terms(a: torch.Tensor, b: torch.Tensor, scheme: ErrorScheme,
              n_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The divider's mantissa and anti-log shift (int64), for int64
    a < 2**(2 * n_bits), b < 2**n_bits."""
    F = 2 * n_bits - 1
    lut = lut_device(scheme, F, a.device).long()
    k1, f1, i1 = _align_and_index(a, F)
    k2, f2, i2 = _align_and_index(b, F)
    s = f1 - f2 + lut[i1 * 16 + i2]
    one = 1 << F
    borrow = (s < 0).long()
    mant = torch.clamp_min(torch.where(borrow == 1, s + 2 * one, s + one), 0)
    return mant, k1 - k2 - borrow - F


def _as_uint32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) as ``torch.uint32``: through int32 (the
    top half wrapped to negative first), whose casts every device has."""
    return (v - ((v >> 31) << 32)).to(torch.int32).view(torch.uint32)


def mitchell_mul(a: torch.Tensor, b: torch.Tensor,
                 scheme: ErrorScheme = MITCHELL_MUL,
                 n_bits: int = 16) -> torch.Tensor:
    """Mitchell/RAPID multiply of unsigned ints < 2**n_bits (n_bits <= 16).

    Returns the reference's uint32 result: saturated at 2**32 - 1 where
    the approximate product of near-maximal operands overshoots it, 0
    where an operand is 0.
    """
    if scheme.kind != "mul" or not 1 <= n_bits <= 16:
        raise ValueError(f"mitchell_mul takes a mul scheme and 1 <= n_bits "
                         f"<= 16, got {scheme.kind!r}, {n_bits}")
    a, b = _operands(a, b)
    mant, shift = mul_terms(a, b, scheme, n_bits)
    pos = torch.clamp_min(shift, 0)
    neg = torch.clamp_min(-shift, 0)
    res = ((mant << pos) & UINT32_MAX) >> neg  # the uint32 shift wraps
    hi = ilog2(torch.clamp_min(mant, 1)) + shift
    res = torch.where(hi >= 32, UINT32_MAX, res)
    return _as_uint32(torch.where((a == 0) | (b == 0), 0, res))


def mitchell_div(a: torch.Tensor, b: torch.Tensor,
                 scheme: ErrorScheme = MITCHELL_DIV,
                 n_bits: int = 8) -> torch.Tensor:
    """Mitchell/RAPID 2N-by-N divide: a < 2**(2*n_bits), b < 2**n_bits
    (2 * n_bits <= 31).  ``b == 0`` gives 2**(2*n_bits) - 1 (also when
    ``a == 0``), ``a == 0`` otherwise 0.  Returns uint32."""
    if scheme.kind != "div" or not 1 <= n_bits or 2 * n_bits > 31:
        raise ValueError(f"mitchell_div takes a div scheme and 1 <= n_bits, "
                         f"2 * n_bits <= 31, got {scheme.kind!r}, {n_bits}")
    a, b = _operands(a, b)
    mant, shift = div_terms(a, b, scheme, n_bits)
    pos = torch.clamp_min(shift, 0)
    neg = torch.clamp(-shift, 0, 31)
    res = ((mant << pos) & UINT32_MAX) >> neg
    res = torch.where(a == 0, 0, res)
    return _as_uint32(torch.where(b == 0, (1 << (2 * n_bits)) - 1, res))
