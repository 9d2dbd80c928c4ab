"""RAPID error-reduction schemes and their coefficient LUTs.

The port's copy of ``repro.core.mitchell``'s scheme data: an
:class:`ErrorScheme` maps the (i1, i2) cell -- the 4 MSBs of each
operand's fraction -- to a group id and one signed coefficient per
group; :func:`lut_host` bakes that into the flat (256,) int32 table the
float log-domain ops and the kernels gather from.  The integer
Mitchell/RAPID units come with the integer kernels in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Literal

import numpy as np

__all__ = ["ErrorScheme", "MITCHELL_MUL", "MITCHELL_DIV", "lut_host"]


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
