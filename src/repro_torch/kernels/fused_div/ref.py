"""Canonical semantics of the fused divider ops (the plain versions).

The port of ``repro.kernels.fused_div.ref``.  The reference defines a
row's denominator as the reduction over the row zero-padded to a
multiple of ``LANE``, and leaves the partial-sum grouping to XLA.  The
port fixes the grouping itself, so that its CUDA kernels can match the
plain version bit for bit (:func:`lane_sum`): lane ``t`` sums elements
``t, t + LANE, t + 2*LANE, ...`` in that order, starting from +0 as the
reference's sum does (so a row of -0 sums to +0), then the ``LANE``
partial sums are folded by halving (``s[t] += s[t + h]`` for
``h = LANE/2, ..., 1``).  XLA groups the same row otherwise, so against
the reference the denominators agree to a few ulp and the quotients
bit for bit once both are fed the same denominator.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import float_approx as fa

__all__ = [
    "LANE",
    "SOFTMAX_FLOOR",
    "padded_width",
    "pad_lanes",
    "lane_sum",
    "softmax_denom",
    "rms_denom",
    "rms_consts",
    "softmax_div_ref",
    "rms_div_ref",
]

# Row width granule: the reference pads rows to the TPU's 128 lanes; the
# port keeps the width and makes it the fixed grouping of the row sum
# (one CUDA thread per lane).
LANE = 128

# Denominator floor for the softmax combine: keeps fully-masked rows
# (sum of exp-weights == 0) from dividing by zero.
SOFTMAX_FLOOR = 1e-20


def padded_width(n: int) -> int:
    """Last-dim width after padding to a multiple of LANE."""
    return -(-n // LANE) * LANE


def pad_lanes(x: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last dim to a multiple of LANE (identity if aligned)."""
    pad = padded_width(x.shape[-1]) - x.shape[-1]
    return F.pad(x, (0, pad)) if pad else x


def lane_sum(x_padded: torch.Tensor) -> torch.Tensor:
    """Row sum of a lane-padded row in the port's fixed grouping; keeps
    the last dim (size 1)."""
    n_pad = x_padded.shape[-1]
    if n_pad % LANE:
        raise ValueError(f"row width {n_pad} is not lane-padded")
    # each lane's chain starts at +0, as the reference's sum does: +0 + v
    # is v for every v but -0, so only a lane of all -0 changes (to +0)
    acc = x_padded[..., :LANE] + 0.0
    for j in range(1, n_pad // LANE):
        acc = acc + x_padded[..., j * LANE:(j + 1) * LANE]
    h = LANE // 2
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    return acc


def softmax_denom(e_padded: torch.Tensor, floor: float) -> torch.Tensor:
    """Row-sum of exp-weights with a floor; ``e_padded`` is lane-padded."""
    s = lane_sum(e_padded)
    return torch.maximum(s, torch.tensor(np.float32(floor), device=s.device))


def rms_consts(n: int, eps: float):
    """The f32 constants of ``sqrt((ss + n*eps) * (1/n))``, folded once
    in Python as the reference folds them."""
    return float(np.float32(n * eps)), float(np.float32(1.0 / n))


def rms_denom(x_padded: torch.Tensor, n: int, eps: float) -> torch.Tensor:
    """sqrt(mean(x^2) + eps) over the *real* width n, in the reference's
    canonical form ``sqrt((ss + n*eps) * (1/n))``."""
    c_add, c_mul = rms_consts(n, eps)
    ss = lane_sum(x_padded * x_padded)
    return torch.sqrt((ss + c_add) * c_mul)


def softmax_div_ref(e: torch.Tensor, lut: torch.Tensor,
                    floor: float = SOFTMAX_FLOOR) -> torch.Tensor:
    """exp-weights / row-sum through the RAPID divider.  f32 in/out."""
    return fa.log_div_f32(e, softmax_denom(pad_lanes(e), floor), lut)


def rms_div_ref(x: torch.Tensor, lut: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x^2, last axis) + eps) via the RAPID divider. f32."""
    return fa.log_div_f32(x, rms_denom(pad_lanes(x), x.shape[-1], eps), lut)
