"""K2 / K3 wrappers: fused rms normalize and softmax combine.

``fused_rms_div(x, eps, scheme)`` is ``x / sqrt(mean(x^2, -1) + eps)`` and
``fused_softmax_div(e, scheme, floor)`` is ``e / max(sum(e, -1), floor)``,
each with the denominator in the canonical form of :mod:`.ref` and the
divide through the RAPID divider (``scheme=None``: IEEE divide).

* CPU tensors run the plain versions (:func:`rms_div_plain`,
  :func:`softmax_div_plain`).
* CUDA tensors launch ``csrc/fused_div.cu`` (replacing the Pallas
  ``rms_div_pallas`` / ``softmax_div_pallas`` of
  ``src/repro/kernels/fused_div/fused_div.py``), one CTA per row.

``return_denom=True`` also returns the per-row denominators ``[..., 1]``
(the kernel writes its own), so a check can hold the quotients against
the plain divide fed the same denominator.  ``fused_rms_div.launches``
and ``fused_softmax_div.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build
from repro_torch.kernels._launch import on_cuda, ptr, require, stream
from repro_torch.kernels.fused_div import ref

__all__ = ["fused_rms_div", "fused_softmax_div", "rms_div_plain",
           "softmax_div_plain"]


def _divide(x, denom, scheme):
    if scheme is None:
        return x / denom
    return fa.log_div_f32(x, denom, fa.div_lut_device(scheme, x.device))


def rms_div_plain(x, eps: float, scheme: Optional[str], *,
                  return_denom: bool = False):
    """Plain PyTorch version of K2 (any device)."""
    denom = ref.rms_denom(ref.pad_lanes(x), x.shape[-1], eps)
    out = _divide(x, denom, scheme)
    return (out, denom) if return_denom else out


def softmax_div_plain(e, scheme: Optional[str], *,
                      floor: float = ref.SOFTMAX_FLOOR,
                      return_denom: bool = False):
    """Plain PyTorch version of K3 (any device)."""
    denom = ref.softmax_denom(ref.pad_lanes(e), floor)
    out = _divide(e, denom, scheme)
    return (out, denom) if return_denom else out


def _launch_rows(x, scheme, name, *consts):
    require(x, "x", torch.float32)
    n = x.shape[-1]
    if x.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)}")
    out = torch.empty_like(x)
    denom = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                        device=x.device)
    lut = fa.div_lut_device(scheme, x.device) if scheme is not None else None
    fn = _build.function("fused_div", f"rapid_{name}",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                         + [ctypes.c_float] * len(consts) + [ctypes.c_void_p])
    err = fn(ptr(x), ptr(out), ptr(denom), ptr(lut), x.numel() // n, n,
             *consts, stream(x.device))
    _build.check(err, name)
    return out, denom


def fused_rms_div(x: torch.Tensor, eps: float, scheme: Optional[str], *,
                  return_denom: bool = False):
    """Row-wise rms normalize over the last dim, f32 in/out."""
    if not on_cuda(x):
        return rms_div_plain(x, eps, scheme, return_denom=return_denom)
    out, denom = _launch_rows(x, scheme, "rms_div",
                              *ref.rms_consts(x.shape[-1], eps))
    fused_rms_div.launches += 1
    return (out, denom) if return_denom else out


def fused_softmax_div(e: torch.Tensor, scheme: Optional[str], *,
                      floor: float = ref.SOFTMAX_FLOOR,
                      return_denom: bool = False):
    """Row-wise softmax combine over the last dim, f32 in/out."""
    if not on_cuda(e):
        return softmax_div_plain(e, scheme, floor=floor,
                                 return_denom=return_denom)
    out, denom = _launch_rows(e, scheme, "softmax_div", float(floor))
    fused_softmax_div.launches += 1
    return (out, denom) if return_denom else out


fused_rms_div.launches = 0
fused_softmax_div.launches = 0
