"""K1 wrapper: RAPID log-domain matmul with the fused epilogue menu.

``log_matmul`` takes f32 ``x[M, K]`` and ``w[K, N]`` and returns
``norm(act(x @~ w + bias) + residual)`` (or ``(tail, pre_norm)``), where
``@~`` sums RAPID approximate products one k at a time in K order.

* CPU tensors run the plain version, :func:`log_matmul_plain`
  (``core.backend.log_matmul_scan`` + ``apply_epilogue_tile``).
* CUDA tensors launch ``csrc/log_matmul.cu`` (replacing the Pallas
  ``log_matmul_pallas``, ``src/repro/kernels/log_matmul/log_matmul.py``),
  which fuses bias, activation (silu or none, what the ported configs
  use; the menu's other activations raise on the card) and residual; a
  norm stage then runs as a K2/K3 launch on the kernel's pre-norm
  output -- the same ``apply_epilogue_tile`` semantics, not yet fused
  into whole-row tiles.

``log_matmul.launches`` counts kernel launches (not plain calls).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import backend as be
from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build
from repro_torch.kernels._launch import on_cuda, ptr, require, stream
from repro_torch.kernels.fused_div import ref as fdref
from repro_torch.kernels.fused_div.ops import fused_rms_div, fused_softmax_div

__all__ = ["log_matmul", "log_matmul_plain"]


def log_matmul_plain(x, w, scheme, *, bias=None, activation=None,
                     residual=None, epilogue: Optional[be.Epilogue] = None):
    """Plain PyTorch version of K1 (any device)."""
    ep = be.as_epilogue(epilogue, activation)
    out = be.log_matmul_scan(x, w, fa.mul_lut_device(scheme, x.device))
    if ep.norm is None:
        return be.apply_epilogue_tile(out, bias, residual, ep, n=out.shape[-1])
    n = out.shape[-1]
    div_lut = (fa.div_lut_device(ep.div_scheme, x.device)
               if ep.div_scheme is not None else None)
    res = be.apply_epilogue_tile(
        fdref.pad_lanes(out),
        None if bias is None else fdref.pad_lanes(bias),
        None if residual is None else fdref.pad_lanes(residual),
        ep, n=n, div_lut=div_lut)
    if ep.keep_prenorm:
        return res[0][:, :n], res[1][:, :n]
    return res[:, :n]


def _kernel(x, w, scheme, bias, residual, ep: be.Epilogue):
    m, k = x.shape
    n = w.shape[1]
    if ep.activation not in be.ACT_CODES:
        raise NotImplementedError(
            f"the CUDA log_matmul has no {ep.activation!r} epilogue; it "
            f"fuses {tuple(a for a in be.ACT_CODES if a)} (the ported "
            f"configs' activations)")
    require(x, "x", torch.float32)
    require(w, "w", torch.float32, (k, n))
    if bias is not None:
        require(bias, "bias", torch.float32, (n,))
    if residual is not None:
        require(residual, "residual", torch.float32, (m, n))
    lut = fa.mul_lut_device(scheme, x.device)
    pre = torch.empty((m, n), dtype=torch.float32, device=x.device)
    fn = _build.function("log_matmul", "rapid_log_matmul",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                         + [ctypes.c_void_p])
    err = fn(ptr(x), ptr(w), ptr(lut), ptr(bias), ptr(residual), ptr(pre),
             m, n, k, be.ACT_CODES[ep.activation], stream(x.device))
    _build.check(err, "log_matmul")
    log_matmul.launches += 1
    if ep.norm is None:
        return pre
    if ep.norm == "rms":
        tail = fused_rms_div(pre, ep.eps, ep.div_scheme)
    else:
        tail = fused_softmax_div(pre, ep.div_scheme, floor=ep.floor)
    return (tail, pre) if ep.keep_prenorm else tail


def log_matmul(x: torch.Tensor, w: torch.Tensor, scheme: str, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               residual: Optional[torch.Tensor] = None,
               epilogue: Optional[be.Epilogue] = None):
    """f32 ``x[M,K] @ w[K,N]`` with RAPID products and the epilogue menu."""
    ep = be.as_epilogue(epilogue, activation)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"log_matmul needs x[M,K] @ w[K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if on_cuda(x, w, bias, residual):
        return _kernel(x, w, scheme, bias, residual, ep)
    return log_matmul_plain(x, w, scheme, bias=bias, residual=residual,
                            epilogue=ep)


log_matmul.launches = 0
