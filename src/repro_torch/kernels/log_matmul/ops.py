"""K1 wrapper: RAPID log-domain matmul with the fused epilogue menu.

``log_matmul`` takes f32 ``x[M, K]`` and ``w[K, N]`` and returns
``norm(act(x @~ w + bias) + residual)`` (or ``(tail, pre_norm)``), where
``@~`` sums RAPID approximate products one k at a time in K order.
Batched, it takes ``x[B, M, K]`` and ``w[B, K, N]`` (either with a batch
of 1, or 2-D, to broadcast it over the batch; a broadcast operand may
be a stride-0 ``expand``, which is never copied), ``bias`` ``[N]`` or
``[B, N]`` and ``residual`` ``[B, M, N]``, in one launch; the norm
epilogues are 2-D only.

* CPU tensors run the plain version, :func:`log_matmul_plain`
  (``core.backend.log_matmul_scan`` + ``apply_epilogue_tile``).
* CUDA tensors launch ``csrc/log_matmul.cu`` (replacing the Pallas
  ``log_matmul_pallas`` and, at depth >= 2, ``log_matmul_pipelined``,
  ``src/repro/kernels/log_matmul/log_matmul.py``), which fuses bias,
  activation (silu or none, what the ported configs use; the menu's
  other activations raise on the card) and residual; a norm stage then
  runs as a K2/K3 launch at the same depth on the kernel's pre-norm
  output -- the same ``apply_epilogue_tile`` semantics, not yet fused
  into whole-row tiles.

``spec`` (:class:`repro_torch.kernels.spec.KernelSpec`) sets the stage
count, resolved by ``resolve_spec("log_matmul", ...)``: by default 2 K
blocks in flight (K7); the depth moves no bits.  The plan is checked
against the card's shared memory on either route, so a depth the card
would refuse raises on the CPU too.

``log_matmul.launches`` counts kernel launches (not plain calls), and
``log_matmul.launches_by_depth`` splits them by stage count.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import backend as be
from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build, budget
from repro_torch.kernels._launch import count_launch, on_cuda, ptr, stream
from repro_torch.kernels.spec import (KernelSpec, PipelineSpec, matmul_smem,
                                      resolve_spec)
from repro_torch.kernels.fused_div import ref as fdref
from repro_torch.kernels.fused_div.ops import fused_rms_div, fused_softmax_div

__all__ = ["log_matmul", "log_matmul_plain"]


def log_matmul_plain(x, w, scheme, *, bias=None, activation=None,
                     residual=None, epilogue: Optional[be.Epilogue] = None):
    """Plain PyTorch version of K1 (any device)."""
    ep = be.as_epilogue(epilogue, activation)
    out = be.log_matmul_scan(x, w, fa.mul_lut_device(scheme, x.device))
    if out.ndim == 3:  # batched: the fused epilogue, no norm stage
        _batched_epilogue_ok(ep)
        if bias is not None:
            out = out + (bias if bias.ndim == 1 else bias[:, None, :])
        if ep.activation is not None:
            out = be.ACTIVATIONS[ep.activation](out)
        return out if residual is None else out + residual
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


def _batched_epilogue_ok(ep: be.Epilogue) -> None:
    if ep.norm is not None:
        raise ValueError("norm epilogues reduce whole rows and take a 2-D "
                         "x and w; a batched log_matmul fuses bias, "
                         "activation and residual only")


def _batch_stride(t, name: str, inner, batch: int) -> int:
    """Element stride between ``t``'s batch entries (0: broadcast); the
    [rows, cols] matrix of each entry must be contiguous."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape[1:]) != tuple(inner) or t.shape[0] not in (1, batch):
        raise ValueError(f"{name}: expected shape [{batch} or 1, "
                         f"{', '.join(map(str, inner))}], got {tuple(t.shape)}")
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each batch entry must be contiguous")
    return t.stride(0) if t.shape[0] > 1 else 0


def _kernel(x, w, scheme, bias, residual, ep: be.Epilogue, depth: int):
    batched = x.ndim == 3 or w.ndim == 3
    x3 = x if x.ndim == 3 else x[None]
    w3 = w if w.ndim == 3 else w[None]
    batch = max(x3.shape[0], w3.shape[0])
    m, k = x3.shape[1:]
    n = w3.shape[2]
    if ep.activation not in be.ACT_CODES:
        raise NotImplementedError(
            f"the CUDA log_matmul has no {ep.activation!r} epilogue; it "
            f"fuses {tuple(a for a in be.ACT_CODES if a)} (the ported "
            f"configs' activations)")
    if batched:
        _batched_epilogue_ok(ep)
    sx = _batch_stride(x3, "x", (m, k), batch)
    sw = _batch_stride(w3, "w", (k, n), batch)
    sb = sr = 0
    if bias is not None:
        sb = _batch_stride(bias if bias.ndim == 2 else bias[None], "bias",
                           (n,), batch)
    if residual is not None:
        sr = _batch_stride(residual if residual.ndim == 3 else residual[None],
                           "residual", (m, n), batch)
    lut = fa.mul_lut_device(scheme, x.device)
    pre = torch.empty((batch, m, n) if batched else (m, n),
                      dtype=torch.float32, device=x.device)
    if pre.numel() == 0:
        raise ValueError(f"log_matmul: empty output {tuple(pre.shape)}")
    fn = _build.function("log_matmul", "rapid_log_matmul",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_longlong] * 4
                         + [ctypes.c_int, ctypes.c_void_p])
    err = fn(ptr(x3), ptr(w3), ptr(lut), ptr(bias), ptr(residual), ptr(pre),
             m, n, k, be.ACT_CODES[ep.activation], batch, sx, sw, sb, sr,
             depth, stream(x.device))
    _build.check(err, "log_matmul")
    count_launch(log_matmul, depth)
    if ep.norm is None:
        return pre
    tail_spec = KernelSpec(pipeline=PipelineSpec(depth=depth))
    if ep.norm == "rms":
        tail = fused_rms_div(pre, ep.eps, ep.div_scheme, spec=tail_spec)
    else:
        tail = fused_softmax_div(pre, ep.div_scheme, floor=ep.floor,
                                 spec=tail_spec)
    return (tail, pre) if ep.keep_prenorm else tail


def log_matmul(x: torch.Tensor, w: torch.Tensor, scheme: str, *,
               bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               residual: Optional[torch.Tensor] = None,
               epilogue: Optional[be.Epilogue] = None,
               spec: Optional[KernelSpec] = None):
    """f32 ``x[M,K] @ w[K,N]`` (or ``x[B,M,K] @ w[B,K,N]``) with RAPID
    products and the epilogue menu, ``spec``'s depth K blocks in flight."""
    ep = be.as_epilogue(epilogue, activation)
    if x.ndim not in (2, 3) or w.ndim not in (2, 3) \
            or x.shape[-1] != w.shape[-2] or (
                x.ndim == w.ndim == 3
                and x.shape[0] != w.shape[0] and 1 not in (x.shape[0],
                                                           w.shape[0])):
        raise ValueError(f"log_matmul needs x[M,K] @ w[K,N] or "
                         f"x[B,M,K] @ w[B,K,N], got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k, n = x.shape[-2], x.shape[-1], w.shape[-1]
    ks = resolve_spec("log_matmul", (m, n, k), spec)
    budget.check_smem(matmul_smem(ks.bm, ks.bn, ks.bk, ks.depth), "log_matmul")
    if on_cuda(x, w, bias, residual):
        return _kernel(x, w, scheme, bias, residual, ep, ks.depth)
    return log_matmul_plain(x, w, scheme, bias=bias, residual=residual,
                            epilogue=ep)


log_matmul.launches = 0
log_matmul.launches_by_depth = {}
