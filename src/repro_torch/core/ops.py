"""Public RAPID arithmetic API of the port (forward only).

The port of ``repro.core.ops`` for the dense serve paths and the
applications: :func:`qmatmul` with the epilogue menu,
:func:`qmatmul_batched`, :func:`qdiv`, :func:`qsoftmax_div`,
:func:`qrms_div`, :func:`qdecode_attn` and :func:`exact_einsum`.
``scheme=None`` (or "exact") is the exact path in plain PyTorch; a RAPID
scheme routes through the kernel wrappers, which launch their CUDA
kernel for CUDA tensors and run the plain version for CPU tensors.  The
straight-through gradients of the reference (``custom_vjp``/
``custom_jvp``) come with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import backend as be
from repro_torch.kernels.flash_attn.ops import flash_decode_attn
from repro_torch.kernels.fused_div.ops import (fused_elementwise_div,
                                              fused_rms_div,
                                              fused_softmax_div)
from repro_torch.kernels.log_matmul.ops import log_matmul

__all__ = ["qmatmul", "qmatmul_batched", "exact_einsum", "qdiv",
           "qsoftmax_div", "qrms_div", "qdecode_attn"]


def _exact(scheme: Optional[str]) -> bool:
    return scheme in (None, "exact")


def qmatmul(x: torch.Tensor, w: torch.Tensor, scheme: Optional[str] = None,
            *, bias: Optional[torch.Tensor] = None,
            activation: Optional[str] = None,
            residual: Optional[torch.Tensor] = None,
            epilogue: Optional[be.Epilogue] = None):
    """Contract the last dim of ``x`` with the first dim of ``w``.

    Epilogue menu ``norm(activation(out + bias) + residual)`` in f32,
    then cast to ``x.dtype``; with ``epilogue.keep_prenorm`` the result
    is ``(tail, pre_norm)``.  The exact path is a full-f32 matmul (TF32
    off, see :mod:`repro_torch.device`); a RAPID scheme runs kernel K1.
    """
    ep = be.as_epilogue(epilogue, activation)
    if bias is not None and tuple(bias.shape) != tuple(w.shape[1:]):
        raise ValueError(f"bias shape {tuple(bias.shape)} != w.shape[1:] "
                         f"{tuple(w.shape[1:])}")
    if ep.norm is not None and w.ndim != 2:
        raise ValueError("norm epilogues reduce over the output's last dim "
                         f"and need a 2-D weight; got w.shape={tuple(w.shape)}")
    out_shape = tuple(x.shape[:-1]) + tuple(w.shape[1:])
    if residual is not None and tuple(residual.shape) != out_shape:
        raise ValueError(f"residual shape {tuple(residual.shape)} != output "
                         f"shape {out_shape}")
    k = x.shape[-1]
    if _exact(scheme):
        out = torch.matmul(x.float(), w.float().reshape(k, -1)).reshape(out_shape)
        if bias is not None:
            out = out + bias.float()
        if ep.activation is not None:
            out = be.ACTIVATIONS[ep.activation](out)
        if residual is not None:
            out = out + residual.float()
        pre = out
        if ep.norm == "softmax":
            out = qsoftmax_div(out, ep.div_scheme, floor=ep.floor)
        elif ep.norm == "rms":
            out = qrms_div(out, ep.eps, ep.div_scheme)
        if ep.keep_prenorm:
            return out.to(x.dtype), pre.to(x.dtype)
        return out.to(x.dtype)
    x2 = x.reshape(-1, k).float().contiguous()
    w2 = w.reshape(k, -1).float().contiguous()
    b2 = None if bias is None else bias.float().reshape(-1).contiguous()
    r2 = (None if residual is None
          else residual.float().reshape(x2.shape[0], w2.shape[1]).contiguous())
    out = log_matmul(x2, w2, scheme, bias=b2, residual=r2, epilogue=ep)
    if ep.keep_prenorm:
        tail, pre = out
        return (tail.reshape(out_shape).to(x.dtype),
                pre.reshape(out_shape).to(x.dtype))
    return out.reshape(out_shape).to(x.dtype)


def _per_entry_contiguous(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is when each batch entry is contiguous (a stride-0
    broadcast stays uncopied), else a contiguous copy."""
    return t if t.shape[0] == 0 or t[0].is_contiguous() else t.contiguous()


def qmatmul_batched(x: torch.Tensor, w: torch.Tensor,
                    scheme: Optional[str] = None, *,
                    bias: Optional[torch.Tensor] = None,
                    activation: Optional[str] = None) -> torch.Tensor:
    """Batched matmul with *shared* leading batch dims on ``x`` and ``w``.

    ``x``: ``[*B, M, K]``; ``w``: ``[*B, K, N]`` -> ``[*B, M, N]`` (the
    per-expert MoE contraction, JPEG's blockwise DCT).  ``bias`` may be
    shared (shape ``w.shape[nb:][1:]``) or per batch (``w.shape[:nb] +
    w.shape[nb+1:]``).  A 2-D ``w`` falls back to :func:`qmatmul`.  A
    RAPID scheme runs kernel K1 once over the flattened batch; an operand
    broadcast over the batch with ``expand`` (stride 0) is not copied.
    """
    if w.ndim == 2:
        return qmatmul(x, w, scheme, bias=bias, activation=activation)
    nb = w.ndim - 2
    if tuple(x.shape[:nb]) != tuple(w.shape[:nb]):
        raise ValueError(f"batch dims mismatch: {tuple(x.shape[:nb])} vs "
                         f"{tuple(w.shape[:nb])}")
    shared = tuple(w.shape[nb + 1:])
    per_batch = bias is not None and tuple(bias.shape) != shared
    if per_batch and tuple(bias.shape) != tuple(w.shape[:nb]) + shared:
        raise ValueError(
            f"bias shape {tuple(bias.shape)} must be {shared} (shared) or "
            f"{tuple(w.shape[:nb]) + shared} (per-batch)")
    act = be.normalize_activation(activation)
    out_shape = tuple(x.shape[:-1]) + tuple(w.shape[nb + 1:])
    nbatch = 1
    for d in w.shape[:nb]:
        nbatch *= d
    k = w.shape[nb]
    x3 = x.float().reshape(nbatch, -1, k)
    w3 = w.float().reshape(nbatch, k, -1)
    b2 = None
    if bias is not None:
        b2 = bias.float().reshape(nbatch, -1) if per_batch \
            else bias.float().reshape(-1)
    if _exact(scheme):
        out = torch.matmul(x3, w3)
        if b2 is not None:
            out = out + (b2[:, None, :] if per_batch else b2)
        if act is not None:
            out = be.ACTIVATIONS[act](out)
    else:
        out = log_matmul(_per_entry_contiguous(x3), _per_entry_contiguous(w3),
                         scheme, bias=None if b2 is None else b2.contiguous(),
                         activation=act)
    return out.reshape(out_shape).to(x.dtype)


def exact_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """Declared-exact f32 contraction (the attention score/value
    einsums, which the paper leaves exact)."""
    return torch.einsum(spec, *(o.float() for o in operands))


def qdiv(a: torch.Tensor, b: torch.Tensor,
         scheme: Optional[str]) -> torch.Tensor:
    """Elementwise ``a / b`` (broadcasting ok): IEEE for the exact scheme,
    else the RAPID divider (K5 for one denominator per row, K6 for any
    other broadcast).  Forward only."""
    if _exact(scheme):
        return a / b
    return fused_elementwise_div(a, b, scheme)


def qsoftmax_div(e: torch.Tensor, scheme: Optional[str], *,
                 floor: float = be.SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused softmax combine over the last dim: ``e / max(sum(e), floor)``."""
    if _exact(scheme):
        ef = e.float()
        denom = torch.clamp_min(ef.sum(dim=-1, keepdim=True), floor)
        return (ef / denom).to(e.dtype)
    return fused_softmax_div(e.float().contiguous(), scheme,
                             floor=floor).to(e.dtype)


def qrms_div(x: torch.Tensor, eps: float,
             scheme: Optional[str]) -> torch.Tensor:
    """Fused rms normalize over the last dim: ``x / sqrt(mean(x^2) + eps)``."""
    if _exact(scheme):
        xf = x.float()
        denom = torch.sqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                           + eps)
        return (xf / denom).to(x.dtype)
    return fused_rms_div(x.float().contiguous(), eps, scheme).to(x.dtype)


def qdecode_attn(qf, k_cache, v_cache, slot_positions, pos, window: int,
                 scheme: Optional[str], *,
                 floor: float = be.SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused single-token decode attention (kernel K4); [B, KV, G, hd] f32."""
    return flash_decode_attn(qf.float().contiguous(), k_cache.contiguous(),
                             v_cache.contiguous(),
                             slot_positions.contiguous(), pos, window,
                             scheme, floor=floor)
