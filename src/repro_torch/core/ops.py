"""Public RAPID arithmetic API of the port.

The port of ``repro.core.ops``: :func:`qmatmul` with the epilogue menu,
:func:`qmatmul_batched`, :func:`qdiv`, :func:`qsoftmax_div`,
:func:`qrms_div`, :func:`qdecode_attn`, :func:`exact_einsum`,
:func:`approx_softmax`, :func:`approx_rms_normalize` and
:func:`approx_mean`.  ``scheme=None`` (or "exact") is the exact path in
plain PyTorch, differentiated by autograd; a RAPID scheme routes through
the kernel wrappers, which launch their CUDA kernel for CUDA tensors and
run the plain version for CPU tensors.

Gradients: the RAPID ops are ``torch.autograd.Function``s with the
reference's straight-through rules (its ``custom_vjp`` / ``custom_jvp``),
written as backward passes in plain PyTorch -- the reference has no
backward kernel either.  :func:`qmatmul`'s backward differentiates the
exact composition :func:`_exact_tail` (activation at the exact
pre-activation, norm as the ideal quotient) with ``torch.autograd.grad``
and casts each gradient back to its input's dtype; its products are
full-f32 ``torch.matmul``s.  :func:`qdecode_attn` is inference-only.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional

import torch

from repro_torch.core import backend as be
from repro_torch.core.float_approx import _unbroadcast
from repro_torch.kernels.flash_attn.ops import flash_decode_attn
from repro_torch.kernels.fused_div.ops import (fused_elementwise_div,
                                              fused_rms_div,
                                              fused_softmax_div)
from repro_torch.kernels.log_matmul.ops import log_matmul

__all__ = ["qmatmul", "qmatmul_batched", "exact_einsum", "qdiv",
           "qsoftmax_div", "qrms_div", "qdecode_attn", "approx_softmax",
           "approx_rms_normalize", "approx_mean", "MatmulTape",
           "matmul_tape"]


def _exact(scheme: Optional[str]) -> bool:
    return scheme in (None, "exact")


def _grads(outs, grad_outs, inputs, needs):
    """Gradients of ``outs`` (with cotangents ``grad_outs``) w.r.t. the
    ``inputs`` whose ``needs`` flag is set, each cast back to its
    input's dtype; None elsewhere."""
    want = [t for t, need in zip(inputs, needs) if need and t is not None]
    got = iter(torch.autograd.grad(outs, want, grad_outs, allow_unused=True)
               if want else ())
    res = []
    for t, need in zip(inputs, needs):
        if not need or t is None:
            res.append(None)
            continue
        g = next(got)
        res.append(torch.zeros_like(t) if g is None else g.to(t.dtype))
    return res


def _leaf(t: Optional[torch.Tensor], need: bool) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().requires_grad_(need)


class MatmulTape:
    """The outputs of the :func:`qmatmul` calls of one checkpointed
    region, in call order: recorded by the region's forward and handed
    back, instead of recomputed, when the backward reruns the region
    (``remat="full"``: matmul outputs saved, the rest recomputed)."""

    def __init__(self):
        self.saved: List = []
        self.pos = 0
        self.replay = False


_TAPES: List[MatmulTape] = []


@contextmanager
def matmul_tape(tape: MatmulTape, replay: bool):
    """Record (``replay=False``) or replay the qmatmul outputs of the
    region run inside the context into / from ``tape``."""
    tape.replay, tape.pos = replay, 0
    _TAPES.append(tape)
    try:
        yield
    finally:
        _TAPES.pop()


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
    if _exact(scheme) and not _TAPES:
        return _qmatmul_exact(x, w, bias, residual, ep)
    return _QMatmul.apply(x, w, bias, residual, scheme, ep)


def _qmatmul_exact(x, w, bias, residual, ep: be.Epilogue):
    """The exact path: a full-f32 matmul and the epilogue in f32 (its
    norm stage through the RAPID divider when ``ep.div_scheme`` says)."""
    k = x.shape[-1]
    out_shape = tuple(x.shape[:-1]) + tuple(w.shape[1:])
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


def _qmatmul_approx(x, w, bias, residual, scheme: str, ep: be.Epilogue):
    """The RAPID forward: one K1 launch (or its plain version)."""
    k = x.shape[-1]
    out_shape = tuple(x.shape[:-1]) + tuple(w.shape[1:])
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


def _exact_tail(x, w, bias, residual, ep: be.Epilogue):
    """The ideal (exact-arithmetic) composition the backward pass
    differentiates: straight-through gradients for the whole menu."""
    k = x.shape[-1]
    x2 = x.reshape(-1, k).float()
    w2 = w.reshape(k, -1).float()
    z = torch.matmul(x2, w2)
    if bias is not None:
        z = z + bias.float().reshape(-1)[None, :]
    if ep.activation is not None:
        z = be.ACTIVATIONS[ep.activation](z)
    if residual is not None:
        z = z + residual.float().reshape(z.shape)
    pre = z
    if ep.norm == "softmax":
        z = z / torch.clamp_min(z.sum(dim=-1, keepdim=True), ep.floor)
    elif ep.norm == "rms":
        z = z / torch.sqrt(torch.mean(z * z, dim=-1, keepdim=True) + ep.eps)
    out_shape = tuple(x.shape[:-1]) + tuple(w.shape[1:])
    if ep.keep_prenorm:
        return z.reshape(out_shape), pre.reshape(out_shape)
    return z.reshape(out_shape)


class _QMatmul(torch.autograd.Function):
    """RAPID qmatmul: the kernel forward, the straight-through backward.
    (An exact qmatmul inside a :func:`matmul_tape` region takes this
    Function too, so that its output can be replayed.)"""

    @staticmethod
    def forward(ctx, x, w, bias, residual, scheme, ep):
        ctx.ep, ctx.exact = ep, _exact(scheme)
        ctx.save_for_backward(x, w, bias, residual)
        tape = _TAPES[-1] if _TAPES else None
        if tape is not None and tape.replay:
            out = tape.saved[tape.pos]
            tape.pos += 1
            return tuple(t.detach() for t in out) if ep.keep_prenorm \
                else out.detach()
        if _exact(scheme):
            out = _qmatmul_exact(x, w, bias, residual, ep)
        else:
            out = _qmatmul_approx(x, w, bias, residual, scheme, ep)
        if tape is not None:
            tape.saved.append(tuple(t.detach() for t in out)
                              if ep.keep_prenorm else out.detach())
        return out

    @staticmethod
    def backward(ctx, *grad_outs):
        x, w, bias, residual = ctx.saved_tensors
        needs = ctx.needs_input_grad[:4]
        # an exact qmatmul differentiates its own forward: the same
        # gradient, in the same f32 order, as without the Function
        tail = _qmatmul_exact if ctx.exact else _exact_tail
        with torch.enable_grad():
            ins = [_leaf(t, n) for t, n in zip((x, w, bias, residual), needs)]
            out = tail(*ins, ctx.ep)
            outs = out if ctx.ep.keep_prenorm else (out,)
            grads = _grads(outs, [g.float() for g in grad_outs], ins, needs)
        return (*grads, None, None)


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
        out = _QMatmulBatched.apply(x3, w3, b2, scheme, act)
    return out.reshape(out_shape).to(x.dtype)


class _QMatmulBatched(torch.autograd.Function):
    """One batched K1 launch forward; per entry, the straight-through
    gradient of the exact ``act(x @ w + bias)`` (the reference vmaps
    qmatmul's custom_vjp).  ``bias`` is shared ``[N]`` or ``[B, N]``."""

    @staticmethod
    def forward(ctx, x3, w3, b2, scheme, act):
        ctx.act = act
        ctx.save_for_backward(x3, w3, b2)
        return log_matmul(_per_entry_contiguous(x3), _per_entry_contiguous(w3),
                          scheme, bias=None if b2 is None else b2.contiguous(),
                          activation=act)

    @staticmethod
    def backward(ctx, g):
        x3, w3, b2 = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [_leaf(t, n) for t, n in zip((x3, w3, b2), needs)]
            z = torch.matmul(ins[0], ins[1])
            if b2 is not None:
                z = z + (ins[2][:, None, :] if b2.ndim == 2 else ins[2])
            if ctx.act is not None:
                z = be.ACTIVATIONS[ctx.act](z)
            grads = _grads((z,), (g.float(),), ins, needs)
        return (*grads, None, None)


def exact_einsum(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """Declared-exact f32 contraction (the attention score/value
    einsums, which the paper leaves exact)."""
    return torch.einsum(spec, *(o.float() for o in operands))


def qdiv(a: torch.Tensor, b: torch.Tensor,
         scheme: Optional[str]) -> torch.Tensor:
    """Elementwise ``a / b`` (broadcasting ok): IEEE for the exact scheme,
    else the RAPID divider (K5 for one denominator per row, K6 for any
    other broadcast), with the reference's straight-through gradient of
    the ideal quotient."""
    if _exact(scheme):
        return a / b
    return _QDiv.apply(a, b, scheme)


class _QDiv(torch.autograd.Function):
    """RAPID ``a / b``; backward: the transpose of the reference's jvp
    ``(da * b - a * db) / (b * b)``."""

    @staticmethod
    def forward(ctx, a, b, scheme):
        ctx.save_for_backward(a, b)
        return fused_elementwise_div(a, b, scheme)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        t = g / (b * b)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = _unbroadcast(t * b, a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = _unbroadcast(-(t * a), b.shape).to(b.dtype)
        return ga, gb, None


def qsoftmax_div(e: torch.Tensor, scheme: Optional[str], *,
                 floor: float = be.SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused softmax combine over the last dim: ``e / max(sum(e), floor)``."""
    if _exact(scheme):
        return _softmax_exact(e.float(), floor).to(e.dtype)
    return _QRowDiv.apply(e, scheme, "softmax", floor)


def qrms_div(x: torch.Tensor, eps: float,
             scheme: Optional[str]) -> torch.Tensor:
    """Fused rms normalize over the last dim: ``x / sqrt(mean(x^2) + eps)``."""
    if _exact(scheme):
        return _rms_exact(x.float(), eps).to(x.dtype)
    return _QRowDiv.apply(x, scheme, "rms", eps)


def _softmax_exact(e, floor: float):
    return e / torch.clamp_min(e.sum(dim=-1, keepdim=True), floor)


def _rms_exact(x, eps: float):
    return x / torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True)
                          + eps)


class _QRowDiv(torch.autograd.Function):
    """The fused RAPID row dividers (K3 softmax combine, K2 rms
    normalize); backward: the gradient of the ideal expression (the
    reference's straight-through ``custom_jvp``)."""

    @staticmethod
    def forward(ctx, x, scheme, kind, const):
        ctx.kind, ctx.const = kind, const
        ctx.save_for_backward(x)
        xf = x.float().contiguous()
        if kind == "softmax":
            out = fused_softmax_div(xf, scheme, floor=const)
        else:
            out = fused_rms_div(xf, const, scheme)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xl = x.detach().float().requires_grad_(True)
            exact = _softmax_exact if ctx.kind == "softmax" else _rms_exact
            (gx,) = torch.autograd.grad(exact(xl, ctx.const), xl, g.float())
        return gx.to(x.dtype), None, None, None


def qdecode_attn(qf, k_cache, v_cache, slot_positions, pos, window: int,
                 scheme: Optional[str], *,
                 floor: float = be.SOFTMAX_FLOOR) -> torch.Tensor:
    """Fused single-token decode attention (kernel K4); [B, KV, G, hd] f32."""
    return flash_decode_attn(qf.float().contiguous(), k_cache.contiguous(),
                             v_cache.contiguous(),
                             slot_positions.contiguous(), pos, window,
                             scheme, floor=floor)


def approx_softmax(x: torch.Tensor, axis: int = -1,
                   div_scheme: Optional[str] = None) -> torch.Tensor:
    """Softmax whose normalisation uses the RAPID divider; the exp stays
    exact and the max is held constant for the gradient (the reference's
    ``stop_gradient``)."""
    x_max = x.amax(dim=axis, keepdim=True).detach()
    e = torch.exp(x - x_max)
    if _exact(div_scheme):
        return e / e.sum(dim=axis, keepdim=True)
    out = qsoftmax_div(torch.movedim(e, axis, -1), div_scheme)
    return torch.movedim(out, -1, axis).to(x.dtype)


def approx_rms_normalize(x: torch.Tensor, eps: float = 1e-6,
                         div_scheme: Optional[str] = None) -> torch.Tensor:
    """``x / sqrt(mean(x^2) + eps)`` with an optional RAPID divider."""
    return qrms_div(x, eps, div_scheme)


def approx_mean(x: torch.Tensor, axis: int = -1,
                div_scheme: Optional[str] = None) -> torch.Tensor:
    """Mean whose final divide uses the RAPID divider; both paths return
    ``x.dtype``."""
    s = x.sum(dim=axis)
    n = torch.tensor(float(x.shape[axis]), dtype=torch.float32,
                     device=x.device)
    if _exact(div_scheme):
        return (s / n).to(x.dtype)
    return qdiv(s.float(), n, div_scheme).to(x.dtype)
