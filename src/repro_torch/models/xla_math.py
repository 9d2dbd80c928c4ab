"""The reference's elementwise math as XLA on the CPU computes it.

Shared by the recurrent mixers (``models/mamba.py``, ``models/xlstm.py``),
whose state updates and gates the reference writes in plain ``jnp``:

  * :func:`fma`: XLA contracts ``a * b + c`` (and ``a * b + c * d``, as
    ``fma(a, b, c * d)``: the left product fused, the right one rounded)
    into one fused multiply-add;
  * :func:`silu`: ``jax.nn.silu``, in bf16 expanded op by op;
  * :func:`softplus` / :func:`log_sigmoid`: ``jax.nn.softplus`` as
    ``logaddexp(x, 0)`` and ``jax.nn.log_sigmoid`` as ``-softplus(-x)``,
    in the reference's steps (not ``F.softplus`` / ``F.logsigmoid``).

The same torch ops run on the CPU and on the card, so each gives the same
bits on both.
"""
from __future__ import annotations

import torch

from repro_torch.core.float_approx import _unbroadcast

__all__ = ["fma", "silu", "softplus", "log_sigmoid"]


def _fma_bits(a, b, c):
    """The forward of :func:`fma`: ``a * b + c`` rounded once."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)  # the exact sum is s + err (TwoSum)
    inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0) & s.isfinite()
    toward = torch.where(err > 0, torch.inf, -torch.inf).double()
    return torch.where(inexact, torch.nextafter(s, toward), s).float()


class _Fma(torch.autograd.Function):
    """:func:`fma` with the gradient of the reference's f32 ``a * b + c``:
    ``(g * b, g * a, g)``, each an f32 product summed down to its input's
    shape.  Only ``a`` and ``b`` are saved (often views the caller keeps
    anyway); the forward's f64 temporaries are freed at once."""

    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.c_shape = c.shape
        return _fma_bits(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        need_a, need_b, need_c = ctx.needs_input_grad
        return (_unbroadcast(g * b, a.shape) if need_a else None,
                _unbroadcast(g * a, b.shape) if need_b else None,
                _unbroadcast(g, ctx.c_shape) if need_c else None)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` on f32 tensors (broadcasting ok), rounded once (a
    fused multiply-add).

    The product of two f32 values is exact in f64; the f64 sum is rounded
    to odd (an inexact sum with an even last bit moves one step toward the
    exact value), and the cast to f32 then gives the correctly rounded
    result.  The same f64 ops on the CPU and on the card: the same bits.
    The backward is the reference's: XLA differentiates ``a * b + c``
    before it contracts it, so the gradient is ``(g * b, g * a, g)`` in
    f32 (:class:`_Fma`).
    """
    return _Fma.apply(a, b, c)


def silu(x):
    """The reference's ``jax.nn.silu`` as XLA computes it: ``x *
    logistic(x)``.  In bf16 XLA expands the logistic to ``1 / (1 +
    exp(-x))`` with every op rounded to bf16, and so does this (bit-equal
    on the CPU); in f32 ``torch.sigmoid`` is within an ulp of XLA's."""
    if x.dtype == torch.float32:
        return x * torch.sigmoid(x)
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """The reference's ``jax.nn.softplus``: ``logaddexp(x, 0)`` in its own
    steps, ``max(x, 0) + log1p(exp(-|x|))``, NaN kept."""
    out = torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def log_sigmoid(x):
    """The reference's ``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return -softplus(-x)
