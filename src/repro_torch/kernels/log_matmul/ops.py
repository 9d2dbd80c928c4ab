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
count, resolved by ``resolve_spec("log_matmul", ...)``: by default K
blocks in flight per regime (K7); the depth moves no bits.  The regime
and its geometry come from ``kernels/spec.py`` alone and are passed to
the kernel, which refuses a pair it did not compile; the plan is
checked against the card's shared memory on either route, so a depth
the card would refuse raises on the CPU too.

The kernel sums each K block through a lean product path where a proof
over the block's in-bounds operands says it is exact, and through the
full product elsewhere.  :func:`lean_block_ok` and :func:`lean_product`
are the plain models of that proof and of the sign-folded product, and
:func:`log_matmul_blocks` the plain model of the whole blockwise choice;
the CPU tests hold them bit-equal to ``float_approx.log_mul_f32`` and
to :func:`log_matmul_plain`.  :func:`edge_pair`, :func:`mixed_blocks`
and :func:`edge_blocks` make the operands that drive both paths (the
CPU tests, the card tests and ``chip_smoke.py`` share them).

``log_matmul.launches`` counts kernel launches (not plain calls), and
``log_matmul.launches_by_depth`` splits them by stage count.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import backend as be
from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build, budget
from repro_torch.kernels._launch import count_launch, on_cuda, ptr, stream
from repro_torch.kernels.spec import (MATMUL_REGIMES, KernelSpec,
                                      PipelineSpec, matmul_regime, matmul_smem,
                                      resolve_spec)
from repro_torch.kernels.fused_div import ref as fdref
from repro_torch.kernels.fused_div.ops import fused_rms_div, fused_softmax_div

__all__ = ["log_matmul", "log_matmul_plain", "lut_bounds", "lean_block_ok",
           "lean_product", "log_matmul_blocks", "edge_pair", "mixed_blocks",
           "edge_blocks"]

_F32_BIAS = 127 << 23
_F32_ABS = 0x7FFFFFFF
_MIN_NORMAL = 0x00800000
_INF_BITS = 0x7F800000


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


@lru_cache(maxsize=None)
def lut_bounds(scheme) -> Tuple[int, int]:
    """(min, max) of ``scheme``'s multiply LUT: the coefficient range
    the lean proof adds to the operand bounds."""
    lut = fa.mul_lut(scheme)
    return int(lut.min()), int(lut.max())


def _mag(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32).to(torch.int64) & _F32_ABS


def lean_block_ok(x_tile: torch.Tensor, w_tile: torch.Tensor,
                  scheme) -> bool:
    """The kernel's proof for one K block, over its in-bounds operands
    ``x_tile[rows, k]`` and ``w_tile[k, cols]`` (f32): True iff no operand
    is inf, NaN, zero or subnormal and, in int64, min a + min m +
    lut_min >= MIN_NORMAL and max a + max m + lut_max < INF_BITS (a =
    |x|bits - BIAS, m = |w|bits).  Then every product of the block is
    exactly :func:`lean_product`."""
    mx, mw = _mag(x_tile), _mag(w_tile)
    if mx.numel() == 0 or mw.numel() == 0:
        raise ValueError("lean_block_ok: an empty tile proves nothing")
    for mag in (mx, mw):
        if bool(((mag < _MIN_NORMAL) | (mag >= _INF_BITS)).any()):
            return False
    lo, hi = lut_bounds(scheme)
    a = mx - _F32_BIAS
    return (int(a.min()) + int(mw.min()) + lo >= _MIN_NORMAL
            and int(a.max()) + int(mw.max()) + hi < _INF_BITS)


def lean_product(x: torch.Tensor, w: torch.Tensor, scheme) -> torch.Tensor:
    """The lean path's product of f32 ``x`` and ``w`` (broadcasting):
    a' + m' + lut[idx] mod 2^32, with a' = bits(x) - BIAS and m' =
    bits(w) -- the sign-folded operands -- and idx the 4 MSBs of each
    mantissa.  Equal to ``log_mul_f32(x, w)`` wherever
    :func:`lean_block_ok` holds; no clamp, flag or sign select."""
    x, w = torch.broadcast_tensors(x, w)
    bx = x.contiguous().view(torch.int32).to(torch.int64)
    bw = w.contiguous().view(torch.int32).to(torch.int64)
    lut = fa.mul_lut_device(scheme, x.device).to(torch.int64)
    idx = ((bx >> 19) & 0xF) * 16 + ((bw >> 19) & 0xF)
    s = ((bx - _F32_BIAS) + bw + lut[idx]) & 0xFFFFFFFF
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32).view(
        torch.float32)


def log_matmul_blocks(x: torch.Tensor, w: torch.Tensor, scheme, bm: int,
                      bn: int, bk: int):
    """Plain model of the kernel's blockwise path choice for 2-D ``x[M,
    K] @ w[K, N]`` on ``bm`` x ``bn`` output tiles and ``bk``-deep K
    blocks: each block's products come from :func:`lean_product` where
    :func:`lean_block_ok` holds on its in-bounds operands, else from
    ``log_mul_f32``; each output is summed one k at a time in K order.
    Returns the output, bit-equal to :func:`log_matmul_plain`, and the
    verdict per block, ``{(row0, col0, k0): lean}``."""
    m, k = x.shape
    n = w.shape[1]
    lut = fa.mul_lut_device(scheme, x.device)
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    lean = {}
    for r0 in range(0, m, bm):
        for c0 in range(0, n, bn):
            acc = torch.zeros((min(bm, m - r0), min(bn, n - c0)),
                              dtype=torch.float32, device=x.device)
            for k0 in range(0, k, bk):
                xt = x[r0:r0 + bm, k0:k0 + bk]
                wt = w[k0:k0 + bk, c0:c0 + bn]
                ok = lean[(r0, c0, k0)] = lean_block_ok(xt, wt, scheme)
                p = (lean_product(xt[:, :, None], wt[None], scheme) if ok
                     else fa.log_mul_f32(xt[:, :, None], wt[None], lut))
                for kk in range(p.shape[1]):
                    acc = acc + p[:, kk]
            out[r0:r0 + bm, c0:c0 + bn] = acc
    return out, lean


def _f32(u32: int) -> np.float32:
    return np.array([u32], np.uint32).view(np.float32)[0]


def edge_pair(scheme, prod_bits: int, bound: Optional[str] = None,
              w_exps=(125, 129, 127)):
    """A positive normal f32 pair (x, w) whose true RAPID sum a + m +
    lut[idx] (a = |x|bits - BIAS, m = |w|bits, idx their mantissa cells)
    is ``prod_bits``, w's biased exponent taken from ``w_exps``.  With
    ``bound`` "min" ("max"), idx is a cell holding the LUT's least
    (greatest) coefficient, so a + m + lut_min (lut_max) is
    ``prod_bits`` too: the pair sits on the lean proof's own bound."""
    lut = fa.mul_lut(scheme)
    cells = range(256) if bound is None else np.flatnonzero(
        lut == lut_bounds(scheme)[("min", "max").index(bound)])
    for e in w_exps:
        for cell in cells:
            xi, wi = divmod(int(cell), 16)
            for low in (0, (1 << 19) - 1):  # x's cell is one of two
                mbits = (e << 23) | (wi << 19) | low
                mag = prod_bits - int(lut[cell]) - mbits + _F32_BIAS
                if _MIN_NORMAL <= mag < _INF_BITS and (mag >> 19) & 0xF == xi:
                    return _f32(mag), _f32(mbits)
    raise ValueError(f"no normal pair sums to {prod_bits:#x}")


def mixed_blocks(rng, m: int, k: int, n: int, bk: int):
    """x[m, k], w[k, n] (numpy f32, model scale) whose K blocks of ``bk``
    take both of K1's paths: block 1 holds a zero, block 2 a subnormal,
    block 3 an inf (x) and a -0 (w), block 4 a normal pair whose sum
    clamps to inf, block 5 products at and just past the MIN_NORMAL /
    INF_BITS clamps; the other blocks only ordinary operands."""
    if k < 5 * bk + 5:
        raise ValueError(f"mixed_blocks: K = {k} holds fewer than 6 blocks "
                         f"of {bk}")
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    x[m // 2, 1 * bk + 3] = 0.0
    w[2 * bk + 1, n // 3] = 1e-40
    x[0, 3 * bk + 2] = np.inf
    w[3 * bk + 5, n - 1] = -0.0
    x[min(1, m - 1), 4 * bk], w[4 * bk, 0] = 2.0 ** 126, 4.0
    for e, prod in enumerate((_MIN_NORMAL, _MIN_NORMAL - 1, _INF_BITS - 1,
                              _INF_BITS + 1)):
        kk = 5 * bk + 1 + e
        x[(1 + e) % m, kk], w[kk, e % n] = edge_pair("rapid10", prod)
    return x, w


def edge_blocks(rng, m: int, k: int, n: int, bk: int, scheme="rapid10"):
    """x[m, k], w[k, n] (numpy f32, model scale) whose first three K
    blocks of ``bk`` sit on the lean proof's bounds in every output tile
    holding a row r % 8 == 0 and columns c % 8 == 0 and c % 8 == 4:
    block 0 on both (min a + min m + lut_min == MIN_NORMAL and max a +
    max m + lut_max == INF_BITS - 1: proved), block 1 one step below the
    lower bound and block 2 one step above the upper (both refused).
    Real products meet each bound: x[:, k0] * w[k0, :] (either sign) at
    the lower, x[r, k0 + 1] * w[k0 + 1, c] at the upper (block 2's at c
    % 8 == 4), each in a LUT cell holding the extreme coefficient.  The
    other blocks are ordinary."""
    if bk < 2 or k < 3 * bk + 1:
        raise ValueError(f"edge_blocks: K = {k} holds fewer than 4 blocks "
                         f"of {bk}")
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * k ** -0.5).astype(np.float32)
    lo_x, lo_w = edge_pair(scheme, _MIN_NORMAL, "min", (87,))
    hi_x, hi_w = edge_pair(scheme, _INF_BITS - 1, "max", (137,))
    for b, (lo, hi, c0) in enumerate((((lo_x, lo_w), (hi_x, hi_w), 0),
                                      (edge_pair(scheme, _MIN_NORMAL - 1,
                                                 "min", (87,)), None, 0),
                                      ((lo_x, lo_w), edge_pair(
                                          scheme, _INF_BITS, "max", (137,)),
                                       4))):
        k0 = b * bk
        x[:, k0], w[k0, :] = lo
        x[1::2, k0] *= -1
        if hi is not None:
            x[::8, k0 + 1], w[k0 + 1, c0::8] = hi
    return x, w


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


def _kernel(x, w, scheme, bias, residual, ep: be.Epilogue, ks: KernelSpec,
            regime: str):
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
    depth = ks.depth
    lut_min, lut_max = lut_bounds(scheme)
    fn = _build.function("log_matmul", "rapid_log_matmul",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 7
                         + [ctypes.c_void_p])
    err = fn(ptr(x3), ptr(w3), ptr(lut), ptr(bias), ptr(residual), ptr(pre),
             m, n, k, be.ACT_CODES[ep.activation], batch, sx, sw, sb, sr,
             depth, MATMUL_REGIMES.index(regime), ks.bm, ks.bn, ks.bk,
             lut_min, lut_max, stream(x.device))
    _build.check(err, f"log_matmul ({regime} regime, (bm, bn, bk) = "
                 f"{(ks.bm, ks.bn, ks.bk)}, depth {depth})")
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
    regime = matmul_regime(m, n)
    budget.check_smem(matmul_smem(regime, ks.bm, ks.bn, ks.bk, ks.depth),
                      "log_matmul")
    if on_cuda(x, w, bias, residual):
        return _kernel(x, w, scheme, bias, residual, ep, ks, regime)
    return log_matmul_plain(x, w, scheme, bias=bias, residual=residual,
                            epilogue=ep)


log_matmul.launches = 0
log_matmul.launches_by_depth = {}
