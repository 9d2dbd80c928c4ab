"""Core NN layers of the dense serve and train paths: norms (rms and
LN), RoPE, GQA/SWA attention, the SwiGLU and the ungated (gelu) MLP --
RAPID-aware.

The port of ``repro.models.layers`` (unsharded).  Every weight matmul
goes through :func:`repro_torch.core.ops.qmatmul` (kernel K1 under a
RAPID scheme); every softmax / normalisation divide can go through the
logarithmic divider (kernels K2, K3, K4, and K5 for the online-softmax
combine of chunked-prefill and blockwise attention).  Activations are
cast back to the config's dtype after each op in the same places as the
reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.core.backend import SOFTMAX_FLOOR, Epilogue
from repro_torch.core.ops import (exact_einsum, qdecode_attn, qdiv, qmatmul,
                                  qrms_div, qsoftmax_div)
from repro_torch.models.params import P

__all__ = [
    "dense",
    "rms_norm",
    "layer_norm",
    "apply_norm",
    "rope",
    "attention_params",
    "attention",
    "decode_attention",
    "chunk_cache_attention",
    "mlp_params",
    "mlp",
    "norm_params",
]


def dense(x, w, acfg: ApproxConfig, site: str, bias=None, activation=None,
          residual=None, epilogue=None):
    """x @ w with the RAPID multiplier at this site when the config says."""
    return qmatmul(x, w, acfg.mul(site), bias=bias, activation=activation,
                   residual=residual, epilogue=epilogue)


def norm_params(cfg: ModelConfig) -> dict:
    p = {"scale": P((cfg.d_model,), "ones")}
    if cfg.norm == "ln":
        p["bias"] = P((cfg.d_model,), "zeros")
    return p


def rms_norm(x, params, eps: float, acfg: ApproxConfig):
    xf = x.float()
    y = qrms_div(xf, eps, acfg.div("norm"))
    return (y * params["scale"].float()).to(x.dtype)


def layer_norm(x, params, eps: float, acfg: ApproxConfig):
    # layer norm == rms normalize of the centred activations, through the
    # same divide (K2, K8 at depth >= 2) as rms_norm
    xf = x.float()
    y = qrms_div(xf - xf.mean(dim=-1, keepdim=True), eps, acfg.div("norm"))
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def apply_norm(x, params, cfg: ModelConfig):
    if cfg.norm == "ln":
        return layer_norm(x, params, cfg.norm_eps, cfg.approx)
    return rms_norm(x, params, cfg.norm_eps, cfg.approx)


def _attn_scale(hd: int) -> float:
    # the reference's 1/sqrt(hd): an f32 sqrt, then an f32 divide
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def rope(x, positions, theta: float):
    """Rotary embedding, llama-style half rotation. x: [..., S, H, hd]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_params(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": P((D, H * hd)),
        "wk": P((D, KV * hd)),
        "wv": P((D, KV * hd)),
        "wo": P((H * hd, D), scale=1.0),
    }


_MAXI32 = 2**31 - 1


def _online_softmax_combine(acc, l, m, acfg: ApproxConfig):
    """``acc / max(l, floor)[..., None]``: the RAPID divide with one
    denominator per row (kernel K5), or IEEE when the softmax site is
    exact.  The floor is the fused softmax combine's, so both softmax
    formulations give 0 on fully-masked rows."""
    sch = acfg.div("softmax")
    l = torch.clamp_min(l, SOFTMAX_FLOOR)  # NaN stays NaN, as jnp.maximum
    if sch:
        return qdiv(acc, l[..., None], sch)
    return acc / l[..., None]


def _attn_blockwise(q, k, v, q_pos, kv_pos, window: int, causal: bool,
                    acfg: ApproxConfig, chunk: int = 512):
    """Memory-efficient attention with online softmax.

    q: [B, S, KV, G, hd]; k, v: [B, T, KV, hd].  Masking from absolute
    positions (causal + sliding window); a Python loop over KV chunks of
    ``chunk`` slots (the reference's ``lax.scan``), so peak memory is
    O(S * chunk) per head group.  Padding slots carry position INT32_MAX
    and are masked out.
    """
    B, S, KVh, G, hd = q.shape
    T = k.shape[1]
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=_MAXI32)
    qf = q.float() * _attn_scale(hd)

    m = torch.full((B, S, KVh, G), -torch.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, S, KVh, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, S, KVh, G, hd), dtype=torch.float32,
                      device=q.device)
    for c0 in range(0, T + pad, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        pc = kv_pos[c0:c0 + chunk]
        s = exact_einsum("bskgh,bckh->bskgc", qf, kc)
        mask = (pc < _MAXI32)[None, :].expand(S, -1)
        if causal:
            mask = mask & (pc[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (pc[None, :] > (q_pos[:, None] - window))
        s = torch.where(mask[None, :, None, None, :], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(torch.isfinite(m_new)[..., None], p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = exact_einsum("bskgc,bckh->bskgh", p, vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = _online_softmax_combine(acc, l, m, acfg)
    return out.to(q.dtype)


def _attn_qchunk_core(qc, k, v, qp, kv_pos, window: int, causal: bool,
                      acfg: ApproxConfig):
    """Scores + softmax + PV for one (pre-scaled) q chunk against full K/V."""
    s = exact_einsum("bshd,bthd->bhst", qc, k)
    mask = torch.ones((qc.shape[1], k.shape[1]), dtype=torch.bool,
                      device=qc.device)
    if causal:
        mask &= kv_pos[None, :] <= qp[:, None]
    if window:
        mask &= kv_pos[None, :] > (qp[:, None] - window)
    s = torch.where(mask[None, None], s, -torch.inf)
    sch = acfg.div("softmax")
    if sch:
        # the max is a constant to the gradient (the reference's
        # stop_gradient)
        m = s.amax(dim=-1, keepdim=True).detach()
        # fused softmax combine: row-sum + floor + RAPID divide (K3)
        p = qsoftmax_div(torch.exp(s - m), sch)
    else:
        p = torch.softmax(s, dim=-1)
    return exact_einsum("bhst,bthd->bshd", p, v)


_Q_CHUNK = 1024


def _attn_plain(q, k, v, q_pos, kv_pos, window: int, causal: bool,
                acfg: ApproxConfig):
    """Masked attention over q chunks of ``_Q_CHUNK`` rows.

    q: [B,S,H,hd]; k,v: [B,T,H,hd] (kv heads already repeated to H).
    """
    qs = q.float() * _attn_scale(q.shape[-1])
    outs = [_attn_qchunk_core(qs[:, c0:c0 + _Q_CHUNK], k, v,
                              q_pos[c0:c0 + _Q_CHUNK], kv_pos, window, causal,
                              acfg)
            for c0 in range(0, q.shape[1], _Q_CHUNK)]
    return torch.cat(outs, dim=1).to(q.dtype)


# sequences longer than this take the O(S * chunk) blockwise path, in
# KV chunks of _BLOCKWISE_CHUNK slots (the reference's attention chunk)
_PLAIN_ATTN_MAX_T = 8192
_BLOCKWISE_CHUNK = 1024


def attention(x, params, cfg: ModelConfig, positions, residual=None,
              tail_norm: bool = False):
    """Full-sequence (prefill) causal GQA self-attention.

    Returns (out [B,S,D], k [B,T,KV,hd], v).  ``residual`` rides the
    output projection's epilogue; ``tail_norm=True`` also fuses the next
    rms norm's divide into it, and ``out`` becomes the pair
    ``(y, y_rms_div)``: the residual stream and its scale-free norm.
    """
    acfg = cfg.approx
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(x, params["wq"], acfg, "attn_proj").reshape(B, S, H, hd)
    k = dense(x, params["wk"], acfg, "attn_proj").reshape(B, S, KV, hd)
    v = dense(x, params["wv"], acfg, "attn_proj").reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    G = H // KV
    if S <= _PLAIN_ATTN_MAX_T:
        out = _attn_plain(q, k.repeat_interleave(G, dim=2),
                          v.repeat_interleave(G, dim=2), positions,
                          positions, cfg.sliding_window, True, acfg)
    else:  # GQA heads not repeated
        out = _attn_blockwise(q.reshape(B, S, KV, G, hd), k, v, positions,
                              positions, cfg.sliding_window, True, acfg,
                              _BLOCKWISE_CHUNK)
    out = out.reshape(B, S, H * hd)
    if tail_norm:
        ep = Epilogue(norm="rms", div_scheme=acfg.div("norm"),
                      eps=cfg.norm_eps, keep_prenorm=True)
        ydiv, y = dense(out, params["wo"], acfg, "attn_proj",
                        residual=residual, epilogue=ep)
        return (y, ydiv), k, v
    out = dense(out, params["wo"], acfg, "attn_proj", residual=residual)
    return out, k, v


def decode_attention(q, k_cache, v_cache, slot_positions, pos, window: int,
                     acfg: ApproxConfig):
    """Single-token attention against a (possibly ring) KV cache.

    q: [B, H, hd]; caches: [B, C, KV, hd]; slot_positions: [B, C]
    absolute positions per slot (INT32_MAX = empty); ``pos`` the current
    position, an int (lockstep batch) or an int32 ``[B]`` vector.  One
    fused flash-decode launch (kernel K4) on CUDA.
    """
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    qf = (q.float() * _attn_scale(hd)).reshape(B, KV, H // KV, hd)
    out = qdecode_attn(qf, k_cache, v_cache, slot_positions, pos, window,
                       acfg.div("softmax"))
    return out.reshape(B, H * hd).to(q.dtype)


def chunk_cache_attention(q, k_cache, v_cache, q_pos, kv_pos, window: int,
                          acfg: ApproxConfig):
    """Multi-token chunk attention against a per-slot cache view.

    The chunked-prefill analogue of :func:`decode_attention`: ``S`` new
    query tokens of each slot attend to that slot's cached prefix, which
    already holds the chunk itself (callers write k/v before reading).
    q: [B, S, H, hd]; caches: [B, C, KV, hd]; q_pos: [B, S] absolute
    query positions; kv_pos: [B, C] absolute positions per cache slot
    (INT32_MAX = empty, which causality masks out).  The combine divide
    is kernel K5 under a RAPID softmax scheme.
    """
    B, S, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qf = (q.float() * _attn_scale(hd)).reshape(B, S, KV, G, hd)
    s = exact_einsum("bskgh,bckh->bskgc", qf, k_cache)
    mask = kv_pos[:, None, :] <= q_pos[:, :, None]  # [B, S, C]
    if window:
        mask &= kv_pos[:, None, :] > q_pos[:, :, None] - window
    s = torch.where(mask[:, :, None, None, :], s, -torch.inf)
    m = s.amax(dim=-1)
    p = torch.where(torch.isfinite(m)[..., None], torch.exp(s - m[..., None]),
                    0.0)
    l = p.sum(dim=-1)
    acc = exact_einsum("bskgc,bckh->bskgh", p, v_cache)
    out = _online_softmax_combine(acc, l, m, acfg)
    return out.reshape(B, S, H * hd).to(q.dtype)


def mlp_params(cfg: ModelConfig) -> dict:
    """SwiGLU (w1, w3, w2) for ``act == "silu"``, else the ungated MLP
    (w1, w2), as the reference."""
    D, F = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"w1": P((D, F)), "w3": P((D, F)), "w2": P((F, D))}
    return {"w1": P((D, F)), "w2": P((F, D))}


def mlp(x, params, cfg: ModelConfig, residual=None):
    # the activation rides w1's epilogue, the block's residual add w2's;
    # only the silu MLP is gated by w3
    acfg = cfg.approx
    h = dense(x, params["w1"], acfg, "mlp", activation=cfg.act)
    if cfg.act == "silu":
        h = h * dense(x, params["w3"], acfg, "mlp")
    return dense(h, params["w2"], acfg, "mlp", residual=residual)
