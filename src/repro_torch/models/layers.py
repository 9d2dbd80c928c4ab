"""Core NN layers of the dense serve path: norms, RoPE, GQA/SWA attention,
SwiGLU MLP -- RAPID-aware.

The port of ``repro.models.layers`` (unsharded).  Every weight matmul
goes through :func:`repro_torch.core.ops.qmatmul` (kernel K1 under a
RAPID scheme); every softmax / normalisation divide can go through the
logarithmic divider (kernels K2, K3, K4).  Activations are cast back to
the config's dtype after each op in the same places as the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.core.backend import Epilogue
from repro_torch.core.ops import (exact_einsum, qdecode_attn, qmatmul,
                                  qrms_div, qsoftmax_div)
from repro_torch.models.params import P

__all__ = [
    "dense",
    "rms_norm",
    "apply_norm",
    "rope",
    "attention_params",
    "attention",
    "decode_attention",
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
    return {"scale": P((cfg.d_model,), "ones")}


def rms_norm(x, params, eps: float, acfg: ApproxConfig):
    xf = x.float()
    y = qrms_div(xf, eps, acfg.div("norm"))
    return (y * params["scale"].float()).to(x.dtype)


def apply_norm(x, params, cfg: ModelConfig):
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
        m = s.amax(dim=-1, keepdim=True)
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


# longer sequences take the reference's blockwise path, which needs
# kernel K5 (the row-broadcast divide) and comes with a later slice
_PLAIN_ATTN_MAX_T = 8192


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
    if S > _PLAIN_ATTN_MAX_T:
        raise NotImplementedError(
            f"sequences over {_PLAIN_ATTN_MAX_T} tokens need the blockwise "
            "attention path (kernel K5), not ported yet")
    q = dense(x, params["wq"], acfg, "attn_proj").reshape(B, S, H, hd)
    k = dense(x, params["wk"], acfg, "attn_proj").reshape(B, S, KV, hd)
    v = dense(x, params["wv"], acfg, "attn_proj").reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    G = H // KV
    out = _attn_plain(q, k.repeat_interleave(G, dim=2),
                      v.repeat_interleave(G, dim=2), positions, positions,
                      cfg.sliding_window, True, acfg)
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


def mlp_params(cfg: ModelConfig) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    return {"w1": P((D, F)), "w3": P((D, F)), "w2": P((F, D))}


def mlp(x, params, cfg: ModelConfig, residual=None):
    # silu rides w1's epilogue, the block's residual add w2's
    acfg = cfg.approx
    h = dense(x, params["w1"], acfg, "mlp", activation=cfg.act)
    h = h * dense(x, params["w3"], acfg, "mlp")
    return dense(h, params["w2"], acfg, "mlp", residual=residual)
