"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM.

The port of ``repro.models.xlstm``.  mLSTM keeps a per-head matrix memory
C [hd, hd] with exponential input gates and sigmoid-in-log-space forget
gates.  Prefill runs the *chunkwise* form: intra-chunk quadratic
attention-like scores with decay weights, and a short Python loop over
chunks carrying the state ``(C, n, m)``, stabilised by the running
log-scale ``m`` so that no exp overflows.  Decode is the O(1) recurrence.
sLSTM is sequential (recurrent h -> gate connections): a Python loop over
time steps, as the reference's ``lax.scan``.  The decode forms write the
new state into the cache tensors in place (a CUDA graph replays on fixed
addresses); the reference returns new arrays.

Sites.  ``up_proj``, ``down_proj`` and sLSTM's ``w`` go through
:func:`dense` at ``"mlp"``, ``wq`` / ``wk`` / ``wv`` at ``"attn_proj"``
(kernel K1 under a RAPID scheme, no epilogue: the residual is added
outside).  The output normalisers are real divides at the ``"norm"`` site
(:func:`_norm_div`): mLSTM's ``num / max(|n.q|, e^-m)[..., None]`` has one
denominator a row (K5, K8 at depth >= 2), sLSTM's ``c / max(n, 1e-6)``
is elementwise (K6).  The gates, the recurrent ``r`` contraction and the
chunk's score, state and normaliser contractions are exact f32 matmuls,
as in the reference, and the rest is plain torch on every device: the
reference has no kernel for them.

Bits against the reference (XLA on the CPU).  ``F = cumsum(lf)`` is
XLA's blocked scan (:func:`blocked_cumsum`); the state updates are the
FMAs XLA contracts them into (:func:`~repro_torch.models.xla_math.fma`);
``q / sqrt(hd)`` is XLA's multiply by the f32 reciprocal.  Given the same
inputs those give the reference's bits.  The f32 contractions, ``exp``,
``tanh``, ``sigmoid`` and ``log1p`` round differently from XLA's (a few
ulp; ``tests/test_torch_xlstm.py`` states the bounds).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.core.ops import qdiv
from repro_torch.models.layers import (_attn_scale, apply_norm, dense,
                                       norm_params)
from repro_torch.models.params import P
from repro_torch.models.xla_math import fma, log_sigmoid, silu

__all__ = [
    "mlstm_params", "mlstm", "mlstm_decode", "mlstm_init_cache",
    "slstm_params", "slstm", "slstm_decode", "slstm_init_cache",
    "blocked_cumsum", "layer_params", "layer_apply", "layer_decode",
    "layer_init_cache",
]

_CHUNK = 64
# XLA's cumsum on the CPU: sequential sums within blocks of this many,
# then the block totals summed in turn
_SCAN_BLOCK = 16


def _norm_div(num, den, acfg: ApproxConfig):
    """``num / den`` at the ``"norm"`` site: the RAPID divider (K5 when
    ``den`` has trailing dim 1, else K6) or IEEE for the exact scheme."""
    return qdiv(num, den, acfg.div("norm"))


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim, grouped as XLA's on the CPU
    (a ``reduce_window`` it rewrites into two levels): sequential sums
    within blocks of 16, the block totals summed sequentially, and each
    element = (the sum of the blocks before it) + (its within-block sum).
    Explicit adds, so the grouping is the same on every device."""
    L = x.shape[-1]
    xb = F.pad(x, (0, (-L) % _SCAN_BLOCK)).unflatten(-1, (-1, _SCAN_BLOCK))
    acc = [xb[..., 0]]
    for j in range(1, _SCAN_BLOCK):
        acc.append(acc[-1] + xb[..., j])
    within = torch.stack(acc, dim=-1)  # [..., n_blocks, 16]
    blocks, before = [within[..., 0, :]], None
    for i in range(1, within.shape[-2]):
        total = within[..., i - 1, -1]
        before = total if before is None else before + total
        blocks.append(before[..., None] + within[..., i, :])
    return torch.cat(blocks, dim=-1)[..., :L]


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_dims(cfg: ModelConfig):
    """mLSTM operates in the 2x up-projected space; heads split that."""
    up = 2 * cfg.d_model
    return up, up // cfg.n_heads


def mlstm_params(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    up, hd = mlstm_dims(cfg)
    return {
        "up_proj": P((D, 2 * up)),
        "wq": P((up, H * hd)),
        "wk": P((up, H * hd)),
        "wv": P((up, H * hd)),
        "wi": P((up, H), "small"),
        "wf": P((up, H), "small"),
        "f_bias": P((H,), "ones", 3.0),
        "down_proj": P((up, D)),
    }


def _gates(xi, params):
    """xi: [..., up] f32 -> (log input gate (unbounded), log forget gate
    (< 0)), [..., H] each: exact f32 contractions."""
    li = torch.matmul(xi, params["wi"].float())
    lf = log_sigmoid(torch.matmul(xi, params["wf"].float())
                     + 3.0 * params["f_bias"].float())
    return li, lf


def _mlstm_core_chunk(q, k, v, li, lf, carry, acfg: ApproxConfig):
    """One chunk. q, k, v: [B,H,L,hd]; li, lf: [B,H,L] f32; carry (Ch,
    nh, m0): [B,H,hd,hd], [B,H,hd], [B,H].  Returns (h [B,H,L,hd] f32,
    the carry at the chunk's end)."""
    L, hd = q.shape[-2:]
    Ch, nh, m0 = carry
    Fc = blocked_cumsum(lf)                         # [B,H,L]
    b = li - Fc                                     # log(i) - F
    M = torch.maximum(torch.cummax(b, dim=-1).values, m0[..., None])
    m_t = Fc + M                                    # stabiliser per step
    # intra-chunk scores
    qs = q.float() * _attn_scale(hd)
    kf, vf = k.float(), v.float()
    s = torch.matmul(qs, kf.transpose(-1, -2))
    w = Fc[..., :, None] + b[..., None, :] - m_t[..., :, None]  # [B,H,L,L]
    mask = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    p = torch.exp(torch.where(mask, w, -torch.inf))
    ps = p * s
    num = torch.matmul(ps, vf)
    den = ps.sum(dim=-1)                            # [B,H,L]
    # inter-chunk (state) contribution: num + w_st * (qs Ch), fused
    w_st = torch.exp(Fc + m0[..., None] - m_t)      # [B,H,L]
    num = fma(w_st[..., None], torch.matmul(qs, Ch), num)
    den = fma(w_st, torch.matmul(qs, nh[..., None])[..., 0], den)
    h = _norm_div(num, torch.maximum(den.abs(), torch.exp(-m_t))[..., None],
                  acfg)
    # carry update
    mL = m_t[..., -1]
    wc = torch.exp(Fc[..., -1] + m0 - mL)           # carry decay
    wk_ = torch.exp(Fc[..., -1:] + b - mL[..., None])  # F_L - F_t + li_t
    # wc * Ch + einsum("bhl,bhld,bhle->bhde", wk_, k, v), fused; the
    # same for n
    Ch = fma(wc[..., None, None], Ch,
             torch.matmul((wk_[..., None] * kf).transpose(-1, -2), vf))
    nh = fma(wc[..., None], nh, torch.matmul(wk_[..., None, :], kf)[..., 0, :])
    return h, (Ch, nh, mL)


def _split_heads(x, H):
    B, S, _ = x.shape
    return x.reshape(B, S, H, -1).transpose(1, 2)  # [B,H,S,hd]


def mlstm(x, params, cfg: ModelConfig):
    """Train/prefill. x: [B,S,D] -> ([B,S,D], {"C", "n", "m"}): the
    state at the end of the last (padded) chunk, from which decode
    continues."""
    B, S, D = x.shape
    H = cfg.n_heads
    acfg = cfg.approx
    up2 = dense(x, params["up_proj"], acfg, "mlp")
    xi, z = torch.chunk(up2, 2, dim=-1)

    q = _split_heads(dense(xi, params["wq"], acfg, "attn_proj"), H)
    k = _split_heads(dense(xi, params["wk"], acfg, "attn_proj"), H)
    v = _split_heads(dense(xi, params["wv"], acfg, "attn_proj"), H)
    li, lf = _gates(xi.float(), params)
    li = li.transpose(1, 2)  # [B,H,S]
    lf = lf.transpose(1, 2)

    L = min(_CHUNK, S)
    pad = (-S) % L
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, pad), value=-1e9)
        lf = F.pad(lf, (0, pad))
    carry = tuple(mlstm_init_cache(cfg, B, x.device).values())
    hs = []
    for c0 in range(0, S + pad, L):
        h, carry = _mlstm_core_chunk(
            *(t[:, :, c0:c0 + L] for t in (q, k, v, li, lf)), carry, acfg)
        hs.append(h)
    h = torch.cat(hs, dim=2)[:, :, :S]
    h = h.transpose(1, 2).reshape(B, S, -1)

    out = h.to(x.dtype) * silu(z)
    return (dense(out, params["down_proj"], acfg, "mlp"),
            dict(zip("Cnm", carry)))


def mlstm_init_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """An empty state: {C [B,H,hd,hd], n [B,H,hd], m [B,H] = -1e30}, f32."""
    H = cfg.n_heads
    _, hd = mlstm_dims(cfg)
    return {"C": torch.zeros((batch, H, hd, hd), device=device),
            "n": torch.zeros((batch, H, hd), device=device),
            "m": torch.full((batch, H), -1e30, device=device)}


def mlstm_decode_update(wf, Ch, nh, wi, kf, vf):
    """The decode recurrence in XLA's contraction of the reference's
    ``wf * C + wi * (k v^T)`` and ``wf * n + wi * k``: the left products
    fused, the right ones rounded.  wf, wi: [B,H]; kf, vf: [B,H,hd]."""
    kv = kf[..., :, None] * vf[..., None, :]
    return (fma(wf[..., None, None], Ch, wi[..., None, None] * kv),
            fma(wf[..., None], nh, wi[..., None] * kf))


def mlstm_decode(x, cache: dict, params, cfg: ModelConfig):
    """One token. x: [B,D]; cache {"C", "n", "m"}, written in place.
    Returns (out [B,D], cache).  Reads nothing back to the host."""
    B, D = x.shape
    H = cfg.n_heads
    _, hd = mlstm_dims(cfg)
    acfg = cfg.approx

    up2 = dense(x[:, None], params["up_proj"], acfg, "mlp")
    xi, z = torch.chunk(up2, 2, dim=-1)
    q = dense(xi, params["wq"], acfg, "attn_proj").reshape(B, H, hd)
    k = dense(xi, params["wk"], acfg, "attn_proj").reshape(B, H, hd)
    v = dense(xi, params["wv"], acfg, "attn_proj").reshape(B, H, hd)
    li, lf = _gates(xi[:, 0].float(), params)  # [B,H]

    m0 = cache["m"]
    m_t = torch.maximum(lf + m0, li)
    wf = torch.exp(lf + m0 - m_t)
    wi = torch.exp(li - m_t)
    Ch, nh = mlstm_decode_update(wf, cache["C"], cache["n"], wi, k.float(),
                                 v.float())
    cache["C"].copy_(Ch)
    cache["n"].copy_(nh)
    cache["m"].copy_(m_t)
    qf = q.float() * _attn_scale(hd)
    num = torch.matmul(qf[..., None, :], Ch)[..., 0, :]
    den = torch.matmul(qf[..., None, :], nh[..., None])[..., 0, 0].abs()
    h = _norm_div(num, torch.maximum(den, torch.exp(-m_t))[..., None], acfg)
    h = h.reshape(B, H * hd).to(x.dtype) * silu(z[:, 0])
    return dense(h[:, None], params["down_proj"], acfg, "mlp")[:, 0], cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_params(cfg: ModelConfig) -> dict:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "w": P((D, 4 * H * hd)),
        "r": P((H, hd, 4 * hd), "normal", 0.5),
        "bias": P((4 * H * hd,), "zeros"),
        "down_proj": P((H * hd, D)),
    }


def slstm_init_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    """An empty state {c, n, m = -1e30, h}, [B,H,hd] f32 each."""
    shape = (batch, cfg.n_heads, cfg.hd)
    return {"c": torch.zeros(shape, device=device),
            "n": torch.zeros(shape, device=device),
            "m": torch.full(shape, -1e30, device=device),
            "h": torch.zeros(shape, device=device)}


def slstm_update(f_p, c, n, i_p, zt):
    """The reference's ``f * c + i * z`` and ``f * n + i`` as XLA contracts
    them: one fused multiply-add each."""
    return fma(f_p, c, i_p * zt), fma(f_p, n, i_p)


def _slstm_step(params, cfg: ModelConfig, carry, wx_t):
    """wx_t: [B, 4*H*hd], the input projection at one step.  Returns the
    new carry (c, n, m, h)."""
    c, n, m, h = carry
    H, hd = cfg.n_heads, cfg.hd
    B = wx_t.shape[0]
    rec = torch.matmul(h.transpose(0, 1), params["r"].float()).transpose(0, 1)
    pre = wx_t.reshape(B, H, 4 * hd).float() + rec \
        + params["bias"].float().reshape(H, 4 * hd)
    zt, it, ft, ot = torch.split(pre, hd, dim=-1)
    zt = torch.tanh(zt)
    lf = log_sigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(lf + m - m_new)
    c, n = slstm_update(f_p, c, n, i_p, zt)
    h_new = torch.tanh(_norm_div(c, torch.clamp_min(n, 1e-6), cfg.approx))
    return c, n, m_new, torch.sigmoid(ot) * h_new


def slstm(x, params, cfg: ModelConfig):
    """Sequential loop over time. x: [B,S,D] -> ([B,S,D], {"c", "n",
    "m", "h"})."""
    B, S, D = x.shape
    acfg = cfg.approx
    wx = dense(x, params["w"], acfg, "mlp")  # [B,S,4*H*hd]
    carry = tuple(slstm_init_cache(cfg, B, x.device).values())
    hs = []
    for t in range(S):
        carry = _slstm_step(params, cfg, carry, wx[:, t])
        hs.append(carry[3])
    h = torch.stack(hs, dim=1).reshape(B, S, -1).to(x.dtype)
    return (dense(h, params["down_proj"], acfg, "mlp"),
            dict(zip("cnmh", carry)))


def slstm_decode(x, cache: dict, params, cfg: ModelConfig):
    """One token. x: [B,D]; cache {"c", "n", "m", "h"}, written in place.
    Returns (out [B,D], cache)."""
    acfg = cfg.approx
    wx = dense(x[:, None], params["w"], acfg, "mlp")[:, 0]
    new = _slstm_step(params, cfg, tuple(cache.values()), wx)
    for old, t in zip(cache.values(), new):
        old.copy_(t)
    out = dense(cache["h"].reshape(x.shape[0], -1)[:, None].to(x.dtype),
                params["down_proj"], acfg, "mlp")[:, 0]
    return out, cache


# --------------------------------------------------------------------------
# a layer: x + mixer(ln(x)), the mixer by the layer's params
# --------------------------------------------------------------------------

_MIXERS = {"mlstm": (mlstm_params, mlstm, mlstm_decode, mlstm_init_cache),
           "slstm": (slstm_params, slstm, slstm_decode, slstm_init_cache)}


def _kind(lp: dict) -> str:
    return "slstm" if "slstm" in lp else "mlstm"


def layer_params(cfg: ModelConfig, kind: str) -> dict:
    """One layer's spec tree: {"ln", "mlstm" | "slstm"}."""
    return {"ln": norm_params(cfg), kind: _MIXERS[kind][0](cfg)}


def layer_apply(x, lp: dict, cfg: ModelConfig):
    """Full sequence: (x + mixer(ln(x)), the mixer's final state)."""
    kind = _kind(lp)
    h, state = _MIXERS[kind][1](apply_norm(x, lp["ln"], cfg), lp[kind], cfg)
    return x + h, state


def layer_decode(x, lp: dict, lc: dict, cfg: ModelConfig):
    """One token, x: [B, D]: x + mixer(ln(x)), the state ``lc`` written in
    place."""
    kind = _kind(lp)
    h = apply_norm(x[:, None], lp["ln"], cfg)[:, 0]
    return x + _MIXERS[kind][2](h, lc, lp[kind], cfg)[0]


def layer_init_cache(cfg: ModelConfig, kind: str, batch: int,
                     device=None) -> dict:
    return _MIXERS[kind][3](cfg, batch, device)
