"""Mamba (selective SSM) mixer: the recurrent half of the Jamba hybrid.

The port of ``repro.models.mamba``.  Prefill runs a chunked scan: within a
chunk of ``_CHUNK`` tokens the discretised recurrence ``h_t = dA_t * h_{t-1}
+ dBx_t`` is an associative scan (the odd/even recursion of
``jax.lax.associative_scan``, step for step), and a short Python loop over
chunks carries the state.  Decode is the O(1) recurrent update, written
into the cache tensors in place (a CUDA graph replays on fixed addresses).

``in_proj`` and ``out_proj`` go through :func:`dense` at the ``"mlp"`` site
(kernel K1 under a RAPID scheme); ``x_proj`` and ``dt_proj`` are exact f32
contractions, as in the reference.  The scan, the causal conv and the state
update are plain torch on every device: the reference has no kernel for
them.

Bits against the reference.  XLA on the CPU contracts ``a * b + c`` into
one fused multiply-add; the scan's ``b`` update, ``aa * h + bb``, the decode
update and the f32 causal conv are written with :func:`fma` in the
reference's grouping, so given the same inputs they give its bits (the
bf16 conv rounds after every op, as XLA does there).  The N = 16
contractions, ``exp`` and ``log1p`` round differently from XLA's (a few
ulp; ``tests/test_torch_hybrid.py`` states the bounds); ``silu`` and
``softplus`` take XLA's steps (``models/xla_math.py``, shared with the
xLSTM mixers).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense
from repro_torch.models.params import P
from repro_torch.models.xla_math import fma, silu, softplus

__all__ = ["mamba_params", "mamba", "mamba_decode", "mamba_init_cache",
           "fma", "chunk_scan"]

_CHUNK = 32


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, cfg.d_model // 16)
    return d_inner, dt_rank


def mamba_params(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    d_inner, dt_rank = _dims(cfg)
    N, K = cfg.ssm_state, cfg.ssm_conv
    return {
        "in_proj": P((D, 2 * d_inner)),
        "conv_w": P((K, d_inner), "normal", 0.5),
        "conv_b": P((d_inner,), "zeros"),
        "x_proj": P((d_inner, dt_rank + 2 * N)),
        "dt_proj": P((dt_rank, d_inner), "small"),
        "dt_bias": P((d_inner,), "ones"),
        "a_log": P((d_inner, N), "zeros"),
        "d_skip": P((d_inner,), "ones"),
        "out_proj": P((d_inner, D)),
    }


def _ssm_inputs(x_in, params, cfg: ModelConfig):
    """Common pre-scan computation. x_in: [..., d_inner] (post conv+silu)."""
    _, dt_rank = _dims(cfg)
    N = cfg.ssm_state
    xdbc = torch.matmul(x_in.float(), params["x_proj"].float())
    dt_r, Bm, Cm = torch.split(xdbc, [dt_rank, N, N], dim=-1)
    dt = softplus(torch.matmul(dt_r, params["dt_proj"].float())
                  + params["dt_bias"].float())  # [..., d_inner]
    A = -torch.exp(params["a_log"].float())  # [d_inner, N]
    return dt, A, Bm, Cm


def _conv_causal(x, w, b, state=None):
    """Depthwise causal conv along S. x: [B,S,C]; w: [K,C]; state: [B,K-1,C].

    Returns (out [B,S,C], the last K-1 inputs [B,K-1,C]).  In f32 the taps
    are summed as XLA contracts the reference's sum (tap 0's product fused
    with tap 1's, then taps 2.. fused in turn); in bf16 every op rounds.
    """
    K, S = w.shape[0], x.shape[1]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    taps = [xp[:, i:i + S] for i in range(K)]
    if x.dtype == torch.float32 and K > 1:
        out = fma(taps[0], w[0].expand_as(taps[0]), taps[1] * w[1])
        for i in range(2, K):
            out = fma(taps[i], w[i].expand_as(out), out)
    else:
        out = taps[0] * w[0]
        for i in range(1, K):
            out = out + taps[i] * w[i]
    return out + b, xp[:, S:]


def _combine(e1, e2):
    """The reference's scan operator: (a1 a2, b1 a2 + b2), ``e1`` first."""
    (a1, b1), (a2, b2) = e1, e2
    return a1 * a2, fma(b1, a2, b2)


def _interleave(even, odd):
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1])
                         + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def chunk_scan(da, dbx):
    """Inclusive scan of ``_combine`` along dim 1, by the odd/even
    recursion of ``jax.lax.associative_scan`` (the same pairs combined in
    the same order).  da, dbx: [B, C, ...] f32 -> (aa, bb)."""
    n = da.shape[1]
    if n < 2:
        return da, dbx
    odd = chunk_scan(*_combine((da[:, 0:-1:2], dbx[:, 0:-1:2]),
                               (da[:, 1::2], dbx[:, 1::2])))
    head = odd if n % 2 else (odd[0][:, :-1], odd[1][:, :-1])
    even = _combine(head, (da[:, 2::2], dbx[:, 2::2]))
    return tuple(_interleave(torch.cat([t[:, :1], e], dim=1), o)
                 for t, e, o in zip((da, dbx), even, odd))


def _contract_state(h, c):
    """``einsum("...in,...n->...i", h, c)``: the state read out (f32)."""
    return (h * c.unsqueeze(-2)).sum(-1)


def mamba(x, params, cfg: ModelConfig):
    """Train/prefill forward. x: [B, S, D] -> ([B, S, D], (h, conv)):
    the final state h [B, d_inner, N] f32 and the conv's last K-1 inputs
    [B, K-1, d_inner] in x's dtype."""
    B, S, _ = x.shape
    d_inner, _ = _dims(cfg)
    N = cfg.ssm_state
    acfg = cfg.approx

    xz = dense(x, params["in_proj"], acfg, "mlp")
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in, conv_state = _conv_causal(x_in, params["conv_w"].to(x.dtype),
                                    params["conv_b"].to(x.dtype))
    x_in = silu(x_in)

    dt, A, Bm, Cm = _ssm_inputs(x_in, params, cfg)
    xf = x_in.float()

    # chunked scan over S; the discretisation happens inside each chunk,
    # so no [B, S, d_inner, N] tensor is made
    C_ = min(_CHUNK, S)
    pad = (-S) % C_
    dt, Bm, Cm, xs = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, Cm, xf))
    h = torch.zeros((B, d_inner, N), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S + pad, C_):
        dtc, bc, cc, xc = (t[:, c0:c0 + C_] for t in (dt, Bm, Cm, xs))
        da = torch.exp(dtc[..., None] * A)               # [B,C,di,N]
        dbx = (dtc * xc)[..., None] * bc[:, :, None, :]
        aa, bb = chunk_scan(da, dbx)
        hs = fma(aa, h[:, None].expand_as(aa), bb)       # [B,C,di,N]
        ys.append(_contract_state(hs, cc))
        h = hs[:, -1]
    y = torch.cat(ys, dim=1)[:, :S]

    y = fma(params["d_skip"].float().expand_as(xf), xf, y)
    y = (y * silu(z.float())).to(x.dtype)
    out = dense(y, params["out_proj"], acfg, "mlp")
    return out, (h.contiguous(), conv_state)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> dict:
    """An empty decode state: h [B, d_inner, N] f32, conv [B, K-1, d_inner]
    in ``dtype``."""
    d_inner, _ = _dims(cfg)
    return {"h": torch.zeros((batch, d_inner, cfg.ssm_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner),
                                dtype=dtype, device=device)}


def mamba_decode(x, cache: dict, params, cfg: ModelConfig):
    """Single-token step. x: [B, D]; cache: {"h": [B, di, N] f32, "conv":
    [B, K-1, di]}, both written in place.  Returns (out [B, D], cache).
    Reads nothing back to the host (the step is capturable)."""
    acfg = cfg.approx

    xz = dense(x[:, None, :], params["in_proj"], acfg, "mlp")
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in, conv_state = _conv_causal(
        x_in, params["conv_w"].to(x.dtype), params["conv_b"].to(x.dtype),
        state=cache["conv"])
    x_in = silu(x_in)[:, 0]  # [B, di]
    z = z[:, 0]

    dt, A, Bm, Cm = _ssm_inputs(x_in, params, cfg)
    xf = x_in.float()
    dA = torch.exp(dt[..., None] * A)                        # [B,di,N]
    h = fma(dA, cache["h"], (dt * xf)[..., None] * Bm[:, None, :])
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    y = _contract_state(h, Cm)
    y = fma(params["d_skip"].float().expand_as(xf), xf, y)
    y = (y * silu(z.float())).to(x.dtype)
    out = dense(y[:, None, :], params["out_proj"], acfg, "mlp")[:, 0]
    return out, cache
