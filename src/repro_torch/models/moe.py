"""Mixture-of-Experts FFN with sort-based capacity routing, on one device.

The port of the single-device route of ``repro.models.moe`` (its
``mesh=None`` branch): every token picks its top-k experts by exact f32
router logits, the k gate values are normalised through
:func:`~repro_torch.core.ops.approx_softmax` (kernel K3, K8 at depth
>= 2, under a RAPID softmax divider), the (token, expert) pairs are
sorted by expert and packed into a static ``[E, capacity, D]`` buffer
(slots past an expert's capacity are dropped), the experts run as
three batched matmuls (kernel K1 batched, silu in w1's epilogue), and
each token sums its experts' gated outputs.

Three choices keep the reference's bits where torch's defaults would
not, the same on the CPU and the card:

* top-k takes the lower expert id among equal logits (``jax.lax.top_k``;
  ``torch.topk`` does not promise it): a stable descending sort, then
  the first k;
* the sort by expert is stable (``jnp.argsort``), which fixes the
  capacity drops;
* the combine adds each token's k weighted expert outputs one at a
  time, from +0, in the sorted slot order (ascending expert id), as the
  reference's scatter-add does on the CPU: a gather and a fixed-order
  sum, where a scatter-add on the card would add in no fixed order.

The buffer is filled by a gather too: slot ``(e, c)`` holds the sorted
pair ``starts[e] + c`` where that pair is expert ``e``'s.  The
reference's scatter-add puts at most one kept token in a slot and adds
zeros from the dropped ones (dropped pairs go to slot (0, 0), times 0),
so both give the same buffer for finite activations.  Shapes depend only
on the input's, and nothing is read back to the host, so a decode step
through this layer can be captured in a CUDA graph.

The EP/TP ``shard_map`` routes (``_route_a2a``, the weight- and
token-gather bodies) are multi-device and not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ApproxConfig, ModelConfig
from repro_torch.core import backend as be
from repro_torch.core.ops import approx_softmax, exact_einsum, qmatmul_batched
from repro_torch.models.layers import mlp, mlp_params
from repro_torch.models.params import P

__all__ = ["moe_params", "moe_ffn", "capacity"]


def _router_gates(gval: torch.Tensor,
                  acfg: Optional[ApproxConfig]) -> torch.Tensor:
    """Top-k gate normalisation through the softmax site's divider (K3,
    K8 at depth >= 2, under a RAPID scheme; IEEE on the exact arm)."""
    sch = acfg.div("softmax") if acfg is not None else None
    return approx_softmax(gval, axis=-1, div_scheme=sch)


def moe_params(cfg: ModelConfig) -> dict:
    """Router ``[D, E]`` ("small"), the expert stacks w1 / w3 ``[E, D,
    F]`` and w2 ``[E, F, D]``, and the always-on shared expert's SwiGLU
    where the config has one."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    p = {
        "router": P((D, E), "small"),
        "w1": P((E, D, F)),
        "w3": P((E, D, F)),
        "w2": P((E, F, D)),
    }
    if cfg.shared_expert:
        p["shared"] = mlp_params(cfg)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert for ``n_tokens`` routed tokens (the reference's
    expression, verbatim): a host int, from shapes alone."""
    E, k = cfg.n_experts, cfg.experts_per_token
    return max(1, int(-(-n_tokens * k * cfg.capacity_factor // E)))


def _top_k(logits: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest values, the
    lower index first among equal ones."""
    val, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return val[..., :k], idx[..., :k]


def _expert_compute(buf, w1, w3, w2, acfg: Optional[ApproxConfig] = None):
    """buf: [E, C, D] -> the experts' SwiGLU, [E, C, D] f32.

    The expert stacks are cast to the buffer's (compute) dtype, as the
    reference casts them on every call; under a RAPID scheme at the mlp
    site the three contractions are batched K1 launches with silu in
    w1's epilogue, else exact einsums with an f32 accumulator.
    """
    sch = acfg.mul("mlp") if acfg is not None else None
    dt = buf.dtype
    if sch:
        g1 = qmatmul_batched(buf, w1.to(dt), sch, activation="silu")
        h3 = qmatmul_batched(buf, w3.to(dt), sch)
        act = (g1.float() * h3.float()).to(dt)
        return qmatmul_batched(act, w2.to(dt), sch).float()
    h1 = exact_einsum("ecd,edf->ecf", buf, w1.to(dt))
    h3 = exact_einsum("ecd,edf->ecf", buf, w3.to(dt))
    act = (be.ACTIVATIONS["silu"](h1) * h3).to(dt)
    return exact_einsum("ecf,efd->ecd", act, w2.to(dt))


def _route_and_compute(tokens, router_w, w1, w3, w2, *, k: int, cap: int,
                       acfg: Optional[ApproxConfig] = None):
    """tokens: [T, D] -> [T, D], every expert on this device.

    Returns the routed experts' gated sum in the tokens' dtype.
    """
    T, D = tokens.shape
    E = w1.shape[0]
    n = T * k
    dev = tokens.device
    # routing logits stay exact (top-k stability); the gate
    # normalisation runs through the softmax site's divider
    logits = exact_einsum("td,de->te", tokens, router_w)
    gval, gidx = _top_k(logits, k)  # [T, k]
    gates = _router_gates(gval, acfg)

    fe = gidx.reshape(-1)  # [T*k] expert ids
    order = torch.argsort(fe, stable=True)
    se = fe[order]
    sg = gates.reshape(-1)[order]
    tok_idx = order // k
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(se, experts, right=False)
    pos = torch.arange(n, device=dev) - starts[se]
    keep = pos < cap
    le = torch.where(keep, se, 0)
    lp = torch.where(keep, pos, 0)

    # slot (e, c) holds the sorted pair starts[e] + c if it is expert e's
    src = starts[:, None] + torch.arange(cap, device=dev)  # [E, cap]
    srcc = torch.clamp(src, max=n - 1)
    filled = (src < n) & (se[srcc] == experts[:, None])
    buf = torch.where(filled[..., None], tokens[tok_idx[srcc]],
                      torch.zeros((), dtype=tokens.dtype, device=dev))
    buf_out = _expert_compute(buf, w1, w3, w2, acfg)

    contrib = buf_out[le, lp] * (sg * keep)[:, None]  # [T*k, D], sorted
    # each token's pairs in sorted order, added one at a time from +0
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=dev))
    slots = torch.sort(rank.reshape(T, k), dim=1).values
    out = torch.zeros((T, D), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + contrib[slots[:, j]]
    return out.to(tokens.dtype)


def moe_ffn(x: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """x: [B, S, D] -> the MoE FFN output, same shape and dtype (the
    shared expert, where the config has one, added after the routed
    experts)."""
    B, S, D = x.shape
    T = B * S
    out = _route_and_compute(
        x.reshape(T, D), params["router"].float(), params["w1"],
        params["w3"], params["w2"], k=cfg.experts_per_token,
        cap=capacity(T, cfg), acfg=cfg.approx).reshape(B, S, D)
    if cfg.shared_expert:
        out = out + mlp(x, params["shared"], cfg)
    return out
