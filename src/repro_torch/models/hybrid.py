"""Jamba-style hybrid superblock: (attn : mamba = 1 : N-1) with MoE FFNs.

The port of ``repro.models.hybrid``.  The layer stack is a list of
superblocks of ``cfg.attn_every`` layers (Jamba: 8): slot
``attn_every // 2`` is attention, the rest are Mamba mixers
(``models/mamba.py``), and the FFNs alternate dense / MoE with period
``cfg.moe_every`` (Jamba: 2).  Each slot owns its params subtree
``"slot{s}"``.

The order of operations is the reference's: in the full-sequence pass
(``forward`` and ``prefill``) every slot is ``x + mixer(ln1(x))`` then
``x + ffn(ln2(x))``, the attention slot included: its output projection
takes no residual and ln2 is a norm of its own (not the dense block's
fused ``rms(wo + residual)`` tail), and w2 takes no residual.  In decode
the attention slot is the dense block's decode step (residuals in the
epilogues), and the Mamba slots are not.
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba as mb
from repro_torch.models.layers import (apply_norm, attention,
                                       attention_params, mlp, mlp_params,
                                       norm_params)
from repro_torch.models.moe import moe_ffn, moe_params
from repro_torch.models.params import P
from repro_torch.models.transformer import attn_cache_specs, block_decode

__all__ = ["attn_slot", "superblock_params", "superblock_apply",
           "superblock_prefill", "superblock_decode",
           "superblock_cache_specs"]


def attn_slot(cfg: ModelConfig) -> int:
    return cfg.attn_every // 2


def _slot_is_moe(cfg: ModelConfig, s: int) -> bool:
    return cfg.n_experts > 0 and (s % cfg.moe_every == cfg.moe_every - 1)


def superblock_params(cfg: ModelConfig) -> dict:
    p = {}
    for s in range(cfg.attn_every):
        slot = {"ln1": norm_params(cfg)}
        if s == attn_slot(cfg):
            slot["attn"] = attention_params(cfg)
        else:
            slot["mamba"] = mb.mamba_params(cfg)
        slot["ln2"] = norm_params(cfg)
        slot["ffn"] = (moe_params(cfg) if _slot_is_moe(cfg, s)
                       else mlp_params(cfg))
        p[f"slot{s}"] = slot
    return p


def _slot_apply(x, slot, s: int, cfg: ModelConfig, positions):
    """One slot over the full sequence: (x, the mixer's state), the state
    (k, v) for the attention slot, (h, conv) for a Mamba slot."""
    h = apply_norm(x, slot["ln1"], cfg)
    if s == attn_slot(cfg):
        h, k, v = attention(h, slot["attn"], cfg, positions)
        state = (k, v)
    else:
        h, state = mb.mamba(h, slot["mamba"], cfg)
    x = x + h
    h2 = apply_norm(x, slot["ln2"], cfg)
    if _slot_is_moe(cfg, s):
        return x + moe_ffn(h2, slot["ffn"], cfg), state
    return x + mlp(h2, slot["ffn"], cfg), state


def _slot_out(x, slot, s: int, cfg: ModelConfig, positions):
    return _slot_apply(x, slot, s, cfg, positions)[0]


def superblock_apply(x, p, cfg: ModelConfig, positions, remat: str):
    """Full-sequence superblock (forward). x: [B, S, D] -> x.

    Under ``remat`` "block" or "full" each slot runs under its own
    checkpoint (full recompute, the reference's per-slot
    ``nothing_saveable``), nested in the model's checkpoint of the whole
    superblock: the backward then recomputes one slot at a time, so the
    live set of a recompute is one slot's intermediates, not all
    ``attn_every`` slots'.  At "block" a slot's products then run three
    times a step (the forward, the superblock's recompute, the slot's
    own), the last slot's twice (the superblock's recompute stops at
    its input); at "full" the superblock's recompute replays the
    ``qmatmul`` outputs from its tape, so each runs twice (an expert
    product, which has a batch dim, is recomputed, as the reference's
    ``dots_with_no_batch_dims_saveable`` has it)."""
    for s in range(cfg.attn_every):
        if remat == "none":
            x = _slot_out(x, p[f"slot{s}"], s, cfg, positions)
        else:
            x = checkpoint(_slot_out, x, p[f"slot{s}"], s, cfg, positions,
                           use_reentrant=False)
    return x


def superblock_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Per-superblock decode cache: the attention slot's {k, v} and each
    Mamba slot's {h: [B, d_inner, N] f32, conv: [B, K-1, d_inner]}."""
    d_inner, _ = mb._dims(cfg)
    N, K = cfg.ssm_state, cfg.ssm_conv
    specs = {}
    for s in range(cfg.attn_every):
        if s == attn_slot(cfg):
            specs[f"slot{s}"] = attn_cache_specs(cfg, batch, seq_len)
        else:
            specs[f"slot{s}"] = {
                "h": P((batch, d_inner, N), "zeros"),
                "conv": P((batch, K - 1, d_inner), "zeros", dtype=cfg.dtype)}
    return specs


def superblock_prefill(x, p, cfg: ModelConfig, positions, to_ring,
                       cache_dtype):
    """Full-sequence pass that also returns the superblock's decode cache;
    ``to_ring`` lays the attention slot's k / v out as the ring cache."""
    cache = {}
    for s in range(cfg.attn_every):
        x, state = _slot_apply(x, p[f"slot{s}"], s, cfg, positions)
        if s == attn_slot(cfg):
            cache[f"slot{s}"] = {"k": to_ring(state[0]).to(cache_dtype),
                                 "v": to_ring(state[1]).to(cache_dtype)}
        else:
            cache[f"slot{s}"] = {"h": state[0],
                                 "conv": state[1].to(cache_dtype)}
    return x, cache


def superblock_decode(x, p, cache, slot_positions, pos, cfg: ModelConfig):
    """One-token decode through a superblock. x: [B, D]; every slot's cache
    is written in place.  Returns (x, cache)."""
    for s in range(cfg.attn_every):
        slot, sc = p[f"slot{s}"], cache[f"slot{s}"]
        if s == attn_slot(cfg):
            x, _ = block_decode(x, slot, sc, slot_positions, pos, cfg,
                                moe_layer=_slot_is_moe(cfg, s))
            continue
        h = apply_norm(x[:, None], slot["ln1"], cfg)[:, 0]
        h, _ = mb.mamba_decode(h, sc, slot["mamba"], cfg)
        x = x + h
        h2 = apply_norm(x[:, None], slot["ln2"], cfg)
        if _slot_is_moe(cfg, s):
            x = x + moe_ffn(h2, slot["ffn"], cfg)[:, 0]
        else:
            x = x + mlp(h2, slot["ffn"], cfg)[:, 0]
    return x, cache
