"""Decoder transformer block (dense FFN) and its KV-cache decode steps.

The port of the dense parts of ``repro.models.transformer``.  Prefill
always fuses ln2's rms divide into the attention-out matmul's epilogue
(``rms_div(wo_out + residual)``, keeping the pre-norm residual stream):
the reference fuses it whenever the norm and attn_proj sites share a
backend, and the port has one dispatch path.  The decode steps
(``block_decode`` on a ring cache, ``block_decode_paged`` on a
block-paged pool) do not fuse ln2: they call :func:`apply_norm`, as the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (_MAXI32, apply_norm, attention,
                                       attention_params,
                                       chunk_cache_attention,
                                       decode_attention, dense, mlp,
                                       mlp_params, norm_params, rope)
from repro_torch.models.params import P

__all__ = ["block_params", "block_apply", "block_decode",
           "block_decode_paged", "cache_len", "attn_cache_specs",
           "paged_attn_cache_specs"]


def block_params(cfg: ModelConfig) -> dict:
    return {
        "ln1": norm_params(cfg),
        "attn": attention_params(cfg),
        "ln2": norm_params(cfg),
        "ffn": mlp_params(cfg),
    }


def block_apply(x, p, cfg: ModelConfig, positions):
    """Full-sequence block.  Returns (x, (k, v)) for the decode cache."""
    (y, ydiv), k, v = attention(apply_norm(x, p["ln1"], cfg), p["attn"], cfg,
                                positions, residual=x, tail_norm=True)
    ffn_in = (ydiv.float() * p["ln2"]["scale"].float()).to(y.dtype)
    return mlp(ffn_in, p["ffn"], cfg, residual=y), (k, v)


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def attn_cache_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """P-spec tree for one layer's attention cache (in the config dtype)."""
    shape = (batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    return {"k": P(shape, "zeros", dtype=cfg.dtype),
            "v": P(shape, "zeros", dtype=cfg.dtype)}


def paged_attn_cache_specs(cfg: ModelConfig, n_pages: int,
                           page_size: int) -> dict:
    """P-spec tree for one layer's block-paged KV pool.

    No batch dim: slots own pages of the shared ``[n_pages, page_size,
    KV, hd]`` pool through a page table, so memory scales with live
    tokens, not slots x cache_n.
    """
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": P(shape, "zeros", dtype=cfg.dtype),
            "v": P(shape, "zeros", dtype=cfg.dtype)}


def block_decode_paged(x, p, cache, page_table, positions, valid, kv_len,
                       cfg: ModelConfig):
    """Chunk decode against a block-paged KV pool (page-table writes).

    Token ``i`` of slot ``b`` lands in pool page ``page_table[b, pos //
    PS]`` at offset ``pos % PS``, and the slot's cache view is gathered
    back through the same table.  Serves both the continuous decode tick
    (S = 1, every slot; attention is kernel K4 with a per-slot position)
    and a chunked-prefill tick (S = chunk, one slot; attention is
    :func:`chunk_cache_attention`, whose combine divide is kernel K5).

    x: [B, S, D]; cache: {"k", "v"} pools [NP, PS, KV, hd], written in
    place (the reference returns updated copies); page_table: [B, P]
    int32 pool indices; positions: [B, S] absolute token positions;
    valid: [B, S] bool (False tokens write to the scratch page 0, which
    no live slot reads); kv_len: [B] int32 valid cache tokens per slot
    *after* this chunk's writes.  Returns (x, cache).
    """
    acfg = cfg.approx
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    PS = cache["k"].shape[1]
    Pp = page_table.shape[1]
    C = Pp * PS

    h = apply_norm(x, p["ln1"], cfg)
    q = dense(h, p["attn"]["wq"], acfg, "attn_proj").reshape(B, S, H, hd)
    k = dense(h, p["attn"]["wk"], acfg, "attn_proj").reshape(B, S, KV, hd)
    v = dense(h, p["attn"]["wv"], acfg, "attn_proj").reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    # page-table write; several invalid tokens may land on one scratch
    # slot, in no defined order, which is harmless: page 0 is never read
    pidx = torch.clamp(positions // PS, 0, Pp - 1).long()
    pid = torch.gather(page_table, 1, pidx)
    pid = torch.where(valid, pid, 0).reshape(-1).long()
    poff = (positions % PS).reshape(-1).long()
    cache["k"][pid, poff] = k.reshape(B * S, KV, hd).to(cache["k"].dtype)
    cache["v"][pid, poff] = v.reshape(B * S, KV, hd).to(cache["v"].dtype)

    # gather the slot views back through the table: [B, P*PS, KV, hd]
    pt = page_table.long()
    kg = cache["k"][pt].reshape(B, C, KV, hd)
    vg = cache["v"][pt].reshape(B, C, KV, hd)
    j = torch.arange(C, dtype=torch.int32, device=x.device)
    kv_pos = torch.where(j[None, :] < kv_len[:, None], j[None, :], _MAXI32)

    if S == 1:
        # the same formulation as the lockstep decode step
        attn_out = decode_attention(q[:, 0], kg, vg, kv_pos, positions[:, 0],
                                    cfg.sliding_window, acfg)[:, None]
    else:
        attn_out = chunk_cache_attention(q, kg, vg, positions, kv_pos,
                                         cfg.sliding_window, acfg)
    x = dense(attn_out, p["attn"]["wo"], acfg, "attn_proj", residual=x)
    h2 = apply_norm(x, p["ln2"], cfg)
    return mlp(h2, p["ffn"], cfg, residual=x), cache


def block_decode(x, p, cache, slot_positions, pos: int, cfg: ModelConfig):
    """One-token decode. x: [B, D]; cache: {"k", "v"}; pos: int.

    Writes this token's k/v into the ring slot ``pos % C`` of the cache
    tensors in place (the reference returns updated copies) and returns
    (x, cache).
    """
    acfg = cfg.approx
    B, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    C = cache["k"].shape[1]

    h = apply_norm(x[:, None], p["ln1"], cfg)
    q = dense(h, p["attn"]["wq"], acfg, "attn_proj").reshape(B, H, hd)
    k = dense(h, p["attn"]["wk"], acfg, "attn_proj").reshape(B, KV, hd)
    v = dense(h, p["attn"]["wv"], acfg, "attn_proj").reshape(B, KV, hd)
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = rope(q[:, None], posv, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], posv, cfg.rope_theta)[:, 0]

    write = pos % C  # ring write for sliding-window caches
    cache["k"][:, write] = k.to(cache["k"].dtype)
    cache["v"][:, write] = v.to(cache["v"].dtype)
    attn_out = decode_attention(q, cache["k"], cache["v"], slot_positions,
                                pos, cfg.sliding_window, acfg)
    # the residual adds ride the projection epilogues (fused block tail)
    x = dense(attn_out[:, None], p["attn"]["wo"], acfg, "attn_proj",
              residual=x[:, None])[:, 0]
    h2 = apply_norm(x[:, None], p["ln2"], cfg)
    x = mlp(h2, p["ffn"], cfg, residual=x[:, None])[:, 0]
    return x, cache
