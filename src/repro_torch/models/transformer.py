"""Transformer block (dense or MoE FFN; with a cross-attention slot in
an encdec decoder) and its KV-cache decode steps.

The port of ``repro.models.transformer``.  Every function reads the
block's norm ("rms" or "ln") from ``cfg.norm``, and its FFN from
``cfg.n_experts``: the MLP, or with experts the MoE FFN
(:func:`repro_torch.models.moe.moe_ffn`), whose output the residual is
added to after it (the dense MLP adds it in w2's epilogue).  Only
``block_decode`` takes the FFN from its ``moe_layer`` argument, as the
reference: the hybrid family's attention slot decides it per slot
(``models/hybrid.py``), the dense and moe families pass
``cfg.n_experts > 0``.
Prefill of an rms block without a cross slot always fuses ln2's divide
into the attention-out matmul's epilogue
(``rms_div(wo_out + residual)``, keeping the pre-norm residual stream):
the reference fuses it whenever the norm and attn_proj sites share a
backend, and the port has one dispatch path.  An LN block, or a block
with a cross slot, runs :func:`apply_norm` on the unfused
``wo + residual`` output, as the reference.  The decode steps
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
from repro_torch.models.moe import moe_ffn, moe_params
from repro_torch.models.params import P

__all__ = ["block_params", "block_apply", "block_decode",
           "block_decode_paged", "cache_len", "cross_positions", "ring_slot",
           "attn_cache_specs", "paged_attn_cache_specs"]


def block_params(cfg: ModelConfig, cross: bool = False) -> dict:
    """One block's params; ``cross`` adds the cross-attention slot (its
    norm ``lnx`` and projections ``xattn``) of an encdec decoder block."""
    p = {
        "ln1": norm_params(cfg),
        "attn": attention_params(cfg),
        "ln2": norm_params(cfg),
    }
    if cross:
        p["lnx"] = norm_params(cfg)
        p["xattn"] = attention_params(cfg)
    p["ffn"] = moe_params(cfg) if cfg.n_experts > 0 else mlp_params(cfg)
    return p


def _ffn(x, p, cfg: ModelConfig, moe_layer: bool, residual):
    if moe_layer:
        return residual + moe_ffn(x, p["ffn"], cfg)
    return mlp(x, p["ffn"], cfg, residual=residual)


def block_apply(x, p, cfg: ModelConfig, positions, enc_out=None,
                enc_positions=None, causal: bool = True):
    """Full-sequence block.  Returns (x, kv) for the decode cache: kv is
    (k, v), or with ``enc_out`` (an encdec decoder block: the
    cross-attention slot between self-attention and ln2, over the
    encoder's output at ``enc_positions``) (k, v, ck, cv), the cross
    k/v the slot computed.  ``causal`` False makes the self-attention
    bidirectional (the encoder's blocks).  ln2's divide fuses into the
    attention-out matmul only in an rms block without a cross slot, as
    the reference's."""
    fuse_ln2 = cfg.norm == "rms" and enc_out is None
    h, k, v = attention(apply_norm(x, p["ln1"], cfg), p["attn"], cfg,
                        positions, residual=x, tail_norm=fuse_ln2,
                        causal=causal)
    kv = (k, v)
    if fuse_ln2:
        y, ydiv = h
        ffn_in = (ydiv.float() * p["ln2"]["scale"].float()).to(y.dtype)
    else:
        y = h
        if enc_out is not None:
            y, ck, cv = attention(apply_norm(y, p["lnx"], cfg), p["xattn"],
                                  cfg, positions, residual=y, kv_x=enc_out,
                                  kv_positions=enc_positions, causal=False)
            kv = (k, v, ck, cv)
        ffn_in = apply_norm(y, p["ln2"], cfg)
    return _ffn(ffn_in, p, cfg, cfg.n_experts > 0, residual=y), kv


def cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def attn_cache_specs(cfg: ModelConfig, batch: int, seq_len: int,
                     cross_len: int = 0) -> dict:
    """P-spec tree for one layer's attention cache (in the config dtype);
    ``cross_len`` adds the cross-attention cache ``ck`` / ``cv`` of that
    many encoder frames (an encdec decoder layer)."""
    shape = (batch, cache_len(cfg, seq_len), cfg.n_kv_heads, cfg.hd)
    p = {"k": P(shape, "zeros", dtype=cfg.dtype),
         "v": P(shape, "zeros", dtype=cfg.dtype)}
    if cross_len:
        xshape = (batch, cross_len, cfg.n_kv_heads, cfg.hd)
        p["ck"] = P(xshape, "zeros", dtype=cfg.dtype)
        p["cv"] = P(xshape, "zeros", dtype=cfg.dtype)
    return p


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
    return _ffn(h2, p, cfg, cfg.n_experts > 0, residual=x), cache


# the cross slot's query position: past every encoder frame, as the
# reference's ``jnp.int32(2**30)``
_CROSS_POS = 2**30


def ring_slot(pos: torch.Tensor, c: int) -> torch.Tensor:
    """The ring index ``pos % c`` of a 0-dim int32 position, as the
    ``[1]`` int64 index of an ``index_copy_`` along the slot dim: a
    tensor index, so the write reads nothing back to the host."""
    return (pos % c).long().reshape(1)


def cross_positions(batch: int, frames: int, device):
    """The cross slot's K4 positions for a decode step, made on the
    device once a step and shared by every layer: the frames' slot
    positions ``arange(frames)`` [B, frames] and the query position
    2**30 [B], both int32, contiguous."""
    f = torch.arange(frames, dtype=torch.int32, device=device)
    return (f.expand(batch, frames).contiguous(),
            torch.full((batch,), _CROSS_POS, dtype=torch.int32,
                       device=device))


def block_decode(x, p, cache, slot_positions, pos: torch.Tensor,
                 cfg: ModelConfig, moe_layer: bool, cross_pos=None):
    """One-token decode. x: [B, D]; cache: {"k", "v"[, "ck", "cv"]}; pos:
    the current position, a 0-dim int32 tensor on the cache's device.

    Writes this token's k/v into the ring slot ``pos % C`` of the cache
    tensors in place (the reference returns updated copies) and returns
    (x, cache).  With ``ck`` / ``cv`` in the cache (an encdec decoder
    layer) the cross-attention slot follows self-attention: K4 over every
    encoder frame at ``cross_pos`` (:func:`cross_positions`: slot
    positions ``arange(Tc)``, query position 2**30; no window), as the
    reference.  Nothing here reads ``pos`` back to the host, so the step
    can be captured in a CUDA graph.
    """
    acfg = cfg.approx
    B, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    C = cache["k"].shape[1]

    h = apply_norm(x[:, None], p["ln1"], cfg)
    q = dense(h, p["attn"]["wq"], acfg, "attn_proj").reshape(B, H, hd)
    k = dense(h, p["attn"]["wk"], acfg, "attn_proj").reshape(B, KV, hd)
    v = dense(h, p["attn"]["wv"], acfg, "attn_proj").reshape(B, KV, hd)
    posv = pos.expand(B, 1)
    q = rope(q[:, None], posv, cfg.rope_theta)[:, 0]
    k = rope(k[:, None], posv, cfg.rope_theta)[:, 0]

    write = ring_slot(pos, C)  # ring write for sliding-window caches
    cache["k"].index_copy_(1, write, k[:, None].to(cache["k"].dtype))
    cache["v"].index_copy_(1, write, v[:, None].to(cache["v"].dtype))
    attn_out = decode_attention(q, cache["k"], cache["v"], slot_positions,
                                pos, cfg.sliding_window, acfg)
    # the residual adds ride the projection epilogues (fused block tail)
    x = dense(attn_out[:, None], p["attn"]["wo"], acfg, "attn_proj",
              residual=x[:, None])[:, 0]
    if "ck" in cache:  # cross-attention (encdec decode)
        hx = apply_norm(x[:, None], p["lnx"], cfg)
        qx = dense(hx, p["xattn"]["wq"], acfg, "attn_proj").reshape(B, H, hd)
        xo = decode_attention(qx, cache["ck"], cache["cv"], *cross_pos, 0,
                              acfg)
        x = dense(xo[:, None], p["xattn"]["wo"], acfg, "attn_proj",
                  residual=x[:, None])[:, 0]
    h2 = apply_norm(x[:, None], p["ln2"], cfg)
    x = _ffn(h2, p, cfg, moe_layer, residual=x[:, None])[:, 0]
    return x, cache
