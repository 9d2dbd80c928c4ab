"""Decoder transformer block (dense FFN) and its KV-cache decode step.

The port of the dense parts of ``repro.models.transformer``.  Prefill
always fuses ln2's rms divide into the attention-out matmul's epilogue
(``rms_div(wo_out + residual)``, keeping the pre-norm residual stream):
the reference fuses it whenever the norm and attn_proj sites share a
backend, and the port has one dispatch path.  Decode does not fuse
ln2 (``block_decode`` calls :func:`apply_norm`), as the reference.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (apply_norm, attention,
                                       attention_params, decode_attention,
                                       dense, mlp, mlp_params, norm_params,
                                       rope)
from repro_torch.models.params import P

__all__ = ["block_params", "block_apply", "block_decode", "cache_len",
           "attn_cache_specs"]


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
