"""Model API of the port, dense decoder family.

The port of the dense path of ``repro.models.model.Model``:

  * ``param_specs()`` / ``init(seed, device)`` -- one source of truth for
    shapes and init (models/params.py);
  * ``init_cache(batch, cache_n, device)`` -- an empty decode cache;
  * ``prefill(params, batch, cache_n)`` -- last-position logits and a
    filled (ring) decode cache;
  * ``decode_step(params, tokens, cache)`` -- one-token serve step;
  * ``init_paged_cache(n_pages, page_size, device)`` -- an empty
    block-paged KV pool per layer;
  * ``decode_paged(params, tokens, cache, page_table, offsets, n_valid)``
    -- the continuous engine's step: a decode tick or a prefill chunk.

Params and caches are dicts; ``blocks``/``layers`` are lists with one
entry per layer.  ``cache["pos"]`` is a Python int.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.layers import _MAXI32, apply_norm, dense, norm_params
from repro_torch.models.params import P, materialize
from repro_torch.models.transformer import (attn_cache_specs, block_apply,
                                            block_decode, block_decode_paged,
                                            block_params, cache_len,
                                            paged_attn_cache_specs)

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port serves the dense family; {cfg.name} is {cfg.family}")
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> dict:
        cfg = self.cfg
        D, V = cfg.d_model, cfg.padded_vocab
        specs = {
            "embed": P((V, D), "small"),
            "final_norm": norm_params(cfg),
            "blocks": [block_params(cfg) for _ in range(cfg.n_layers)],
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = P((D, V))
        return specs

    def init(self, seed: int = 0, device=None):
        return materialize(self.param_specs(), seed, resolve_device(device),
                           self.cfg.param_dtype)

    def init_cache(self, batch: int, cache_n: int, device=None):
        dev = resolve_device(device)
        layers = [materialize(attn_cache_specs(self.cfg, batch, cache_n), 0,
                              dev) for _ in range(self.cfg.n_layers)]
        C = cache_len(self.cfg, cache_n)
        return {"pos": 0,
                "slots": torch.full((batch, C), _MAXI32, dtype=torch.int32,
                                    device=dev),
                "layers": layers}

    def paged_cache_specs(self, n_pages: int, page_size: int) -> dict:
        """P-spec tree of the block-paged cache: one pool pair per layer."""
        return {"layers": [paged_attn_cache_specs(self.cfg, n_pages, page_size)
                           for _ in range(self.cfg.n_layers)]}

    def init_paged_cache(self, n_pages: int, page_size: int, device=None):
        return materialize(self.paged_cache_specs(n_pages, page_size), 0,
                           resolve_device(device))

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, params, tokens):
        return params["embed"][tokens.long()].to(self.dtype)

    def _logits(self, params, x):
        cfg = self.cfg
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return dense(x, head.to(x.dtype), cfg.approx, "logits").float()

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def prefill(self, params, batch, cache_n: int):
        """Full-sequence forward that also fills a decode cache.

        ``batch["tokens"]``: [B, S] integer tensor.  Returns (last-position
        logits [B, V] f32, cache); k/v land in (ring) cache buffers.
        """
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        C = cache_len(cfg, cache_n)
        ring = (torch.arange(C, device=dev) + (S - C)) % C if C < S else None

        def to_ring(kv):  # [B, S, KV, hd] -> [B, C, KV, hd]
            if ring is None:
                return torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, C - S))
            out = torch.zeros((B, C) + kv.shape[2:], dtype=kv.dtype, device=dev)
            out[:, ring] = kv[:, S - C:]
            return out

        if ring is None:
            base = torch.arange(C, dtype=torch.int32, device=dev)
            base = torch.where(base < S, base, _MAXI32)
        else:
            base = torch.zeros((C,), dtype=torch.int32, device=dev)
            base[ring] = torch.arange(S - C, S, dtype=torch.int32, device=dev)
        cache = {"pos": S, "slots": base.expand(B, C).contiguous(),
                 "layers": []}
        for lp in params["blocks"]:
            x, (k, v) = block_apply(x, lp, cfg, pos)
            cache["layers"].append({"k": to_ring(k).to(self.dtype),
                                    "v": to_ring(v).to(self.dtype)})
        x = apply_norm(x[:, -1:], params["final_norm"], cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_step(self, params, tokens, cache):
        """tokens: [B] integer tensor -> (logits [B, V] f32, cache).

        Updates the cache in place (k/v ring slots, slot positions) and
        advances ``cache["pos"]``.
        """
        pos = cache["pos"]
        x = self._embed(params, tokens[:, None])[:, 0]
        slots = cache["slots"]
        slots[:, pos % slots.shape[1]] = pos
        for lp, lc in zip(params["blocks"], cache["layers"]):
            x, _ = block_decode(x, lp, lc, slots, pos, self.cfg)
        cache["pos"] = pos + 1
        x = apply_norm(x[:, None], params["final_norm"], self.cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_paged(self, params, tokens, cache, page_table, offsets,
                     n_valid):
        """Paged multi-token step for continuous batching.

        One function serves both engine phases: the decode tick
        (``tokens`` [n_slots, 1], every live slot advances one token at
        its own depth) and a chunked-prefill tick (``tokens`` [1, S], one
        slot absorbs a prompt chunk).  ``page_table`` [B, P] int32;
        ``offsets`` [B] int32 is each slot's stored-KV length before this
        call, ``n_valid`` [B] int32 how many of the S tokens are real (0 =
        slot inactive: its writes go to the scratch page and its logits
        are garbage).  The pools are written in place.

        Returns (logits [B, V] f32 at each row's last valid token, cache).
        """
        B, S = tokens.shape
        dev = tokens.device
        x = self._embed(params, tokens)
        steps = torch.arange(S, dtype=torch.int32, device=dev)
        positions = offsets[:, None] + steps[None]
        valid = steps[None] < n_valid[:, None]
        kv_len = offsets + n_valid
        for lp, lc in zip(params["blocks"], cache["layers"]):
            x, _ = block_decode_paged(x, lp, lc, page_table, positions,
                                      valid, kv_len, self.cfg)
        x = apply_norm(x, params["final_norm"], self.cfg)
        last = torch.clamp(n_valid - 1, 0, S - 1).long()
        xl = x[torch.arange(B, device=dev), last][:, None]
        return self._logits(params, xl)[:, 0], cache
