"""Model API of the port, dense decoder family.

The port of the dense path of ``repro.models.model.Model``:

  * ``param_specs()`` / ``init(seed, device)`` -- one source of truth for
    shapes and init (models/params.py);
  * ``loss_fn(params, batch)`` -- the training objective (masked mean
    next-token cross entropy);
  * ``forward(params, batch)`` -- full-sequence logits;
  * ``init_cache(batch, cache_n, device)`` -- an empty decode cache;
  * ``prefill(params, batch, cache_n)`` -- last-position logits and a
    filled (ring) decode cache;
  * ``decode_step(params, tokens, cache)`` -- one-token serve step;
  * ``init_paged_cache(n_pages, page_size, device)`` -- an empty
    block-paged KV pool per layer;
  * ``decode_paged(params, tokens, cache, page_table, offsets, n_valid)``
    -- the continuous engine's step: a decode tick or a prefill chunk.

Params and caches are dicts; ``blocks``/``layers`` are lists with one
entry per layer.  ``cache["pos"]`` is a 0-dim int32 tensor on the
cache's device, which ``decode_step`` advances in place: the step reads
nothing back to the host, so an engine can capture it in a CUDA graph
(``serve/compiled.py``).

The dense family's two block kinds: rms norms with the silu-gated MLP
(h2o_danube_1_8b, minicpm_2b, yi_6b), and LN (scale and bias) with the
ungated gelu MLP (starcoder2_7b); ``cfg.norm`` picks the norm of every
block and of the final norm, ``cfg.act`` the MLP.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import MatmulTape, matmul_tape
from repro_torch.device import resolve_device
from repro_torch.models.layers import _MAXI32, apply_norm, dense, norm_params
from repro_torch.models.params import P, materialize
from repro_torch.models.transformer import (attn_cache_specs, block_apply,
                                            block_decode, block_decode_paged,
                                            block_params, cache_len,
                                            paged_attn_cache_specs,
                                            ring_slot)

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_ACTS = ("silu", "gelu")
_NORMS = ("rms", "ln")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"the port serves the dense family; {cfg.name} is {cfg.family}")
        # the dense blocks the port has: rms or LN, the silu-gated or the
        # ungated gelu MLP; anything else would build another model than
        # the reference's
        for field, value, ported in (("act", cfg.act, _ACTS),
                                     ("norm", cfg.norm, _NORMS)):
            if value not in ported:
                raise NotImplementedError(
                    f"{cfg.name}: {field}={value!r} is not ported (the port "
                    f"has {field} in {ported})")
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
            "blocks": [block_params(cfg)
                       for _ in range(cfg.n_layers)],
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
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
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
    # full-sequence forward (training / eval)
    # ------------------------------------------------------------------
    def _run_stack(self, blocks, body, x, remat=None):
        """``x = body(x, lp)`` for each layer's params ``lp``.

        ``remat`` (default ``cfg.remat``): ``"none"`` keeps every
        activation for the backward; ``"block"`` runs each block under
        ``torch.utils.checkpoint`` (non-reentrant), which keeps only the
        block's input and recomputes the block -- its K1/K2/K3 launches
        included -- during the backward (the reference's
        ``nothing_saveable``); ``"full"`` does the same but records the
        outputs of the block's :func:`~repro_torch.core.ops.qmatmul`
        calls on a :class:`~repro_torch.core.ops.MatmulTape` and replays
        them in the recompute, so only the cheap non-matmul ops run
        twice (the reference's ``dots_with_no_batch_dims_saveable``: the
        attention einsums, which carry batch dims, are recomputed).
        """
        remat = self.cfg.remat if remat is None else remat
        if remat not in ("none", "block", "full"):
            raise ValueError(f"remat must be none | block | full, got {remat!r}")
        for lp in blocks:
            if remat == "none":
                x = body(x, lp)
                continue
            kw = {}
            if remat == "full":
                tape = MatmulTape()
                kw["context_fn"] = lambda tape=tape: (
                    matmul_tape(tape, replay=False),
                    matmul_tape(tape, replay=True))
            x = checkpoint(body, x, lp, use_reentrant=False, **kw)
        return x

    def forward(self, params, batch, remat=None):
        """Logits [B, S, V] f32 at every position of ``batch["tokens"]``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                           device=tokens.device)
        x = self._run_stack(params["blocks"],
                            partial(_block_body, cfg=cfg, pos=pos), x, remat)
        x = apply_norm(x, params["final_norm"], cfg)
        return self._logits(params, x)

    def loss_fn(self, params, batch, remat=None):
        """Mean next-token cross entropy over positions with target >= 0."""
        logits = self.forward(params, batch, remat)
        tgt = batch["targets"]
        logits = logits[:, -tgt.shape[1]:]
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              torch.clamp_min(tgt, 0).long()[..., None])[..., 0]
        mask = (tgt >= 0).float()
        return ((lse - picked) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)

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
        cache = {"pos": torch.tensor(S, dtype=torch.int32, device=dev),
                 "slots": base.expand(B, C).contiguous(), "layers": []}
        for lp in params["blocks"]:
            x, (k, v) = block_apply(x, lp, cfg, pos)
            cache["layers"].append({"k": to_ring(k).to(self.dtype),
                                    "v": to_ring(v).to(self.dtype)})
        x = apply_norm(x[:, -1:], params["final_norm"], cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_step(self, params, tokens, cache):
        """tokens: [B] integer tensor -> (logits [B, V] f32, cache).

        Updates the cache in place (k/v ring slots, slot positions) and
        advances the ``cache["pos"]`` tensor in place; reads nothing back
        to the host.
        """
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed(params, tokens[:, None])[:, 0]
        slots = cache["slots"]
        slots.index_copy_(1, ring_slot(pos, slots.shape[1]),
                          pos.expand(slots.shape[0], 1))
        for lp, lc in zip(params["blocks"], cache["layers"]):
            x, _ = block_decode(x, lp, lc, slots, pos, cfg)
        pos.add_(1)
        x = apply_norm(x[:, None], params["final_norm"], cfg)
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


def _block_body(x, lp, *, cfg: ModelConfig, pos):
    """One block of the full-sequence forward, without its KV."""
    return block_apply(x, lp, cfg, pos)[0]
