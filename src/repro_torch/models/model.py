"""Model API of the port: the decoder families dense and moe, the
hybrid family (Jamba), the ssm family (xLSTM), the encdec family (the
Whisper backbone) and the vlm family (the LLaVA-NeXT backbone).

The port of every family's path of ``repro.models.model.Model``:

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
entry per layer (the hybrid family: per superblock of ``attn_every``
layers, each a dict of ``"slot{s}"`` subtrees; the ssm family: per
layer ``{"ln", "mlstm" | "slstm"}``).  ``cache["pos"]`` is a
0-dim int32 tensor on the cache's device, which ``decode_step`` advances
in place: the step reads nothing back to the host, so an engine can
capture it in a CUDA graph (``serve/compiled.py``).

The dense family's two block kinds: rms norms with the silu-gated MLP
(h2o_danube_1_8b, minicpm_2b, yi_6b), and LN (scale and bias) with the
ungated gelu MLP (starcoder2_7b); ``cfg.norm`` picks the norm of every
block and of the final norm, ``cfg.act`` the MLP.  The moe family
(qwen3_moe_235b_a22b, llama4_scout_17b_a16e) has rms blocks whose FFN is
the single-device MoE layer (``models/moe.py``) on every layer.  The
hybrid family (jamba_1_5_large_398b) stacks superblocks of Mamba mixers
and one attention slot (``models/hybrid.py``, ``models/mamba.py``); its
decode cache holds each Mamba slot's state beside the attention slot's
ring, so it serves through the lockstep engine only: ``decode_paged``
and the paged cache raise ``ValueError``, as the reference's.  So does
the ssm family (xlstm_350m: mLSTM layers with sLSTM layers at
``cfg.slstm_at``, ``models/xlstm.py``), each layer ``x + mixer(ln(x))``;
its cache holds every layer's recurrent state and no slot positions
(the reference's ``cache_specs`` pops ``slots``).  The encdec family
(whisper_medium) runs a bidirectional encoder over the batch's
precomputed frame embeddings (``batch["enc_embeds"]`` [B, frontend_seq,
1024]; the audio frontend is a stub, as the reference's): an exact f32
adapter product plus ``enc_pos``, ``n_encoder_layers`` LN blocks,
``enc_final_norm``.  Its decoder blocks add a cross-attention slot over
the encoder's output, and its decode cache holds each layer's cross k/v
(``ck`` / ``cv``, every frame) beside the self-attention ring; prefill
keeps the cross k/v its cross-attention computed (the reference projects
``enc_out`` a second time: the same product, the same bits).  It serves
through neither engine (no engine carries ``enc_embeds``, as the
reference's): callers drive ``prefill`` and ``decode_step`` themselves;
the paged routes raise ``ValueError``, as the reference's.  The vlm
family (llava_next_34b) is the dense rms / silu decoder with a
projector ahead of it: a batch's precomputed patch embeddings
(``batch["patches"]`` [B, frontend_seq, 1024]; the vision tower is a
stub, as the reference's) go through two exact f32 products with the
tanh gelu between (``_project``) and are prepended to the token
embeddings, so positions, the ring and ``cache["pos"]`` count patches
and tokens together.  Its decode step is the dense one; the paged cache
and ``decode_paged`` take it on tokens, as the reference's; no engine
carries ``patches`` (the reference's neither), so callers drive
``prefill`` and ``decode_step``, as for encdec.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ops import MatmulTape, exact_einsum, matmul_tape
from repro_torch.device import resolve_device
from repro_torch.models import hybrid as hy
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import _MAXI32, apply_norm, dense, norm_params
from repro_torch.models.params import P, materialize
from repro_torch.models.transformer import (attn_cache_specs, block_apply,
                                            block_decode, block_decode_paged,
                                            block_params, cache_len,
                                            cross_positions,
                                            paged_attn_cache_specs,
                                            ring_slot)

__all__ = ["Model"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")
# the stub frontends' embedding width (the reference's ``_VIS_DIM``)
_VIS_DIM = 1024
_ACTS = ("silu", "gelu")
_NORMS = ("rms", "ln")


class Model:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in _FAMILIES:
            raise NotImplementedError(
                f"the port has the families {_FAMILIES}; {cfg.name} is "
                f"{cfg.family}")
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
        if cfg.family == "hybrid":
            blocks = [hy.superblock_params(cfg)
                      for _ in range(cfg.n_layers // cfg.attn_every)]
        elif cfg.family == "ssm":
            blocks = [xl.layer_params(cfg, kind)
                      for kind in self._xlstm_kinds()]
        else:
            blocks = [block_params(cfg, cross=cfg.family == "encdec")
                      for _ in range(cfg.n_layers)]
        specs = {
            "embed": P((V, D), "small"),
            "final_norm": norm_params(cfg),
            "blocks": blocks,
        }
        if not cfg.tie_embeddings:
            specs["lm_head"] = P((D, V))
        if cfg.family == "encdec":
            specs["adapter"] = P((_VIS_DIM, D))
            specs["enc_pos"] = P((cfg.frontend_seq, D), "small")
            specs["enc_final_norm"] = norm_params(cfg)
            specs["enc_blocks"] = [block_params(cfg)
                                   for _ in range(cfg.n_encoder_layers)]
        if cfg.family == "vlm":
            specs["projector"] = {"w1": P((_VIS_DIM, D)), "w2": P((D, D))}
        return specs

    def init(self, seed: int = 0, device=None):
        return materialize(self.param_specs(), seed, resolve_device(device),
                           self.cfg.param_dtype)

    def _xlstm_kinds(self) -> list:
        """Each layer's mixer: "slstm" at ``cfg.slstm_at``, else "mlstm"."""
        return ["slstm" if i in self.cfg.slstm_at else "mlstm"
                for i in range(self.cfg.n_layers)]

    def init_cache(self, batch: int, cache_n: int, device=None):
        dev = resolve_device(device)
        cfg = self.cfg
        if cfg.family == "ssm":
            # every layer's recurrent state; no slots (nothing is cached
            # by position, so ``cache_n`` sizes nothing)
            return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                    "layers": [xl.layer_init_cache(cfg, kind, batch, dev)
                               for kind in self._xlstm_kinds()]}
        if cfg.family == "hybrid":
            layers = [materialize(hy.superblock_cache_specs(cfg, batch,
                                                            cache_n), 0, dev)
                      for _ in range(cfg.n_layers // cfg.attn_every)]
        else:
            cross = cfg.frontend_seq if cfg.family == "encdec" else 0
            layers = [materialize(attn_cache_specs(cfg, batch, cache_n,
                                                   cross), 0, dev)
                      for _ in range(cfg.n_layers)]
        C = cache_len(self.cfg, cache_n)
        return {"pos": torch.zeros((), dtype=torch.int32, device=dev),
                "slots": torch.full((batch, C), _MAXI32, dtype=torch.int32,
                                    device=dev),
                "layers": layers}

    def _paged_family(self, what: str) -> None:
        fam = self.cfg.family
        if fam not in ("dense", "moe", "vlm"):
            state = "cross" if fam == "encdec" else "recurrent"
            raise ValueError(
                f"{what} need pure-attention decode; family {fam!r} "
                f"carries {state} state")

    def paged_cache_specs(self, n_pages: int, page_size: int) -> dict:
        """P-spec tree of the block-paged cache: one pool pair per layer."""
        self._paged_family("paged KV caches")
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
        remat = self._remat(remat)
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

    def _remat(self, remat=None) -> str:
        """``remat``, or ``cfg.remat`` where it is None, checked."""
        remat = self.cfg.remat if remat is None else remat
        if remat not in ("none", "block", "full"):
            raise ValueError(
                f"remat must be none | block | full, got {remat!r}")
        return remat

    def _encode(self, params, enc_embeds, remat=None):
        """The encdec family's encoder over precomputed frame embeddings
        [B, frontend_seq, 1024]: the exact f32 adapter product plus
        ``enc_pos`` in the config dtype, the bidirectional blocks (rope
        on the frames' positions), ``enc_final_norm``."""
        cfg = self.cfg
        x = exact_einsum("bse,ed->bsd", enc_embeds, params["adapter"])
        x = (x + params["enc_pos"].float()[None]).to(self.dtype)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        x = self._run_stack(params["enc_blocks"],
                            partial(_block_body, cfg=cfg, pos=pos,
                                    causal=False), x, remat)
        return apply_norm(x, params["enc_final_norm"], cfg)

    def _project(self, params, patches):
        """The vlm family's projector over precomputed patch embeddings
        [B, P, 1024]: ``gelu(patches @ w1) @ w2``, both products exact f32
        (TF32 off, ``device.set_exact_numerics``) with the tanh gelu
        between, as the reference's ``jax.nn.gelu``; cast to the config
        dtype."""
        pr = params["projector"]
        p = torch.nn.functional.gelu(
            exact_einsum("bpe,ed->bpd", patches, pr["w1"]),
            approximate="tanh")
        return exact_einsum("bpd,de->bpe", p, pr["w2"]).to(self.dtype)

    def _embed_batch(self, params, batch):
        """The stream a batch starts as: its token embeddings, a vlm
        batch's projected patches ahead of them."""
        x = self._embed(params, batch["tokens"])
        if self.cfg.family == "vlm":
            x = torch.cat([self._project(params, batch["patches"]), x], 1)
        return x

    def _cross(self, params, batch, remat=None) -> dict:
        """The encdec family's cross-attention inputs for the decoder
        blocks (``enc_out`` and its frame positions); none otherwise."""
        if self.cfg.family != "encdec":
            return {}
        enc_out = self._encode(params, batch["enc_embeds"], remat)
        return {"enc_out": enc_out, "enc_positions": torch.arange(
            enc_out.shape[1], dtype=torch.int32, device=enc_out.device)}

    def forward(self, params, batch, remat=None):
        """Logits [B, S, V] f32 at every position of ``batch["tokens"]``
        (an encdec batch also carries ``enc_embeds``; a vlm batch carries
        ``patches``, whose positions come first: S counts them)."""
        cfg = self.cfg
        remat = self._remat(remat)
        x = self._embed_batch(params, batch)
        pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        kw = self._cross(params, batch, remat)
        stack_remat = remat
        if cfg.family == "hybrid":  # each slot checkpointed in its block
            body = partial(_superblock_body, remat=remat)
        elif cfg.family == "ssm":
            # a layer recomputes everything at any remat but "none" (the
            # reference's ``nothing_saveable`` on each ssm layer): no tape
            body = _xlstm_body
            stack_remat = "none" if remat == "none" else "block"
        else:
            body = _block_body
        x = self._run_stack(params["blocks"],
                            partial(body, cfg=cfg, pos=pos, **kw),
                            x, stack_remat)
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

        ``batch["tokens"]``: [B, S] integer tensor (an encdec batch also
        carries ``enc_embeds``, a vlm batch ``patches``, which come first:
        S, the slots and ``pos`` count them).  Returns (last-position
        logits [B, V] f32, cache); k/v land in (ring) cache buffers, an
        encdec layer's cross k/v whole in ``ck`` / ``cv``.
        """
        cfg = self.cfg
        x = self._embed_batch(params, batch)
        B, S = x.shape[:2]
        dev = x.device
        if cfg.family == "ssm":
            return self._xlstm_prefill(params, x)
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
        cross = self._cross(params, batch, "none")
        for lp in params["blocks"]:
            if cfg.family == "hybrid":
                x, lc = hy.superblock_prefill(x, lp, cfg, pos, to_ring,
                                              self.dtype)
                cache["layers"].append(lc)
                continue
            x, kv = block_apply(x, lp, cfg, pos, **cross)
            lc = {"k": to_ring(kv[0]).to(self.dtype),
                  "v": to_ring(kv[1]).to(self.dtype)}
            if cross:  # the cross k/v of every frame, as computed
                lc["ck"], lc["cv"] = kv[2].to(self.dtype), kv[3].to(
                    self.dtype)
            cache["layers"].append(lc)
        x = apply_norm(x[:, -1:], params["final_norm"], cfg)
        return self._logits(params, x)[:, 0], cache

    def _xlstm_prefill(self, params, x):
        """The ssm family's prefill: each layer's full-sequence mixer, its
        final state the layer's cache."""
        cfg = self.cfg
        cache = {"pos": torch.tensor(x.shape[1], dtype=torch.int32,
                                     device=x.device), "layers": []}
        for lp in params["blocks"]:
            x, state = xl.layer_apply(x, lp, cfg)
            cache["layers"].append(state)
        x = apply_norm(x[:, -1:], params["final_norm"], cfg)
        return self._logits(params, x)[:, 0], cache

    def decode_step(self, params, tokens, cache):
        """tokens: [B] integer tensor -> (logits [B, V] f32, cache).

        Updates the cache in place (k/v ring slots and slot positions, or
        the ssm family's recurrent state) and advances the ``cache["pos"]``
        tensor in place; reads nothing back to the host.
        """
        cfg = self.cfg
        pos = cache["pos"]
        x = self._embed(params, tokens[:, None])[:, 0]
        slots = cache.get("slots")
        if slots is not None:
            slots.index_copy_(1, ring_slot(pos, slots.shape[1]),
                              pos.expand(slots.shape[0], 1))
        xpos = None
        if cfg.family == "encdec":  # one set for every layer's cross slot
            xpos = cross_positions(x.shape[0],
                                   cache["layers"][0]["ck"].shape[1], x.device)
        for lp, lc in zip(params["blocks"], cache["layers"]):
            if cfg.family == "ssm":
                x = xl.layer_decode(x, lp, lc, cfg)
            elif cfg.family == "hybrid":
                x, _ = hy.superblock_decode(x, lp, lc, slots, pos, cfg)
            else:
                x, _ = block_decode(x, lp, lc, slots, pos, cfg,
                                    cfg.n_experts > 0, xpos)
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
        The hybrid, ssm and encdec families raise ``ValueError`` (their
        recurrent or cross state is not paged), as the reference; the vlm
        family runs on tokens (its decode is the dense one).
        """
        self._paged_family("paged decode steps")
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


def _block_body(x, lp, *, cfg: ModelConfig, pos, **kw):
    """One block of the full-sequence forward, without its KV (``kw``:
    an encdec block's ``enc_out`` / ``enc_positions``, an encoder
    block's ``causal=False``)."""
    return block_apply(x, lp, cfg, pos, **kw)[0]


def _superblock_body(x, lp, *, cfg: ModelConfig, pos, remat: str):
    """One hybrid superblock of the full-sequence forward."""
    return hy.superblock_apply(x, lp, cfg, pos, remat)


def _xlstm_body(x, lp, *, cfg: ModelConfig, pos):
    """One xLSTM layer of the full-sequence forward, without its state."""
    return xl.layer_apply(x, lp, cfg)[0]
