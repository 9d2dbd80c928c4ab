"""Continuous-batching serve engine: request queue + paged KV + streaming.

The port of ``repro.serve.scheduler``.  The fixed-slot
:class:`~repro_torch.serve.engine.ServeEngine` prefills a batch together
and decodes it in lockstep: a finished sequence burns its slot until the
whole batch drains, and cache memory is ``B * cache_n`` however short
the requests are.  This engine keeps every decode slot busy instead:

  * requests queue in FCFS order and are *admitted* into any free slot
    the moment the page allocator can cover their worst case
    (``len(prompt) + max_new`` tokens of KV);
  * prompts prefill in fixed-size chunks *interleaved* with decode
    ticks, so long prompts never stall ongoing generations;
  * KV lives in a block-paged pool (:mod:`repro_torch.serve.paged_kv`)
    addressed through per-slot page tables: memory scales with live
    tokens;
  * finished requests free their pages and slot at once (slot
    recycling) and their tokens stream out per request as
    :class:`StreamEvent`\\ s.

Both phases run ``Model.decode_paged`` at fixed shapes: the decode tick
``[n_slots, 1]`` with an occupancy mask (``n_valid``), the prefill tick
``[1, prefill_chunk]``.  On the card the decode tick's attention is
kernel K4 (one position per slot) and the prefill tick's combine divide
is kernel K5.  Each phase is compiled, as the reference jits it
(:mod:`repro_torch.serve.compiled`): on the card one CUDA graph each,
captured on its first tick and replayed after, with the tick's numpy
``tokens``, ``page_table``, ``offsets`` and ``n_valid`` copied into the
graph's static device tensors.  ``trace_counts`` counts the captures
(traces on the CPU) with the reference's meaning: ``{"decode": 1,
"prefill": 1}`` after any drain.  Sampling stays on the host, outside
the graphs.  ``cuda_graphs=False`` keeps the card's ticks eager.

Sampling: request ``rid`` draws from its own ``torch.Generator``, seeded
from ``(seed, rid)`` as the lockstep engine seeds request ``i`` from
``(seed, i)``, so its sampled tokens are deterministic and do not depend
on which requests share the batch.  Torch cannot reproduce the
reference's ``fold_in`` keys, so sampled tokens differ from the
reference's; greedy tokens do not.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.serve.compiled import CompiledStep
from repro_torch.serve.paged_kv import PageAllocator, PageGeometry

__all__ = ["StreamEvent", "ContinuousServeEngine"]


@dataclass(frozen=True)
class StreamEvent:
    """One streamed output: a token for ``rid``, and/or its completion.

    ``token`` is None on a pure completion event (stop token seen -- the
    stop token itself is never emitted).
    """

    rid: int
    token: Optional[int]
    done: bool


@dataclass
class _Queued:
    rid: int
    prompt: List[int]
    max_new: int
    stop_token: Optional[int]


@dataclass
class _Slot:
    rid: int
    prompt: List[int]
    max_new: int
    stop_token: Optional[int]
    pages: List[int]
    generator: torch.Generator
    n_prefilled: int = 0
    length: int = 0                    # KV tokens stored for this slot
    last_token: Optional[int] = None   # pending token to feed to decode
    n_generated: int = 0
    out: List[int] = field(default_factory=list)


class ContinuousServeEngine:
    """Continuous-batching engine over a block-paged KV cache.

    ``max_len`` bounds one request's total tokens (prompt + generated)
    and fixes the per-slot page-table width; ``n_pages`` sizes the
    shared pool (default: every slot can be full at once -- the peak KV
    memory of a fixed-slot engine with ``cache_n == max_len``, but
    shorter requests leave their pages to others).  The pools live on
    the device of ``params``.
    """

    def __init__(self, model: Model, params: dict, n_slots: int = 4,
                 max_len: int = 256, page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 cuda_graphs: bool = True):
        if model.cfg.family != "dense":
            raise ValueError(
                "continuous batching serves decoder-only text families "
                f"(the port has dense); got {model.cfg.family!r}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.prefill_chunk = prefill_chunk
        self.temperature = temperature
        self.seed = seed

        pages_per_slot = -(-max_len // page_size)
        if n_pages is None:
            n_pages = n_slots * pages_per_slot + 1  # + scratch page
        self.geom = PageGeometry(page_size, n_pages, pages_per_slot)
        self.alloc = PageAllocator(self.geom)
        self.page_table = np.zeros((n_slots, pages_per_slot), np.int32)
        self.cache = model.init_paged_cache(n_pages, page_size, self.device)

        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * n_slots
        self._next_rid = 0
        # each phase traced (captured) once, as the reference's jit
        self.trace_counts = {"decode": 0, "prefill": 0}
        self._steps = {phase: CompiledStep(phase, self.trace_counts,
                                           self.device, cuda_graphs)
                       for phase in ("decode", "prefill")}

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new: int = 32,
               stop_token: Optional[int] = None) -> int:
        """Queue a request; returns its rid.  Admission happens inside
        :meth:`step` as soon as a slot and enough pages free up."""
        total = len(prompt) + max_new
        if not prompt or max_new < 1:
            raise ValueError(
                f"need a non-empty prompt ({len(prompt)}) and max_new >= 1 "
                f"({max_new})")
        if total > self.geom.slot_capacity:
            raise ValueError(
                f"prompt length {len(prompt)} + max_new {max_new} = {total} "
                f"exceeds slot capacity {self.geom.slot_capacity} "
                f"({self.geom.pages_per_slot} pages x {self.geom.page_size})")
        if self.geom.pages_for(total) > self.geom.usable_pages:
            raise ValueError(
                f"request needs {self.geom.pages_for(total)} pages; pool "
                f"has only {self.geom.usable_pages} usable pages")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Queued(rid, list(prompt), max_new, stop_token))
        return rid

    def cancel(self, rid: int) -> bool:
        """Evict a queued or running request; frees its slot and pages."""
        for i, q in enumerate(self._queue):
            if q.rid == rid:
                del self._queue[i]
                return True
        for b, s in enumerate(self._slots):
            if s is not None and s.rid == rid:
                self._evict(b)
                return True
        return False

    @property
    def pending(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @property
    def n_queued(self) -> int:
        """Requests submitted and not yet admitted to a slot."""
        return len(self._queue)

    @property
    def n_live_tokens(self) -> int:
        return sum(s.length for s in self._slots if s is not None)

    def _evict(self, b: int) -> None:
        self.alloc.free(self._slots[b].pages)
        self.page_table[b, :] = 0
        self._slots[b] = None

    def _admit(self) -> None:
        """FCFS admission: the head of the queue waits for a slot and its
        pages (no skip-ahead, so a big request cannot starve)."""
        for b in range(self.n_slots):
            if not self._queue or self._slots[b] is not None:
                continue
            req = self._queue[0]
            pages = self.alloc.alloc(
                self.geom.pages_for(len(req.prompt) + req.max_new))
            if pages is None:
                break
            self._queue.popleft()
            self.page_table[b, :] = 0
            self.page_table[b, :len(pages)] = pages
            self._slots[b] = _Slot(req.rid, req.prompt, req.max_new,
                                   req.stop_token, pages,
                                   self._generator(req.rid))

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------
    def _generator(self, rid: int) -> torch.Generator:
        return torch.Generator().manual_seed(
            int(np.random.SeedSequence([self.seed, rid]).generate_state(1)[0]))

    def _sample(self, logits_row: torch.Tensor, slot: _Slot) -> int:
        if self.temperature <= 0.0:
            return int(logits_row.argmax())
        probs = torch.softmax(logits_row.float().cpu() / self.temperature, -1)
        return int(torch.multinomial(probs, 1, generator=slot.generator))

    def _emit(self, b: int, tok: int, events: List[StreamEvent]) -> None:
        slot = self._slots[b]
        if slot.stop_token is not None and tok == slot.stop_token:
            # the stop token ends the request without being emitted
            events.append(StreamEvent(slot.rid, None, True))
            self._evict(b)
            return
        slot.out.append(tok)
        slot.n_generated += 1
        done = slot.n_generated >= slot.max_new
        events.append(StreamEvent(slot.rid, tok, done))
        if done:
            self._evict(b)
        else:
            slot.last_token = tok

    # ------------------------------------------------------------------
    # engine loop
    # ------------------------------------------------------------------
    def _tick(self, tokens, page_table, offsets, n_valid) -> torch.Tensor:
        return self.model.decode_paged(self.params, tokens, self.cache,
                                       page_table, offsets, n_valid)[0]

    def _run(self, phase: str, tokens, page_table, offsets,
             n_valid) -> torch.Tensor:
        """One ``phase`` tick on numpy inputs; the logits stay valid until
        the phase's next tick."""
        return self._steps[phase](self._tick, *map(
            torch.from_numpy, (tokens, page_table, offsets, n_valid)))

    def step(self) -> List[StreamEvent]:
        """One engine tick: admit, one prefill chunk, one decode step."""
        events: List[StreamEvent] = []
        self._admit()
        with torch.inference_mode():
            # chunked prefill, interleaved: the oldest admitted slot with
            # an unfinished prompt absorbs one fixed-shape chunk per tick
            pf = [(b, s) for b, s in enumerate(self._slots)
                  if s is not None and s.n_prefilled < len(s.prompt)]
            if pf:
                b, slot = pf[0]
                CK = self.prefill_chunk
                chunk = slot.prompt[slot.n_prefilled:slot.n_prefilled + CK]
                toks = np.zeros((1, CK), np.int32)
                toks[0, :len(chunk)] = chunk
                logits = self._run("prefill", toks,
                                   self.page_table[b:b + 1],
                                   np.array([slot.length], np.int32),
                                   np.array([len(chunk)], np.int32))
                slot.n_prefilled += len(chunk)
                slot.length += len(chunk)
                if slot.n_prefilled == len(slot.prompt):
                    self._emit(b, self._sample(logits[0], slot), events)

            # one decode tick across every slot with a pending token
            tokens = np.zeros((self.n_slots, 1), np.int32)
            offsets = np.zeros((self.n_slots,), np.int32)
            n_valid = np.zeros((self.n_slots,), np.int32)
            live = []
            for b, s in enumerate(self._slots):
                if s is not None and s.last_token is not None:
                    tokens[b, 0] = s.last_token
                    offsets[b] = s.length
                    n_valid[b] = 1
                    live.append(b)
            if live:
                logits = self._run("decode", tokens, self.page_table,
                                   offsets, n_valid)
                for b in live:
                    slot = self._slots[b]
                    slot.length += 1
                    slot.last_token = None
                    self._emit(b, self._sample(logits[b], slot), events)
        return events

    def stream(self, prompts: List[List[int]], max_new: int = 32,
               stop_token: Optional[int] = None) -> Iterator[StreamEvent]:
        """Submit ``prompts`` and yield events until the engine drains."""
        for p in prompts:
            self.submit(p, max_new, stop_token)
        while self.pending:
            yield from self.step()

    def generate(self, prompts: List[List[int]], max_new: int = 32,
                 stop_token: Optional[int] = None) -> List[List[int]]:
        """Drain helper with the fixed-slot engine's signature."""
        rids = [self.submit(p, max_new, stop_token) for p in prompts]
        outs = {r: [] for r in rids}
        while self.pending:
            for ev in self.step():
                if ev.token is not None and ev.rid in outs:
                    outs[ev.rid].append(ev.token)
        return [outs[r] for r in rids]
