"""Batched serving engine: prefill + decode with a fixed-slot batch.

The port of ``repro.serve.engine``.  Requests are left-padded to a
common length (uniform positions, as the reference), prefilled as one
batch, then decoded one token per step.  Greedy, or temperature
sampling with one ``torch.Generator`` per request: request ``i`` draws
from a generator seeded from ``(seed, i)``, so its tokens do not depend
on which requests share its batch.  Torch cannot reproduce the
reference's ``fold_in`` keys, so sampled tokens differ from the
reference's; greedy tokens do not.

The decode step is compiled, as the reference jits it
(:mod:`repro_torch.serve.compiled`): on the card it is one CUDA graph
per ``(B, cache_n)``, captured on the first ``generate`` of that shape
and replayed after.  A graph is bound to addresses, and ``Model.prefill``
builds a fresh cache each time, so the engine keeps one persistent cache
per shape and copies prefill's cache into it; two ``generate`` calls of
one shape capture once.  The prefill stays eager: its shape changes
with every prompt length, and a graph per length would be captured
more often than replayed.  It still counts a trace per new shape, as
the reference's jit would.  ``trace_counts`` counts both, with the
reference's meaning; ``cuda_graphs=False`` keeps the card's decode
eager (the yardstick the graph route is timed against).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.params import tree_items, tree_leaves
from repro_torch.serve.compiled import CompiledStep

__all__ = ["ServeEngine"]


@dataclass
class ServeEngine:
    model: Model
    params: dict
    cache_n: int = 256
    temperature: float = 0.0
    seed: int = 0
    cuda_graphs: bool = True

    def __post_init__(self):
        self.trace_counts = {"decode": 0, "prefill": 0}
        self._prefill = CompiledStep("prefill", self.trace_counts,
                                     self.device, graphs=False)
        self._decode = CompiledStep("decode", self.trace_counts, self.device,
                                    self.cuda_graphs)
        self._caches = {}  # (B, cache_n) -> the decode step's cache

    def _decode_cache(self, cache: dict) -> dict:
        """The persistent cache of ``cache``'s shape, holding a copy of
        every leaf of it (made outside inference mode: the graph writes it
        on every replay).  B is any layer leaf's first dim: an xLSTM cache
        has no ``slots``."""
        B = tree_leaves(cache["layers"])[0].shape[0]
        static = self._caches.get((B, self.cache_n))
        if static is None:
            with torch.inference_mode(False):
                static = self._caches[B, self.cache_n] = self.model.init_cache(
                    B, self.cache_n, self.device)
        # every leaf: the attention caches, a hybrid superblock's Mamba
        # states (h, conv) beside them, an xLSTM layer's recurrent state
        for (path, dst), (spath, src) in zip(tree_items(static),
                                             tree_items(cache)):
            assert path == spath, (path, spath)
            dst.copy_(src)
        return static

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def _generators(self, n: int) -> List[torch.Generator]:
        return [torch.Generator().manual_seed(
            int(np.random.SeedSequence([self.seed, i]).generate_state(1)[0]))
            for i in range(n)]

    def _sample(self, logits: torch.Tensor, gens) -> np.ndarray:
        """Next token of every request; host int32 [B]."""
        if self.temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        probs = torch.softmax(logits.float().cpu() / self.temperature, dim=-1)
        return np.array([int(torch.multinomial(probs[i], 1, generator=g))
                         for i, g in enumerate(gens)], np.int32)

    def generate(self, prompts: List[List[int]], max_new: int = 32,
                 stop_token: Optional[int] = None) -> List[List[int]]:
        """Pad prompts to a common length, prefill, decode max_new tokens.

        A sampled ``stop_token`` ends its request *without being
        emitted*: outputs never contain the stop token.
        """
        B = len(prompts)
        plen = max(len(p) for p in prompts)
        if plen + max_new > self.cache_n:
            raise ValueError(
                f"longest prompt ({plen} tokens) + max_new ({max_new}) = "
                f"{plen + max_new} exceeds cache_n ({self.cache_n})")
        toks = np.zeros((B, plen), np.int32)
        for i, p in enumerate(prompts):
            toks[i, plen - len(p):] = p  # left-pad (uniform positions)
        gens = self._generators(B)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        with torch.inference_mode():
            logits, cache = self._prefill(
                lambda t: self.model.prefill(self.params, {"tokens": t},
                                             self.cache_n), batch["tokens"])
            cache = self._decode_cache(cache)

            def decode(t):
                return self.model.decode_step(self.params, t, cache)[0]

            out = [[] for _ in range(B)]
            done = np.zeros(B, bool)
            tok = self._sample(logits, gens)
            for step in range(max_new):
                for i in range(B):
                    if not done[i]:
                        if stop_token is not None and tok[i] == stop_token:
                            done[i] = True
                        else:
                            out[i].append(int(tok[i]))
                if done.all() or step == max_new - 1:
                    break
                logits = self._decode(decode, torch.from_numpy(tok),
                                      key=self.cache_n)
                tok = self._sample(logits, gens)
        return out
