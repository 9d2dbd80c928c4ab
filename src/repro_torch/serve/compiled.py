"""Compiled engine steps: the port's counterpart of the reference's
``jax.jit`` and its trace counter.

The reference jits its engines' steps (``repro.serve.engine``,
``repro.serve.scheduler``) and counts every trace in ``trace_counts``.
A :class:`CompiledStep` does the same for one step of an engine: a step
function is traced (here: captured into a ``torch.cuda.CUDAGraph``) once
per input-shape key and replayed after that.

On the card, the first call with a new key

1. copies its inputs into static device tensors that the key owns (made
   outside ``torch.inference_mode``, so they are ordinary tensors);
2. runs the step once eagerly on a side stream, the warm-up: it builds
   every kernel library (``kernels/_build.py``), fills the device LUT
   caches, reads the card's geometry (``rapid::sm_count``, K4's
   compiled chunk) and sizes K4's ticket tensor, none of which a capture
   may do.  The warm-up is this call's execution: its result is the
   call's result, and its writes to the state (the KV caches, the
   position) are the step's;
3. captures the step into a graph on the same static inputs, counting
   one trace.  A capture runs nothing; the kernel launches it records
   (``kernels/_launch.recording_launches``) are counted once per replay,
   so the launch counters read as they would after eager steps.  The
   garbage collector runs just before and not during the capture: a
   dead engine's graph freed by a collection inside the capture would
   release its memory pool there (``cudaFree``), which invalidates the
   capture.

Every later call with that key copies its inputs into the static ones,
replays the graph and returns the static outputs, which the next replay
overwrites: read them before the next call.  A step must be a function
of its tensor inputs and of state at fixed device addresses (params,
caches written in place), with no host read of a device value (no
``.item()``; a capture turns one into an error).  A failed capture
raises: nothing falls back to the eager route.

On the CPU there is no graph: every call runs the step eagerly, and a
new key still counts one trace, so the CPU tests hold the reference's
counts.  ``graphs=False`` gives the card the same eager route (the
yardstick the graph route is timed against).
"""
from __future__ import annotations

import gc
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels._launch import recording_launches, replay_launches

__all__ = ["CompiledStep"]


class _Graph:
    """One key's captured step: its static inputs and outputs, the
    graph, and the launches its capture recorded."""

    def __init__(self, fn: Callable, inputs: Tuple[torch.Tensor, ...],
                 device: torch.device):
        with torch.inference_mode(False):
            self.inputs = tuple(torch.empty_like(t, device=device)
                                for t in inputs)
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn(*self.inputs)
        main.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        gc.collect()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with recording_launches() as self.launches:
                with torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
        finally:
            if gc_on:
                gc.enable()

    def replay(self, inputs: Tuple[torch.Tensor, ...]):
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        replay_launches(self.launches)
        return self.outputs


class CompiledStep:
    """One engine step, traced once per input-shape key.

    ``name`` is the step's entry in ``trace_counts`` (shared by an
    engine's steps, as the reference's dict); ``device`` the engine's;
    ``graphs`` False keeps the card on the eager route.  Call it as
    ``step(fn, *inputs, key=...)``: ``fn(*inputs)`` returns a tensor or a
    tuple of tensors; ``key`` adds what the shapes do not say (the state
    ``fn`` writes, for an engine that keeps one per shape).  ``fn`` runs
    only to warm up and capture a new key, or on every call when eager.
    """

    def __init__(self, name: str, trace_counts: Dict[str, int],
                 device: torch.device, graphs: bool = True):
        self.name = name
        self.trace_counts = trace_counts
        self.device = torch.device(device)
        self.graphs = graphs and self.device.type == "cuda"
        self._keys: Dict[tuple, object] = {}

    def __call__(self, fn: Callable, *inputs: torch.Tensor, key=()):
        full = (key,) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        entry = self._keys.get(full)
        if entry is None:
            self.trace_counts[self.name] += 1
            if self.graphs:
                entry = self._keys[full] = _Graph(fn, inputs, self.device)
                first, entry.first = entry.first, None
                return first
            self._keys[full] = True
        if not self.graphs:
            return fn(*(t.to(self.device) for t in inputs))
        return entry.replay(inputs)
