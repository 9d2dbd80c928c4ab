"""Training loop with fault tolerance: checkpoint/restart, preemption
handling, straggler detection, loss-spike guard.

The port of ``repro.train.loop``:

  * **Checkpoint/restart** -- periodic and final checkpoints through the
    atomic :class:`~repro_torch.ckpt.checkpoint.CheckpointManager`;
    resume restores step, params and optimizer state, and the data
    cursor is the step (the pipeline is addressable by step);
  * **Preemption** -- SIGTERM/SIGINT set a flag read at step boundaries:
    a final checkpoint is written and the loop exits cleanly;
  * **Straggler detection** -- per-step wall times feed an EWMA; a step
    slower than ``straggler_factor`` x the EWMA is logged with its id;
  * **Loss-spike guard** -- a step whose loss exceeds ``spike_factor`` x
    the running median is re-run once from the previous params, then
    accepted.  The port's step updates params in place, so the loop
    runs it in two halves (:class:`~repro_torch.train.trainstep.TrainStep`):
    the spike is judged before the update, and the re-run starts from
    the same, untouched params -- the reference's semantics without a
    copy of params and state.

Step times are host-clock times around a whole step, update included,
ending in a device sync.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.models.params import tree_leaves

__all__ = ["LoopConfig", "LoopState", "train_loop", "DEFAULT_CKPT_DIR"]

# inside the checkout's build directory (listed in .gitignore)
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = DEFAULT_CKPT_DIR
    keep: int = 3
    straggler_factor: float = 3.0
    spike_factor: float = 5.0
    resume: bool = True


@dataclass
class LoopState:
    step: int = 0
    ewma_s: Optional[float] = None
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    step_s: list = field(default_factory=list)
    stragglers: list = field(default_factory=list)
    respun_steps: list = field(default_factory=list)


def train_loop(train_step, params, opt_state, data_source, lc: LoopConfig,
               batch_transform: Callable = lambda b: b,
               metrics_cb: Optional[Callable] = None) -> LoopState:
    """Run the loop; returns the final LoopState.  ``train_step`` is a
    :class:`~repro_torch.train.trainstep.TrainStep`."""
    mgr = CheckpointManager(lc.ckpt_dir, keep=lc.keep)
    state = LoopState()

    if lc.resume and mgr.latest_step() is not None:
        step, params, opt_state, _ = mgr.restore(None, params, opt_state)
        state.step = step
        print(f"[loop] resumed from checkpoint step {step}")

    stop = {"flag": False}

    def _on_term(sig, frame):
        stop["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_term)
        except ValueError:  # not the main thread (tests)
            pass

    try:
        while state.step < lc.total_steps and not stop["flag"]:
            t0 = time.time()
            batch = batch_transform(data_source.batch_at(state.step))
            loss_t, grads = train_step.loss_and_grads(params, batch)
            loss = float(loss_t)

            # loss-spike guard: re-run once from the same params
            med = float(np.median(state.losses[-32:])) if state.losses else loss
            if (np.isfinite(med) and loss > lc.spike_factor * max(med, 1e-6)
                    and state.step not in state.respun_steps):
                state.respun_steps.append(state.step)
                loss_t, grads = train_step.loss_and_grads(params, batch)
                loss = float(loss_t)
            params, opt_state, metrics = train_step.apply(
                params, opt_state, loss_t, grads, state.step)
            del grads
            _sync(params)
            state.losses.append(loss)
            state.grad_norms.append(float(metrics["grad_norm"]))

            dt = time.time() - t0
            state.step_s.append(dt)
            if state.ewma_s is not None and dt > lc.straggler_factor * state.ewma_s:
                state.stragglers.append((state.step, dt))
                print(f"[loop] straggler step {state.step}: {dt:.2f}s "
                      f"(ewma {state.ewma_s:.2f}s)")
            state.ewma_s = dt if state.ewma_s is None else (
                0.9 * state.ewma_s + 0.1 * dt)

            if metrics_cb:
                metrics_cb(state.step, metrics)
            if lc.log_every and state.step % lc.log_every == 0:
                print(f"[loop] step {state.step} loss {loss:.4f} "
                      f"gnorm {state.grad_norms[-1]:.3f} {dt * 1e3:.0f}ms")

            state.step += 1
            if lc.ckpt_every and state.step % lc.ckpt_every == 0:
                mgr.save(state.step, params, opt_state,
                         extra={"data_cursor": state.step})

        if stop["flag"]:
            print(f"[loop] preemption at step {state.step}: checkpointing")
        mgr.save(state.step, params, opt_state,
                 extra={"data_cursor": state.step, "preempted": stop["flag"]})
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return state


def _sync(params) -> None:
    """Wait for the card (if the params live on one) to finish the step."""
    leaves = tree_leaves(params)
    if leaves and leaves[0].is_cuda:
        torch.cuda.synchronize(leaves[0].device)
