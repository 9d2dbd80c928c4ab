"""Optimizers (AdamW, Adafactor) and LR schedules over a param tree.

The port of ``repro.train.optimizer``: plain functions over the nested
dict / list param tree, with the reference's formulas -- its global
gradient norm, its ``grad_clip / (gnorm + 1e-9)`` clip scale, AdamW's
bias corrections inside the step and eps outside the square root
(``torch.optim.AdamW`` places them otherwise), Adafactor's factored
second moment.  Optimizer state mirrors the param tree leaf for leaf.

The update runs **in place**: params and moments are overwritten leaf
by leaf under ``torch.no_grad()``, so a step needs no second copy of
the params (7.4 GB of f32 at h2o_danube_1_8b's width); the reference,
functional, returns new trees.  The gradients are consumed (scaled in
place) too.  Moments and the update math stay exact f32: only the
model's datapath is approximated.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List

import numpy as np
import torch

from repro_torch.models.params import tree_leaves, tree_map

__all__ = ["OptConfig", "make_optimizer", "make_schedule", "global_norm"]


@dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "cosine"     # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 10000
    decay_frac: float = 0.1      # wsd: final decay fraction of total steps


def make_schedule(oc: OptConfig) -> Callable[[int], float]:
    """Step -> learning rate (base lr x warmup x schedule multiplier),
    in float32 as the reference computes it."""
    f32 = np.float32

    def sched(step: int) -> float:
        step = f32(step)
        warm = min((step + f32(1.0)) / f32(max(oc.warmup_steps, 1)), f32(1.0))
        if oc.schedule == "cosine":
            t = np.clip((step - f32(oc.warmup_steps))
                        / f32(max(oc.total_steps - oc.warmup_steps, 1)),
                        f32(0), f32(1))
            mult = (f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t))
                    * f32(0.9) + f32(0.1))
        elif oc.schedule == "wsd":  # warmup-stable-decay (MiniCPM)
            decay_start = f32(oc.total_steps * (1 - oc.decay_frac))
            t = np.clip((step - decay_start)
                        / max(f32(oc.total_steps) - decay_start, f32(1)),
                        f32(0), f32(1))
            mult = f32(1.0) if step < decay_start else f32(1.0) - f32(0.9) * t
        elif oc.schedule == "constant":
            mult = f32(1.0)
        else:
            raise ValueError(f"unknown schedule {oc.schedule!r}")
        return float(f32(oc.lr) * f32(warm) * f32(mult))

    return sched


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (f32, on device)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def _clip_scale(oc: OptConfig, gnorm: torch.Tensor) -> torch.Tensor:
    return torch.clamp(oc.grad_clip / (gnorm + 1e-9), max=1.0)


def make_optimizer(oc: OptConfig):
    """``(init(params) -> state, update(grads, state, params, step) ->
    (params, state, gnorm))``; ``grads`` is a list in the order of
    :func:`~repro_torch.models.params.tree_leaves` over ``params``, and
    ``update`` overwrites ``params`` and ``state`` in place (and returns
    them)."""
    sched = make_schedule(oc)

    if oc.name == "adamw":
        def init(params):
            return {"m": tree_map(torch.zeros_like, params),
                    "v": tree_map(torch.zeros_like, params)}

        @torch.no_grad()
        def update(grads, state, params, step: int):
            gnorm = global_norm(grads)
            scale = _clip_scale(oc, gnorm)
            lr = sched(step)
            b1c = float(1 - np.float32(oc.b1) ** np.float32(step + 1))
            b2c = float(1 - np.float32(oc.b2) ** np.float32(step + 1))
            for p, g, m, v in zip(tree_leaves(params), grads,
                                  tree_leaves(state["m"]),
                                  tree_leaves(state["v"])):
                g = g.float().mul_(scale)
                m.mul_(oc.b1).add_((1 - oc.b1) * g)
                v.mul_(oc.b2).add_((1 - oc.b2) * torch.square(g))
                upd = (m / b1c) / (torch.sqrt(v / b2c) + oc.eps)
                p32 = p.float()
                p.copy_(p32 - lr * (upd + oc.weight_decay * p32))
            return params, state, gnorm

        return init, update

    if oc.name == "adafactor":
        def init(params):
            def one(p):
                if p.ndim >= 2:
                    return {"r": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                             device=p.device),
                            "c": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                             dtype=torch.float32,
                                             device=p.device)}
                return {"v": torch.zeros_like(p, dtype=torch.float32)}
            return {"f": tree_map(one, params)}

        @torch.no_grad()
        def update(grads, state, params, step: int):
            gnorm = global_norm(grads)
            scale = _clip_scale(oc, gnorm)
            lr = sched(step)
            decay = float(1.0 - np.float32(step + 1.0) ** np.float32(-0.8))
            factors = _factor_nodes(state["f"], params)
            for p, g, f in zip(tree_leaves(params), grads, factors):
                g = g.float().mul_(scale)
                g2 = torch.square(g) + 1e-30
                if p.ndim >= 2:
                    f["r"].copy_(decay * f["r"] + (1 - decay) * g2.mean(dim=-1))
                    f["c"].copy_(decay * f["c"] + (1 - decay) * g2.mean(dim=-2))
                    denom = f["r"][..., None] * f["c"][..., None, :]
                    denom = denom / torch.clamp_min(
                        f["r"].mean(dim=-1)[..., None, None], 1e-30)
                    upd = g / (torch.sqrt(denom) + 1e-30)
                else:
                    f["v"].copy_(decay * f["v"] + (1 - decay) * g2)
                    upd = g / (torch.sqrt(f["v"]) + 1e-30)
                # update clipping (Adafactor RMS rule)
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-30)
                upd = upd / torch.clamp_min(rms, 1.0)
                p32 = p.float()
                p.copy_(p32 - lr * (upd + oc.weight_decay * p32))
            return params, state, gnorm

        return init, update

    raise ValueError(f"unknown optimizer {oc.name!r}; have adamw, adafactor")


def _factor_nodes(ftree, params) -> list:
    """The per-param factor dicts of an Adafactor state, in the order of
    ``tree_leaves(params)``."""
    if isinstance(params, dict):
        return [f for k in sorted(params)
                for f in _factor_nodes(ftree[k], params[k])]
    if isinstance(params, list):
        return [f for fp, pp in zip(ftree, params)
                for f in _factor_nodes(fp, pp)]
    return [ftree]
