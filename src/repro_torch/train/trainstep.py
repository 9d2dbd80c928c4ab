"""Training step: mixed precision, gradient accumulation, the update.

The port of ``repro.train.trainstep`` on one device:

  * params stay f32 masters and are cast to the compute dtype
    (``cfg.dtype``, bf16) before the forward; autograd carries the
    gradients back through the cast to f32;
  * ``microbatches > 1`` accumulates the microbatch gradients in bf16,
    as the reference does, then divides in f32;
  * the optimizer updates params and state in place
    (:mod:`repro_torch.train.optimizer`).

The reference's multi-device parts (``constrain_grads`` sharding
constraints, ``_pin_backend``) have no counterpart: the port has one
dispatch path and no mesh yet.

A step is also available in two halves, :meth:`TrainStep.loss_and_grads`
and :meth:`TrainStep.apply`, so the loop can retry a loss spike from the
unchanged params without keeping a copy of them.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import OptConfig, make_optimizer, make_schedule

__all__ = ["TrainStep", "make_train_step", "make_eval_step", "to_device"]


def to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not torch.is_tensor(v)
                else v).to(device) for k, v in batch.items()}


def _cast(params, dtype: torch.dtype):
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)


class TrainStep:
    """``step(params, opt_state, batch, step) -> (params, opt_state,
    metrics)`` with ``metrics = {"loss", "grad_norm", "lr"}`` (device
    scalars and a float); params and state are updated in place."""

    def __init__(self, model: Model, oc: OptConfig, microbatches: int = 1):
        self.model, self.oc = model, oc
        self.microbatches = microbatches
        self.sched = make_schedule(oc)
        self._update = make_optimizer(oc)[1]

    def _loss(self, params, batch):
        return self.model.loss_fn(_cast(params, self.model.dtype), batch)

    def loss_and_grads(self, params, batch):
        """(loss, [grad per leaf of ``tree_leaves(params)``]), params
        untouched."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        dev = leaves[0].device
        batch = to_device(batch, dev)
        try:
            if self.microbatches <= 1:
                loss = self._loss(params, batch)
                grads = list(torch.autograd.grad(loss, leaves))
                return loss.detach(), grads
            mb = self.microbatches
            acc: List[torch.Tensor] = [
                torch.zeros(p.shape, dtype=torch.bfloat16, device=dev)
                for p in leaves]
            losses = []
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                loss = self._loss(params, part)
                for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
                    a.add_(g.to(torch.bfloat16))
                losses.append(loss.detach())
            return (torch.stack(losses).mean(),
                    [a.float() / mb for a in acc])
        finally:
            for p in leaves:
                p.requires_grad_(False)

    def apply(self, params, opt_state, loss, grads, step: int):
        """The optimizer update from ``grads`` (consumed)."""
        params, opt_state, gnorm = self._update(grads, opt_state, params,
                                                step)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr": self.sched(step)}

    def __call__(self, params, opt_state, batch, step: int):
        loss, grads = self.loss_and_grads(params, batch)
        return self.apply(params, opt_state, loss, grads, int(step))


def make_train_step(model: Model, oc: OptConfig, microbatches: int = 1):
    """``(init_opt(params) -> state, TrainStep)``."""
    return make_optimizer(oc)[0], TrainStep(model, oc, microbatches)


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> loss`` (no gradient)."""

    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params)[0].device
        return model.loss_fn(_cast(params, model.dtype), to_device(batch, dev))

    return eval_step
