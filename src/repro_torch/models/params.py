"""Parameter specs, seeded init, and the loader for the reference's params.

A model is a nested dict whose leaves are :class:`P` specs (shape + init
rule); :func:`materialize` turns it into tensors with a seeded
``torch.Generator``, drawing each leaf from the reference's init
distributions (``repro.models.params.materialize``): normal with std
``scale / sqrt(fan_in)``, std 0.02 for ``"small"``, zeros, ones or a
fill value.  The two frameworks draw different numbers from one seed;
tests that compare against the reference carry its params over with
:func:`load_jax_params` instead.

Layout: ``blocks`` (and an encdec model's ``enc_blocks``) is a list of
per-layer dicts.  The reference keeps
either a stacked tree (``scan_layers=True``: a leading layer dim on
every leaf) or one ``"l{i}"`` subtree per layer; the loader takes both.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["P", "materialize", "load_jax_params", "tree_map", "tree_leaves",
           "tree_items"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


@dataclass(frozen=True)
class P:
    """Leaf spec: shape, init rule, scale (std factor or fill value), dtype
    ("float32" means the model's param dtype)."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | small | fill
    scale: float = 1.0
    dtype: str = "float32"


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, object]]:
    """(path, leaf) pairs in the order the reference flattens a tree:
    dict keys sorted, list entries in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def tree_items(tree):
    """(path, leaf) pairs of a nested dict/list tree: dict keys sorted,
    list entries in order (the order the optimizer and the checkpoints
    walk)."""
    return list(_leaves(tree))


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree, in :func:`tree_items` order."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def materialize(tree, seed: int, device, param_dtype: str = "float32"):
    """Initialise real parameters for a spec tree on ``device``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def one(spec: P) -> torch.Tensor:
        dt = _DTYPES[param_dtype if spec.dtype == "float32" else spec.dtype]
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init == "fill":
            return torch.full(spec.shape, spec.scale, dtype=dt, device=device)
        fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
        std = 0.02 if spec.init == "small" else spec.scale / math.sqrt(fan_in)
        arr = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return arr.mul_(std).to(dt)

    # draw in the reference's flatten order, so the stream is fixed
    out = {}
    for path, spec in _leaves(tree):
        out[path] = one(spec)
    return _rebuild(tree, out)


def _rebuild(tree, values: dict, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, path + (i,)) for i, v in enumerate(tree)]
    return values[path]


# the subtrees that hold one entry per layer
_LAYER_LISTS = ("blocks", "enc_blocks")


def load_jax_params(tree, device=None):
    """A tree of the reference's (nested dicts of numpy arrays) -> the
    port's.

    Every ``"blocks"`` and ``"enc_blocks"`` subtree may be stacked
    (every leaf ``[L, ...]``) or keyed ``"l0"``, ``"l1"``, ...; either
    becomes a list of per-layer dicts.  That covers params and every tree
    shaped like them: the reference's gradients and its optimizer state
    (``{"m": params, "v": params}``).  Arrays keep their dtype (f32
    params stay f32).  ``device`` goes through
    :func:`repro_torch.device.resolve_device` (``cuda`` unless the
    caller asks for the CPU).
    """
    device = resolve_device(device)

    def to_t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    def blocks(b):
        if "l0" in b:
            return [convert(b[f"l{i}"]) for i in range(len(b))]
        n = next(leaf for _, leaf in _leaves(b)).shape[0]
        return [tree_map(lambda a, i=i: to_t(a[i]), b) for i in range(n)]

    def convert(t):
        if isinstance(t, dict):
            return {k: blocks(v) if k in _LAYER_LISTS else convert(v)
                    for k, v in t.items()}
        return tree_map(to_t, t)

    return convert(tree)
