"""Atomic, keep-N checkpoints in the reference's on-disk layout.

The port of ``repro.ckpt.checkpoint``:

  * **Atomicity** -- a checkpoint is written to ``step_XXXXXXXX.tmp/``
    and renamed into place only after every array and the manifest are
    written, so an interruption mid-write never corrupts the latest one;
  * **Layout** -- one ``.npy`` per leaf, named ``params.<path>`` /
    ``opt.<path>``, plus ``manifest.json`` (step, time, extra such as
    the data cursor, and each array's shape and dtype).  A per-layer
    list entry ``i`` is named ``l<i>``, the reference's unstacked
    naming, so the files of a port checkpoint are named as the
    reference's (``scan_layers=False``) are;
  * **Keep-N GC** -- old checkpoints are pruned only after a newer one
    is in place;
  * **Restore** onto a given device (default: each leaf's device in the
    ``like`` trees).
"""
from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_SEP = "."


def _flatten(tree, prefix: str = "") -> dict:
    """``{dotted name: leaf}``; dict keys sorted, list entry i -> l<i>."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, list):
        items = [(f"l{i}", v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    flat = {}
    for name, sub in items:
        flat.update(_flatten(sub, f"{prefix}{_SEP}{name}" if prefix else name))
    return flat


def _unflatten_like(like, load, prefix: str = ""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, load, f"{prefix}{_SEP}{k}")
                for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten_like(v, load, f"{prefix}{_SEP}l{i}")
                for i, v in enumerate(like)]
    return load(prefix, like)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -------------------------------------------------------------- save
    def save(self, step: int, params, opt_state, extra: Optional[dict] = None):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: dict[str, Any] = {"step": step, "time": time.time(),
                                    "extra": extra or {}, "arrays": {}}
        for tree, prefix in ((params, "params"), (opt_state, "opt")):
            for key, leaf in _flatten(tree).items():
                arr = leaf.detach().cpu().numpy()
                name = f"{prefix}{_SEP}{key}"
                np.save(tmp / (name + ".npy"), arr)
                manifest["arrays"][name] = {"shape": list(arr.shape),
                                            "dtype": str(arr.dtype)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ----------------------------------------------------------- restore
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if p.is_dir() and not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step: Optional[int], params_like, opt_like,
                device=None):
        """``(step, params, opt_state, extra)`` of checkpoint ``step``
        (None: the latest), shaped like ``params_like`` / ``opt_like``
        and placed on ``device`` (default: each ``like`` leaf's device),
        in each ``like`` leaf's dtype."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        cdir = self.dir / f"step_{step:08d}"
        manifest = json.loads((cdir / "manifest.json").read_text())

        def load(name, like):
            arr = np.load(cdir / f"{name}.npy")
            dev = like.device if device is None else torch.device(device)
            return torch.from_numpy(arr).to(device=dev, dtype=like.dtype)

        params = _unflatten_like(params_like, load, "params")
        opt = _unflatten_like(opt_like, load, "opt")
        return step, params, opt, manifest.get("extra", {})
