"""Deterministic, resumable data pipeline (numpy only).

The port's own copy of ``repro.data.pipeline``; a batch is a dict of
int32 numpy arrays, bit-equal to the reference's for the same seed and
step.  Two sources:

  * ``SyntheticLM`` -- seeded on (seed, step), so any step's batch can
    be regenerated exactly: restart-safe without saving cursor state;
  * ``BinCorpus`` -- memory-mapped uint16/uint32 token file, strided
    into fixed-length windows; the cursor is ``step`` alone.

Both yield *global* batches; ``host_slice`` takes one process's rows
([i*B/nproc, (i+1)*B/nproc)).  The train step moves a batch to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

__all__ = ["SyntheticLM", "BinCorpus", "host_slice", "make_source"]


@dataclass
class SyntheticLM:
    """Zipf-ish synthetic token stream (deterministic per step)."""

    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        # Zipf-like marginal over the vocab: realistic CE trajectories
        z = rng.zipf(1.3, size=(self.global_batch, self.seq_len + 1))
        toks = np.minimum(z, self.vocab_size - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclass
class BinCorpus:
    """Flat binary token corpus, memory-mapped, strided windows."""

    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    dtype: str = "uint16"
    seed: int = 0

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        self._n_windows = (len(self._data) - 1) // self.seq_len
        if self._n_windows < self.global_batch:
            raise ValueError(
                f"corpus {self.path} too small: {self._n_windows} windows")
        rng = np.random.default_rng(self.seed)
        self._perm = rng.permutation(self._n_windows)

    def batch_at(self, step: int) -> dict:
        idx = [
            self._perm[(step * self.global_batch + i) % self._n_windows]
            for i in range(self.global_batch)
        ]
        rows = np.stack([
            self._data[j * self.seq_len: j * self.seq_len + self.seq_len + 1]
            for j in idx
        ]).astype(np.int32)
        rows = np.minimum(rows, self.vocab_size - 1)
        return {"tokens": rows[:, :-1], "targets": rows[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def host_slice(batch: dict, process_index: int, process_count: int) -> dict:
    """Rows of the global batch owned by this process."""
    def one(x):
        per = x.shape[0] // process_count
        return x[process_index * per:(process_index + 1) * per]

    return {k: one(v) for k, v in batch.items()}


def make_source(name: str, cfg, shape: dict, seed: int = 0,
                path: Optional[str] = None):
    """``"synthetic"`` or ``"bin"`` source for ``cfg``'s vocabulary;
    ``shape`` holds ``seq_len`` and ``global_batch``."""
    if name == "synthetic":
        return SyntheticLM(cfg.vocab_size, shape["seq_len"],
                           shape["global_batch"], seed)
    if name == "bin":
        if not (path and Path(path).exists()):
            raise FileNotFoundError(f"no corpus at {path!r}")
        return BinCorpus(path, cfg.vocab_size, shape["seq_len"],
                         shape["global_batch"], seed=seed)
    raise ValueError(f"unknown data source {name!r}; have synthetic, bin")
