"""Shared plumbing of the kernel wrappers: device routing and ctypes args."""
from __future__ import annotations

import ctypes
from collections import Counter
from contextlib import contextmanager
from functools import lru_cache
from typing import Iterator, List, Optional

import torch

__all__ = ["on_cuda", "ptr", "stream", "require", "count_launch",
           "recording_launches", "replay_launches", "sm_count", "result_like"]


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises.

    The one routing rule of the port: a CPU tensor takes a kernel's plain
    version, a CUDA tensor launches the kernel.  Mixed devices raise.
    """
    types = {t.device.type for t in tensors if t is not None}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        devs = {t.device for t in tensors if t is not None}
        if len(devs) > 1:
            raise ValueError(f"operands on several cards: {sorted(map(str, devs))}")
        return True
    raise ValueError(f"operands must all lie on the CPU or all on CUDA, "
                     f"got {sorted(types)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None):
    """Raise unless ``t`` is contiguous, of ``dtype`` and (if given) ``shape``."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# the launch records of the CUDA-graph captures in progress (innermost
# last): a launch made while one is open is recorded there, not counted
_RECORDING: List[Counter] = []


def _add(wrapper, depth: Optional[int], n: int) -> None:
    wrapper.launches += n
    if depth is not None:
        wrapper.launches_by_depth[depth] = (
            wrapper.launches_by_depth.get(depth, 0) + n)


def count_launch(wrapper, depth: Optional[int] = None) -> None:
    """Count one launch of ``wrapper``'s kernel: its total ``launches``
    and, for a wrapper with a stage count, ``launches_by_depth``.  Inside
    :func:`recording_launches` the launch is recorded instead: a graph
    capture launches nothing, its replays do."""
    if _RECORDING:
        _RECORDING[-1][(wrapper, depth)] += 1
    else:
        _add(wrapper, depth, 1)


@contextmanager
def recording_launches() -> Iterator[Counter]:
    """Record, by wrapper and depth, the launches made while open (a
    CUDA-graph capture); :func:`replay_launches` counts them once per
    replay, so the counters read as they would after eager runs."""
    rec: Counter = Counter()
    _RECORDING.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.pop()


def replay_launches(rec: Counter) -> None:
    for (wrapper, depth), n in rec.items():
        _add(wrapper, depth, n)


@lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def result_like(t: torch.Tensor,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """An uninitialised result of ``t``'s shape (and ``dtype``, default
    ``t``'s) that starts at the same address mod 16 B as ``t``, so the
    streaming kernels (K5 / K6, K9 / K10) keep a 16 B vector body after a
    head of single elements where an operand starts past a 16 B
    boundary."""
    dtype = dtype or t.dtype
    lag = (t.data_ptr() % 16) // torch.empty(0, dtype=dtype).element_size()
    flat = torch.empty(t.numel() + lag, dtype=dtype, device=t.device)
    return flat[lag:].view(t.shape)
