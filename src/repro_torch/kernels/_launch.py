"""Shared plumbing of the kernel wrappers: device routing and ctypes args."""
from __future__ import annotations

import ctypes

import torch

__all__ = ["on_cuda", "ptr", "stream", "require"]


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
