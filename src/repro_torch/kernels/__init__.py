"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper keeps a plain integer ``launches`` that it raises by one
where it launches its kernel, and nowhere else; :func:`launch_counts`
reads them and :func:`reset_launch_counts` sets them to 0.  Every
wrapper counts through ``_launch.count_launch``, so a CUDA graph's
replays count the launches its capture recorded.  K1-K3 and K5 / K6
also split their launches by depth in ``launches_by_depth``
(:func:`launch_counts_by_depth`): K1 at depth >= 2 is K7, K2/K3/K5 at
depth >= 2 are K8, and K6 has depth 1 only.
:func:`plain_versions` routes the model's and the applications' kernel
calls to the plain versions, so that one run on the card can be held
against another that launches no kernel.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict

__all__ = ["launch_counts", "launch_counts_by_depth", "reset_launch_counts",
           "plain_versions"]


def _wrappers():
    # imported here, not at the top: core modules that the wrapper
    # modules import initialise this package first
    from repro_torch.kernels.flash_attn.ops import flash_decode_attn
    from repro_torch.kernels.fused_div.ops import (div_elementwise,
                                                   div_rowbcast,
                                                   fused_rms_div,
                                                   fused_softmax_div)
    from repro_torch.kernels.log_matmul.ops import log_matmul
    from repro_torch.kernels.rapid_div.ops import rapid_div
    from repro_torch.kernels.rapid_mul.ops import rapid_mul

    return {"log_matmul": log_matmul, "rms_div": fused_rms_div,
            "softmax_div": fused_softmax_div,
            "flash_decode": flash_decode_attn,
            "div_rowbcast": div_rowbcast, "div": div_elementwise,
            "rapid_mul": rapid_mul, "rapid_div": rapid_div}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def launch_counts_by_depth() -> Dict[str, Dict[int, int]]:
    """Launches by stage count of the wrappers that have one."""
    return {name: dict(fn.launches_by_depth)
            for name, fn in _wrappers().items()
            if hasattr(fn, "launches_by_depth")}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "launches_by_depth"):
            fn.launches_by_depth = {}


@contextmanager
def plain_versions():
    """Route kernel calls to their plain versions (on any device) while
    the context is open: K1-K4 where ``core/ops.py`` calls them, K5/K6
    where ``fused_elementwise_div`` does.  K9/K10 are called directly by
    their users and are not swapped."""
    from repro_torch.core import ops
    from repro_torch.kernels.flash_attn.ops import flash_decode_plain
    from repro_torch.kernels.fused_div import ops as fdops
    from repro_torch.kernels.log_matmul.ops import log_matmul_plain

    swaps = [(ops, {"log_matmul": log_matmul_plain,
                    "fused_rms_div": fdops.rms_div_plain,
                    "fused_softmax_div": fdops.softmax_div_plain,
                    "flash_decode_attn": flash_decode_plain}),
             (fdops, {"div_rowbcast": fdops.div_rowbcast_plain,
                      "div_elementwise": fdops.div_plain})]
    saved = [(mod, {k: getattr(mod, k) for k in swap}) for mod, swap in swaps]
    for mod, swap in swaps:
        for k, v in swap.items():
            setattr(mod, k, v)
    try:
        yield
    finally:
        for mod, old in saved:
            for k, v in old.items():
                setattr(mod, k, v)
