"""The port's hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper keeps a plain integer ``launches`` that it raises by one
where it launches its kernel, and nowhere else; :func:`launch_counts`
reads them and :func:`reset_launch_counts` sets them to 0.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["launch_counts", "reset_launch_counts"]


def _wrappers():
    # imported here, not at the top: core modules that the wrapper
    # modules import initialise this package first
    from repro_torch.kernels.flash_attn.ops import flash_decode_attn
    from repro_torch.kernels.fused_div.ops import (div_elementwise,
                                                   div_rowbcast,
                                                   fused_rms_div,
                                                   fused_softmax_div)
    from repro_torch.kernels.log_matmul.ops import log_matmul

    return {"log_matmul": log_matmul, "rms_div": fused_rms_div,
            "softmax_div": fused_softmax_div,
            "flash_decode": flash_decode_attn,
            "div_rowbcast": div_rowbcast, "div": div_elementwise}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
