"""Device selection and the numerics switches every entry point sets.

Entry points run on ``cuda`` unless the caller asks for ``"cpu"``; there
is no silent fallback to the CPU when no card is present.  The exact
paths must not drop to TF32 or to bf16 reduced-precision reductions:
the exact logits head runs a bf16-valued matmul (``models/model.py``
``_logits``), and TF32 would keep only about three decimal digits.
The switches are set when the package is imported (its ``__init__``
imports this module), so no way of getting weights or a model skips
them; :func:`resolve_device` sets them again in case a caller changed
them since.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "set_exact_numerics"]

DEFAULT_DEVICE = "cuda"


def set_exact_numerics() -> None:
    """Keep float32 matmuls and convolutions in full IEEE float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a card raises."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    set_exact_numerics()
    return dev


set_exact_numerics()
