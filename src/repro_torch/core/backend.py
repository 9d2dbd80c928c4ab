"""Epilogue menu and the plain K-order log-domain matmul.

The port of the pieces of ``repro.core.backend`` the dense serve path
needs: the fused-epilogue activations, the :class:`Epilogue` spec, its
canonical tile semantics (:func:`apply_epilogue_tile`) and
:func:`log_matmul_scan`.  There is no backend registry: the device of
the operands picks the path (``repro_torch.kernels._launch.on_cuda``).
"""
from __future__ import annotations

from dataclasses import dataclass
from dataclasses import replace as dataclass_replace
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import float_approx as fa
from repro_torch.kernels.fused_div import ref as fdref

__all__ = [
    "ACTIVATIONS",
    "ACT_CODES",
    "SOFTMAX_FLOOR",
    "EPILOGUE_NORMS",
    "Epilogue",
    "normalize_activation",
    "as_epilogue",
    "apply_epilogue_tile",
    "log_matmul_scan",
]

SOFTMAX_FLOOR = fdref.SOFTMAX_FLOOR

# Fused-epilogue activations (the reference's table).  "gelu" is the tanh
# approximation, "gelu_erf" the exact erf form.
ACTIVATIONS: Dict[str, Callable] = {
    "relu": F.relu,
    "silu": F.silu,
    "gelu": lambda z: F.gelu(z, approximate="tanh"),
    "gelu_erf": F.gelu,
    "tanh": torch.tanh,
}

# activation -> the `act` code of csrc/log_matmul.cu: the ones the ported
# configs use (silu: the swiglu configs; gelu, tanh form: starcoder2_7b);
# the kernel has no other
ACT_CODES = {None: 0, "silu": 1, "gelu": 2}


def normalize_activation(activation: Optional[str]) -> Optional[str]:
    """Canonicalize an epilogue activation name (None for identity)."""
    if activation in (None, "none", "linear"):
        return None
    if activation not in ACTIVATIONS:
        raise KeyError(
            f"unknown activation {activation!r}; have {tuple(ACTIVATIONS)}")
    return activation


EPILOGUE_NORMS = ("rms", "softmax")


@dataclass(frozen=True)
class Epilogue:
    """What to apply to the matmul output: ``norm(act(out + bias) +
    residual)``, every stage optional; ``keep_prenorm`` also returns the
    value before the norm stage as ``(tail, pre)``.  ``div_scheme`` is
    the norm stage's RAPID divider (None = exact IEEE divide)."""

    activation: Optional[str] = None
    norm: Optional[str] = None
    div_scheme: Optional[str] = None
    eps: float = 1e-6
    floor: float = SOFTMAX_FLOOR
    keep_prenorm: bool = False


def as_epilogue(epilogue: Optional[Epilogue],
                activation: Optional[str] = None) -> Epilogue:
    """Canonicalize/validate the (epilogue, activation) call-site pair."""
    if epilogue is None:
        return Epilogue(activation=normalize_activation(activation))
    if not isinstance(epilogue, Epilogue):
        raise TypeError(f"epilogue must be an Epilogue, got {epilogue!r}")
    if normalize_activation(activation) is not None:
        raise ValueError("pass the activation inside the Epilogue spec, "
                         "not alongside it")
    if epilogue.norm is not None and epilogue.norm not in EPILOGUE_NORMS:
        raise KeyError(f"unknown epilogue norm {epilogue.norm!r}; "
                       f"have {EPILOGUE_NORMS}")
    if epilogue.keep_prenorm and epilogue.norm is None:
        raise ValueError("keep_prenorm without a norm stage is meaningless")
    act = normalize_activation(epilogue.activation)
    if act != epilogue.activation:
        epilogue = dataclass_replace(epilogue, activation=act)
    return epilogue


def apply_epilogue_tile(z, bias, residual, ep: Epilogue, *, n: int,
                        div_lut=None):
    """Canonical epilogue semantics on lane-padded rows (plain version).

    ``z`` is ``[rows, n_pad]`` f32 with the real width ``n`` zero-padded
    to a multiple of ``LANE``; ``bias``/``residual`` are padded the same
    way.  Every activation maps 0 to 0, so the pad lanes stay inert for
    the norm stage's denominators.
    """
    if bias is not None:
        z = z + bias[None, :]
    if ep.activation is not None:
        z = ACTIVATIONS[ep.activation](z)
    if residual is not None:
        z = z + residual
    pre = z
    if ep.norm == "softmax":
        denom = fdref.softmax_denom(z, ep.floor)
        z = (fa.log_div_f32(z, denom, div_lut)
             if ep.div_scheme is not None else z / denom)
    elif ep.norm == "rms":
        denom = fdref.rms_denom(z, n, ep.eps)
        z = (fa.log_div_f32(z, denom, div_lut)
             if ep.div_scheme is not None else z / denom)
    return (z, pre) if ep.keep_prenorm else z


# products per vectorized chunk of the plain matmul (bounds its memory)
_SCAN_ELEMS = 1 << 24


def log_matmul_scan(x: torch.Tensor, w: torch.Tensor,
                    lut: torch.Tensor) -> torch.Tensor:
    """RAPID matmul x[M,K] @ w[K,N], summed one k at a time in K order.

    The plain version of kernel K1 and bit-equal to the reference's
    ``log_matmul_scan(chunk=1)``: ``acc = 0; acc = acc + p_k`` for
    k = 0..K-1.  Products are computed for a slab of k's at once; only
    the sum is sequential.  Batched: ``x[B,M,K] @ w[B,K,N]``, where
    either operand may have a batch of 1 (or be 2-D) and is then
    broadcast over the batch.
    """
    if x.ndim not in (2, 3) or w.ndim not in (2, 3) \
            or x.shape[-1] != w.shape[-2]:
        raise ValueError(f"contraction mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape[-2:]
    n = w.shape[-1]
    batch = ()
    if x.ndim == 3 or w.ndim == 3:
        bx = x.shape[0] if x.ndim == 3 else 1
        bw = w.shape[0] if w.ndim == 3 else 1
        if bx != bw and 1 not in (bx, bw):
            raise ValueError(f"batch mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
        batch = (max(bx, bw),)
    acc = torch.zeros(batch + (m, n), dtype=torch.float32, device=x.device)
    slab = max(1, min(k, _SCAN_ELEMS // max(acc.numel(), 1)))
    for k0 in range(0, k, slab):
        prod = fa.log_mul_f32(x[..., :, k0:k0 + slab, None],
                              w[..., None, k0:k0 + slab, :], lut)  # [.., M, slab, N]
        for j in range(prod.shape[-2]):
            acc = acc + prod[..., j, :]
    return acc
