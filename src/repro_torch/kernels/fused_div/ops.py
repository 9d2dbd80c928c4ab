"""K2 / K3 / K5 / K6 wrappers: the fused RAPID divider family.

``fused_rms_div(x, eps, scheme)`` is ``x / sqrt(mean(x^2, -1) + eps)`` and
``fused_softmax_div(e, scheme, floor)`` is ``e / max(sum(e, -1), floor)``,
each with the denominator in the canonical form of :mod:`.ref` and the
divide through the RAPID divider (``scheme=None``: IEEE divide).
``fused_elementwise_div(a, b, scheme)`` is the RAPID ``a / b`` with
broadcasting: one denominator per row of ``a`` (``b`` a scalar or with
trailing dim 1) goes to :func:`div_rowbcast` (K5), any other broadcast to
:func:`div_elementwise` (K6) on pre-broadcast operands.

* CPU tensors run the plain versions (:func:`rms_div_plain`,
  :func:`softmax_div_plain`, :func:`div_rowbcast_plain`,
  :func:`div_plain`).
* CUDA tensors launch ``csrc/fused_div.cu`` (replacing the Pallas
  ``rms_div_pallas`` / ``softmax_div_pallas`` / ``div_rowbcast_pallas``
  / ``div_pallas`` of ``src/repro/kernels/fused_div/fused_div.py``): at
  depth 1 K2/K3 read each row once onto the chip (four warps on a wide
  row, staged in shared memory; a warp a narrow one, in registers; a
  block walking its slabs of rows); K6, and K5 at depth 1, stream their
  operands 16 B a thread as K9 / K10 do (geometry from ``int_split`` /
  ``int_geometry``; K5 finds each row with :func:`row_magic`'s multiply
  and shift, no hardware divide); K2/K3/K5 at depth >= 2 walk row slabs
  with ``depth`` slabs in flight (K8, replacing
  ``_rowwise_pipelined_call``).

``spec`` (:class:`repro_torch.kernels.spec.KernelSpec`) of K2/K3/K5 sets
the stage count and the rows per slab, resolved by ``resolve_spec``
(default: 2 slabs in flight); it moves no bits.  The rest of the
geometry (warps on a row, the grid) comes from ``row_geometry`` and
goes to the kernel with it.  The plan is checked against the card's
shared memory on either route.  K6 has no stage
count (nor has the reference's ``div_pallas``).

``return_denom=True`` also returns the per-row denominators ``[..., 1]``
(the kernel writes its own), so a check can hold the quotients against
the plain divide fed the same denominator.  Each kernel wrapper
(``fused_rms_div``, ``fused_softmax_div``, ``div_rowbcast``,
``div_elementwise``) counts its launches through ``count_launch``, in
``.launches`` and by stage count in ``.launches_by_depth`` (K6's all at
depth 1).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core import float_approx as fa
from repro_torch.kernels import _build, budget
from repro_torch.kernels._launch import (count_launch, on_cuda, ptr, require,
                                         result_like, sm_count, stream)
from repro_torch.kernels.fused_div import ref
from repro_torch.kernels.spec import (KernelSpec, RowGeometry, int_geometry,
                                      int_split, resolve_spec, row_geometry)

__all__ = ["fused_rms_div", "fused_softmax_div", "fused_elementwise_div",
           "div_rowbcast", "div_elementwise", "rms_div_plain",
           "softmax_div_plain", "div_rowbcast_plain", "div_plain",
           "row_magic", "row_index"]

# flat element indices of K5/K6 are 32-bit
_MAX_ELEMENTS = 2**31 - 1


def row_magic(n: int) -> Tuple[int, int]:
    """(magic, shift) with which K5 finds the row ``i // n`` of element
    ``i`` as ``umulhi(2 i, magic) >> shift`` (:func:`row_index`), exact
    for every ``i < 2^31``.  With ``shift = ceil(log2 n)`` and ``magic =
    ceil(2^(31 + shift) / n)``, ``magic * n - 2^(31 + shift) < n <=
    2^shift``, which is Granlund and Montgomery's condition for
    ``floor(i * magic / 2^(31 + shift)) == i // n`` over 31-bit ``i``;
    ``magic < 2^32`` (it is ``2^31`` for a power of two, and under
    ``2^32`` otherwise), and the product's high word shifted right by
    ``shift`` is that floor, since ``2 i < 2^32``."""
    if not 1 <= n < 2**31:
        raise ValueError(f"row width {n} outside [1, 2^31)")
    shift = (n - 1).bit_length()
    magic = -(-(1 << (31 + shift)) // n)
    assert magic < 1 << 32
    return magic, shift


def row_index(i, magic: int, shift: int):
    """The kernel's row of element ``i`` (an int, or a numpy uint64 array
    of them, each below 2^31) in its uint32 arithmetic:
    ``umulhi(i << 1, magic) >> shift``."""
    return (((i << 1) & 0xFFFFFFFF) * magic >> 32) >> shift


def _divide(x, denom, scheme):
    if scheme is None:
        return x / denom
    return fa.log_div_f32(x, denom, fa.div_lut_device(scheme, x.device))


def rms_div_plain(x, eps: float, scheme: Optional[str], *,
                  return_denom: bool = False):
    """Plain PyTorch version of K2 (any device)."""
    denom = ref.rms_denom(ref.pad_lanes(x), x.shape[-1], eps)
    out = _divide(x, denom, scheme)
    return (out, denom) if return_denom else out


def softmax_div_plain(e, scheme: Optional[str], *,
                      floor: float = ref.SOFTMAX_FLOOR,
                      return_denom: bool = False):
    """Plain PyTorch version of K3 (any device)."""
    denom = ref.softmax_denom(ref.pad_lanes(e), floor)
    out = _divide(e, denom, scheme)
    return (out, denom) if return_denom else out


def _row_plan(family: str, x: torch.Tensor, spec: Optional[KernelSpec]):
    """The resolved spec of a row divider over ``x``'s last dim and its
    geometry (``kernels/spec.py``), checked against the card's shared
    memory."""
    n = x.shape[-1]
    rows = x.numel() // max(n, 1)
    ks = resolve_spec(family, (rows, n), spec)
    geom = row_geometry(family, rows, n, ks.depth, ks.bm)
    budget.check_smem(geom.smem, family)
    return ks, geom


def _launch_rows(x, scheme, name, ks: KernelSpec, geom: RowGeometry,
                 *consts):
    require(x, "x", torch.float32)
    n = x.shape[-1]
    if x.numel() == 0:
        raise ValueError(f"{name}: empty operand {tuple(x.shape)}")
    out = torch.empty_like(x)
    denom = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                        device=x.device)
    lut = fa.div_lut_device(scheme, x.device) if scheme is not None else None
    fn = _build.function("fused_div", f"rapid_{name}",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_float] * len(consts) + [ctypes.c_void_p])
    err = fn(ptr(x), ptr(out), ptr(denom), ptr(lut), x.numel() // n, n,
             ks.depth, geom.bm, geom.warps, geom.grid, *consts,
             stream(x.device))
    _build.check(err, name)
    return out, denom


def fused_rms_div(x: torch.Tensor, eps: float, scheme: Optional[str], *,
                  return_denom: bool = False,
                  spec: Optional[KernelSpec] = None):
    """Row-wise rms normalize over the last dim, f32 in/out."""
    ks, geom = _row_plan("fused_rms", x, spec)
    if not on_cuda(x):
        return rms_div_plain(x, eps, scheme, return_denom=return_denom)
    out, denom = _launch_rows(x, scheme, "rms_div", ks, geom,
                              *ref.rms_consts(x.shape[-1], eps))
    count_launch(fused_rms_div, ks.depth)
    return (out, denom) if return_denom else out


def fused_softmax_div(e: torch.Tensor, scheme: Optional[str], *,
                      floor: float = ref.SOFTMAX_FLOOR,
                      return_denom: bool = False,
                      spec: Optional[KernelSpec] = None):
    """Row-wise softmax combine over the last dim, f32 in/out."""
    ks, geom = _row_plan("fused_softmax", e, spec)
    if not on_cuda(e):
        return softmax_div_plain(e, scheme, floor=floor,
                                 return_denom=return_denom)
    out, denom = _launch_rows(e, scheme, "softmax_div", ks, geom,
                              float(floor))
    count_launch(fused_softmax_div, ks.depth)
    return (out, denom) if return_denom else out


def div_rowbcast_plain(a, b, scheme: str):
    """Plain PyTorch version of K5: ``a [M, N] / b [M]`` (any device)."""
    return fa.log_div_f32(a, b.reshape(-1, 1),
                          fa.div_lut_device(scheme, a.device))


def div_plain(a, b, scheme: str):
    """Plain PyTorch version of K6: ``a / b``, same shapes (any device)."""
    return fa.log_div_f32(a, b, fa.div_lut_device(scheme, a.device))


def div_rowbcast(a: torch.Tensor, b: torch.Tensor, scheme: str, *,
                 spec: Optional[KernelSpec] = None):
    """RAPID ``a [M, N] / b [M]``, one denominator per row; f32 in/out.
    Depth 1 is K5, depth >= 2 K8."""
    ks, geom = _row_plan("fused_div_rowbcast", a, spec)
    if not on_cuda(a, b):
        return div_rowbcast_plain(a, b, scheme)
    require(a, "a", torch.float32)
    if a.ndim != 2:
        raise ValueError(f"a: expected [M, N], got {tuple(a.shape)}")
    require(b, "b", torch.float32, a.shape[:1])
    if not 0 < a.numel() <= _MAX_ELEMENTS:
        raise ValueError(f"div_rowbcast: {a.numel()} elements, expected "
                         f"1..{_MAX_ELEMENTS}")
    out = _launch_rowbcast(a, b, scheme, ks, geom)
    count_launch(div_rowbcast, ks.depth)
    return out


def _launch_rowbcast(a, b, scheme, ks: KernelSpec, geom: RowGeometry):
    """K8 at depth >= 2 with ``geom``; at depth 1 K5, whose result starts
    where ``a`` does mod 16 B and whose geometry ``row_geometry`` plans
    for that head (``geom`` only names the slab)."""
    lut = ptr(fa.div_lut_device(scheme, a.device))
    rows, n = a.shape
    if ks.depth > 1:
        out = torch.empty_like(a)
        fn = _build.function("fused_div", "rapid_div_rowbcast",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p])
        err = fn(ptr(a), ptr(b), ptr(out), lut, rows, n, ks.depth, geom.bm,
                 geom.warps, geom.grid, stream(a.device))
    else:
        out = result_like(a)
        head, _, _ = int_split(a.numel(), a.data_ptr(), out.data_ptr())
        geom = row_geometry("fused_div_rowbcast", rows, n, 1, geom.bm, head)
        fn = _build.function("fused_div", "rapid_div_rowbcast_stream",
                             [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                             + [ctypes.c_longlong] + [ctypes.c_uint] * 2
                             + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        err = fn(ptr(a), ptr(b), ptr(out), lut, rows, n, head, *row_magic(n),
                 geom.blocks_per_sm, budget.INT_THREADS, geom.grid,
                 stream(a.device))
    _build.check(err, "div_rowbcast")
    return out


def div_elementwise(a: torch.Tensor, b: torch.Tensor, scheme: str):
    """RAPID ``a / b`` on operands of one shape; f32 in/out.  The result
    starts where ``a`` does mod 16 B where ``b`` does too, so the three
    share a 16 B vector body."""
    if not on_cuda(a, b):
        return div_plain(a, b, scheme)
    require(a, "a", torch.float32)
    require(b, "b", torch.float32, a.shape)
    if not 0 < a.numel() <= _MAX_ELEMENTS:
        raise ValueError(f"div_elementwise: {a.numel()} elements, expected "
                         f"1..{_MAX_ELEMENTS}")
    out = (result_like(a) if a.data_ptr() % 16 == b.data_ptr() % 16
           else torch.empty_like(a))
    head, _, _ = int_split(a.numel(), a.data_ptr(), b.data_ptr(),
                           out.data_ptr())
    geom = int_geometry(a.numel(), sm_count(a.device.index or 0), head)
    fn = _build.function("fused_div", "rapid_div",
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    err = fn(ptr(a), ptr(b), ptr(out), ptr(fa.div_lut_device(scheme, a.device)),
             a.numel(), head, geom.blocks_per_sm, geom.threads, geom.grid,
             stream(a.device))
    _build.check(err, "div_elementwise")
    count_launch(div_elementwise, 1)
    return out


def _broadcast_shape(x, y) -> torch.Size:
    """The broadcast of two shapes.  (``torch.broadcast_shapes`` imports
    ``torch._refs``, and with it sympy, at its first call: seconds of a
    fresh server's first prefill tick.)"""
    n = max(len(x), len(y))
    x = (1,) * (n - len(x)) + tuple(x)
    y = (1,) * (n - len(y)) + tuple(y)
    if any(i != j and 1 not in (i, j) for i, j in zip(x, y)):
        raise ValueError(f"shapes {x} and {y} do not broadcast")
    return torch.Size(j if i == 1 else i for i, j in zip(x, y))


def fused_elementwise_div(a: torch.Tensor, b: torch.Tensor,
                          scheme: Optional[str] = None) -> torch.Tensor:
    """Elementwise RAPID ``a / b`` (broadcasting ok); output dtype follows a.

    The reference's dispatch: when the output has ``a``'s shape and ``b``
    is a scalar or has trailing dim 1 (the online-softmax combine divides
    ``acc`` by ``l[..., None]``), ``b`` stays one f32 denominator per row
    and K5 broadcasts it; otherwise both operands are broadcast to one
    shape and K6 divides them.  Computes in f32.
    """
    scheme = scheme or "rapid9"
    out_shape = _broadcast_shape(a.shape, b.shape)
    if (out_shape == a.shape and a.ndim >= 1
            and (b.ndim == 0 or b.shape[-1] == 1)):
        n = a.shape[-1]
        a2 = a.float().reshape(-1, n).contiguous()
        bv = b.float().expand(*a.shape[:-1], 1).reshape(-1).contiguous()
        out = div_rowbcast(a2, bv, scheme)
    else:
        af, bf = torch.broadcast_tensors(a.float(), b.float())
        out = div_elementwise(af.contiguous(), bf.contiguous(), scheme)
    return out.reshape(out_shape).to(a.dtype)


fused_rms_div.launches = 0
fused_softmax_div.launches = 0
div_rowbcast.launches = 0
div_elementwise.launches = 0
fused_rms_div.launches_by_depth = {}
fused_softmax_div.launches_by_depth = {}
div_rowbcast.launches_by_depth = {}
div_elementwise.launches_by_depth = {}
