"""Kernel-call spec of the port: block geometry and stage count.

The port of ``repro.kernels.spec``.  :class:`KernelSpec` carries a
kernel family's block geometry and its :class:`PipelineSpec`; every
wrapper of the log-domain matmul (K1) and of the row dividers (K2, K3,
K5) takes ``spec=`` and resolves it through :func:`resolve_spec`, the
one choke point.  Precedence, per field: an explicitly set field, else
the per-regime heuristic below.  There is no tuning cache: the
reference's ``TUNE_baseline.json`` holds TPU winners.

Stage counts on Hopper:

  * ``depth == 1`` -- the first formulation of each kernel: K1 stages
    each K block synchronously, K2/K3/K5 run one block per row (K5 one
    thread per element).
  * ``depth >= 2`` -- ``depth`` tiles in flight through ``cp.async``
    into a ring in shared memory: K1's K loop keeps ``depth`` raw x/w
    tiles in flight (the reference's ``log_matmul_pipelined``, K7), and
    the row dividers walk row slabs of ``bm`` rows with ``depth`` slabs
    in flight (``_rowwise_pipelined_call``, K8).  The stage count moves
    no bits: every depth computes the same sums in the same order.
  * ``depth is None`` -- deferred to the heuristic: the reference's
    default, :data:`budget.PIPELINE_BUFFERS` (2), unless a regime below
    says otherwise or the row is too wide for two slabs.  K1's default
    per regime is :data:`_MATMUL_DEPTH`, chosen by an A/B on an H100
    (``chip_smoke.py``, ``launch/k1_times.py --depth``; PERF.md).

K1's regime and block geometry are decided here and only here
(:func:`matmul_regime`, :func:`matmul_geometry`): the wrapper passes
both to ``csrc/log_matmul.cu``, which launches that regime's instance
and refuses a regime / geometry it did not compile for the shape, so
the shared-memory check (:func:`matmul_smem`) always checks the
instance the card runs.  An explicit ``bm`` / ``bn`` / ``bk`` must name
that geometry.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from typing import Optional, Sequence, Tuple

from repro_torch.kernels import budget

__all__ = [
    "PipelineSpec",
    "KernelSpec",
    "as_kernel_spec",
    "resolve_spec",
    "RESOLVED_FAMILIES",
    "MATMUL_REGIMES",
    "matmul_regime",
    "matmul_geometry",
    "matmul_smem",
    "row_smem",
    "MATMUL_DEPTHS",
    "deferred_depth",
]

#: families :func:`resolve_spec` resolves, with their ``shapes`` tuple:
#:   log_matmul          (m, n, k)
#:   fused_softmax       (rows, n)
#:   fused_rms           (rows, n)
#:   fused_div_rowbcast  (rows, n)
RESOLVED_FAMILIES = ("log_matmul", "fused_softmax", "fused_rms",
                     "fused_div_rowbcast")

# K1's regimes, in the order of csrc/log_matmul.cu's regime codes
MATMUL_REGIMES = ("block8", "decode", "chunk", "prefill")
# K1's instances in csrc/log_matmul.cu: regime -> (bm, bn, bk); the
# decode regime's depend on M (_decode_geometry)
_MATMUL_GEOMETRY = {"block8": (8, 8, 8), "chunk": (16, 32, 64),
                    "prefill": (32, 128, 16)}
# K1's stage count per regime when the spec defers it, from the A/B of
# launch/k1_times.py --depth on an H100 (PERF.md): depth 1 is the
# slowest wherever K has many blocks; prefill is 2-3% faster at 3 than
# at 2; JPEG's 8 x 8 products (one K block) are fastest at 1
_MATMUL_DEPTH = {"block8": 1,
                 "decode": budget.PIPELINE_BUFFERS,
                 "chunk": budget.PIPELINE_BUFFERS,
                 "prefill": 3}
# the lean kernel's per-warp reduction slots (csrc/log_matmul.cu
# RED_SLOTS x an int4)
_MATMUL_RED_BYTES = 8 * 16
# the stage counts csrc/log_matmul.cu instantiates
MATMUL_DEPTHS = (1, 2, 3, 4, 8)
# set by deferred_depth(): the depth every deferred spec resolves to
_DEFERRED_DEPTH: Optional[int] = None


@contextmanager
def deferred_depth(depth: Optional[int]):
    """While open, every spec that leaves its depth to the heuristic
    resolves to ``depth`` (None: the heuristic), so one run can be held
    against another at another stage count."""
    global _DEFERRED_DEPTH
    PipelineSpec(depth=depth)  # validates
    saved, _DEFERRED_DEPTH = _DEFERRED_DEPTH, depth
    try:
        yield
    finally:
        _DEFERRED_DEPTH = saved


@dataclass(frozen=True)
class PipelineSpec:
    """How many tiles a kernel keeps in flight."""

    #: tiles in flight per operand; 1 = the unpipelined form; None
    #: defers to :func:`resolve_spec`
    depth: Optional[int] = None

    def __post_init__(self):
        if self.depth is not None and not 1 <= int(self.depth) <= budget.MAX_DEPTH:
            raise ValueError(f"pipeline depth {self.depth} outside "
                             f"[1, {budget.MAX_DEPTH}]")


@dataclass(frozen=True)
class KernelSpec:
    """Block geometry and stage count of one kernel call.

    ``bm`` / ``bn`` / ``bk``: K1's output tile and K depth per stage;
    for the row dividers ``bm`` is the rows per slab.  ``None`` defers
    a field to :func:`resolve_spec`.
    """

    bm: Optional[int] = None
    bn: Optional[int] = None
    bk: Optional[int] = None
    pipeline: PipelineSpec = field(default_factory=PipelineSpec)

    @property
    def depth(self) -> int:
        """Concrete depth (deferred -> PIPELINE_BUFFERS)."""
        d = self.pipeline.depth
        return budget.PIPELINE_BUFFERS if d is None else int(d)

    def with_depth(self, depth: Optional[int]) -> "KernelSpec":
        return replace(self, pipeline=PipelineSpec(depth=depth))


def as_kernel_spec(spec: Optional[KernelSpec]) -> KernelSpec:
    """A wrapper's ``spec=`` argument, canonicalized (None -> defaults)."""
    if spec is None:
        return KernelSpec()
    if isinstance(spec, KernelSpec):
        return spec
    raise TypeError(f"spec must be a KernelSpec or None, got {spec!r}")


def matmul_regime(m: int, n: int) -> str:
    """K1's regime for an output of ``m`` x ``n``: ``block8`` (JPEG's
    8 x 8 products), ``decode`` (M <= 8), ``chunk`` (M <= 64: a
    continuous prefill tick) or ``prefill``."""
    if m <= 8 and n <= 8:
        return "block8"
    if m <= 8:
        return "decode"
    return "chunk" if m <= 64 else "prefill"


def matmul_geometry(m: int, n: int) -> Tuple[int, int, int]:
    """K1's compiled (bm, bn, bk) for an ``m`` x ``n`` output."""
    regime = matmul_regime(m, n)
    if regime == "decode":
        return _decode_geometry(m)
    return _MATMUL_GEOMETRY[regime]


def _decode_geometry(m: int) -> Tuple[int, int, int]:
    """The decode regime's instance for ``m`` <= 8 live rows: the rows
    rounded up to 1, 2, 4 or 8, 32 columns, K blocks of 128 (64 at 8
    rows, whose products and depth-8 ring would not fit at 128)."""
    rows = next(r for r in (1, 2, 4, 8) if r >= m)
    return rows, 32, 128 if rows <= 4 else 64


def matmul_smem(regime: str, bm: int, bn: int, bk: int, depth: int) -> int:
    """Shared memory of one K1 block of ``regime``.  Static: the LUT and
    the staged operands, 8 bytes each (the decode regime stages only x),
    plus the proof's reduction slots outside ``block8``.  Dynamic: the
    decode regime's ``bk`` x ``bm`` x ``bn`` f32 products, and at depth
    >= 2 the ring of ``depth`` raw f32 x and w tiles."""
    if regime not in MATMUL_REGIMES:
        raise KeyError(f"unknown log_matmul regime {regime!r}; have "
                       f"{MATMUL_REGIMES}")
    ring = depth * 4 * (bm * bk + bk * bn) if depth > 1 else 0
    if regime == "decode":
        return (4 * 256 + 8 * bk * bm + _MATMUL_RED_BYTES
                + 4 * bk * bm * bn + ring)
    static = 4 * 256 + 8 * bk * (bm + bn)
    if regime != "block8":
        static += _MATMUL_RED_BYTES
    return static + ring


def row_smem(bm: int, n: int, depth: int) -> int:
    """Shared memory of one row-divider block: the LUT, plus at depth
    >= 2 the ring of ``depth`` input slabs of ``bm`` rows of ``n``."""
    return 4 * 256 + (depth * bm * n * budget.ELEM_BYTES if depth > 1 else 0)


def _row_depth(n: int) -> int:
    """The deferred depth of a row divider: PIPELINE_BUFFERS, less where
    even one-row slabs at that depth would not fit one block."""
    depth = budget.PIPELINE_BUFFERS
    while depth > 1 and row_smem(1, n, depth) > budget.SMEM_PER_BLOCK:
        depth -= 1
    return depth


def _row_bm(n: int, depth: int) -> int:
    """Rows per slab: as many as keep ``depth`` slabs inside
    ROW_RING_BYTES (at least 1, at most MAX_ROW_BM), a multiple of the
    block's ROW_WARPS warps where there are that many."""
    rows = budget.ROW_RING_BYTES // max(1, depth * n * budget.ELEM_BYTES)
    rows = max(1, min(budget.MAX_ROW_BM, rows))
    if rows >= budget.ROW_WARPS:
        rows -= rows % budget.ROW_WARPS
    return rows


def resolve_spec(family: str, shapes: Sequence[int],
                 spec: Optional[KernelSpec] = None) -> KernelSpec:
    """Resolve a (possibly partial) spec to concrete geometry and depth.

    Per field: explicit > :func:`deferred_depth` > heuristic.
    Idempotent.  Raises on a K1
    geometry or depth that ``csrc/log_matmul.cu`` does not compile.
    """
    if family not in RESOLVED_FAMILIES:
        raise KeyError(f"unknown kernel family {family!r}; have "
                       f"{RESOLVED_FAMILIES}")
    ks = as_kernel_spec(spec)
    depth = ks.pipeline.depth
    if depth is None:
        depth = _DEFERRED_DEPTH
    if family == "log_matmul":
        m, n, _ = (int(s) for s in shapes)
        regime = matmul_regime(m, n)
        geom = matmul_geometry(m, n)
        bm, bn, bk = (g if v is None else int(v)
                      for v, g in zip((ks.bm, ks.bn, ks.bk), geom))
        if (bm, bn, bk) != geom:
            raise ValueError(f"log_matmul at M={m}, N={n} compiles "
                             f"(bm, bn, bk) = {geom}; got {(bm, bn, bk)}")
        depth = _MATMUL_DEPTH[regime] if depth is None else int(depth)
        if depth not in MATMUL_DEPTHS:
            raise ValueError(f"log_matmul compiles depths {MATMUL_DEPTHS}; "
                             f"got {depth}")
    else:
        _, n = (int(s) for s in shapes[:2])
        depth = _row_depth(n) if depth is None else int(depth)
        bm = _row_bm(n, depth) if ks.bm is None else int(ks.bm)
        if bm < 1:
            raise ValueError(f"{family}: rows per slab must be >= 1, got {bm}")
        bn, bk = ks.bn, ks.bk
    return replace(ks, bm=bm, bn=bn, bk=bk, pipeline=PipelineSpec(depth=depth))
