"""Kernel-call spec of the port: block geometry and stage count.

The port of ``repro.kernels.spec``.  :class:`KernelSpec` carries a
kernel family's block geometry and its :class:`PipelineSpec`; every
wrapper of the log-domain matmul (K1) and of the row dividers (K2, K3,
K5) takes ``spec=`` and resolves it through :func:`resolve_spec`, the
one choke point.  Precedence, per field: an explicitly set field, else
the per-regime heuristic below.  There is no tuning cache: the
reference's ``TUNE_baseline.json`` holds TPU winners.

Stage counts on Hopper:

  * ``depth == 1`` -- the unpipelined form: K1 stages each K block
    synchronously; K2/K3 read each row once onto the chip (shared
    memory under four warps, registers under one), a block walking its
    rows with none in flight ahead; K5 streams its rows 16 B a thread,
    as K6 and K9 / K10 do (:func:`int_geometry`).
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

The row dividers' geometry (K2/K3 at depth 1, K8 at depth >= 2) is
decided here and only here (:func:`row_geometry`): the rows per slab,
the warps on one row and the grid, from the blocks an SM is assumed to
hold.  The wrapper passes the three to ``csrc/fused_div.cu``, which
launches that grid and refuses a warp count it did not compile for the
op and a grid past the slabs or past what the card holds at once, so
:func:`row_smem` and the shared-memory check count the block the card
runs.

K4's geometry is decided here too (:func:`flash_geometry`): ``bk`` is
the cache chunk of its online softmax and ``bn`` the segment, the cache
slots one block folds before the segments are combined.  Both the
wrapper and the plain version take them from :func:`resolve_spec`, so
the plain version always runs the kernel's order.  K4 has one stage
count: it double-buffers its chunks (:data:`FLASH_DEPTH`).

The streaming kernels' geometry is decided here too (:func:`int_split`,
:func:`int_geometry`): the head, the 16 B vector body and the tail of a
call, the blocks an SM, the threads a block and the grid, which the
wrappers of K9 / K10 pass to ``csrc/rapid_int.cu`` and those of K6 and
(through :func:`row_geometry` at depth 1) K5 to ``csrc/fused_div.cu``;
each kernel refuses a block or thread count it did not compile, a grid
past one wave and a head that leaves its vector body misaligned.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field, replace
from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

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
    "RowGeometry",
    "row_geometry",
    "warp_rounds",
    "MATMUL_DEPTHS",
    "deferred_depth",
    "FLASH_CHUNK",
    "FLASH_MAX_SEGMENT_CHUNKS",
    "FLASH_DEPTH",
    "flash_geometry",
    "IntGeometry",
    "int_split",
    "int_geometry",
]

#: families :func:`resolve_spec` resolves, with their ``shapes`` tuple:
#:   log_matmul          (m, n, k)
#:   fused_softmax       (rows, n)
#:   fused_rms           (rows, n)
#:   fused_div_rowbcast  (rows, n)
#:   flash_attn          (rows, c): rows = batch x kv heads, c cache slots
RESOLVED_FAMILIES = ("log_matmul", "fused_softmax", "fused_rms",
                     "fused_div_rowbcast", "flash_attn")

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
# K4 (csrc/flash_attn.cu): cache slots a chunk (BC, one per lane of a
# warp), the most chunks one block's segment may hold (MAX_SEG_CHUNKS,
# one bit each in the block's live-chunk word), and its one stage count
# (chunk c + 1 in flight while chunk c is folded)
FLASH_CHUNK = 32
FLASH_MAX_SEGMENT_CHUNKS = 32
FLASH_DEPTH = 2
# K4 blocks one SM holds at once at G = 4 (h2o_danube_1_8b): 128 threads
# of 123 registers, four to the 65 536-register file.  Segments are sized
# so the grid is about one such wave (PERF.md: the A/B of segment
# lengths on an H100)
_FLASH_BLOCKS_PER_SM = 4
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


def flash_geometry(rows: int, c: int) -> Tuple[int, int]:
    """K4's (chunk, segment) in cache slots for ``rows`` (batch x kv
    head) rows of ``c`` slots: segments of whole chunks, the fewest
    chunks a segment that keep rows x segments within one wave of
    blocks on the card (one chunk a segment while the whole cache fits
    one wave, so a short live region is split as finely as it can be;
    at most :data:`FLASH_MAX_SEGMENT_CHUNKS`)."""
    n_chunks = max(1, -(-c // FLASH_CHUNK))
    wave = budget.SMS * _FLASH_BLOCKS_PER_SM
    seg_chunks = min(FLASH_MAX_SEGMENT_CHUNKS,
                     max(1, -(-max(1, rows) * n_chunks // wave)))
    return FLASH_CHUNK, seg_chunks * FLASH_CHUNK


class IntGeometry(NamedTuple):
    """One streaming call's geometry (:func:`int_geometry`): K9 / K10,
    K6, and K5 at depth 1."""

    #: blocks an SM holds (the launched instance's launch bounds)
    blocks_per_sm: int
    #: threads a block
    threads: int
    #: blocks the kernel launches, at most one wave
    grid: int
    #: index in 64 bits (from budget.INT_WIDE_PAIRS pairs)
    wide: bool


def int_split(total: int, *addresses: int) -> Tuple[int, int, int]:
    """(head, vectors, tail) of ``total`` elements of a streaming kernel
    (K9 / K10, K5 / K6) whose streamed operands and result start at the
    byte ``addresses`` (each 4 B aligned): ``head`` elements before the
    first index at which every address is 16 B aligned, then ``vectors``
    vectors of 4 elements, then a ``tail`` of fewer than 4.  Where the addresses are not congruent
    mod 16 no index aligns them all, and the head is the whole call."""
    if any(p % 4 for p in addresses):
        raise ValueError(f"addresses must be 4 B aligned, got {addresses}")
    if len({p % 16 for p in addresses}) > 1:
        return total, 0, 0
    head = min(total, (-addresses[0] % 16) // 4)
    vectors = (total - head) // 4
    return head, vectors, total - head - 4 * vectors


def int_geometry(total: int, sms: int, head: int = 0) -> IntGeometry:
    """A streaming kernel's geometry (K9 / K10, and K5 / K6, which
    compile the same block) for ``total`` elements with a head of
    ``head`` elements (:func:`int_split`) on a card of ``sms`` SMs:
    budget.INT_THREADS threads a block, budget.INT_BLOCKS_PER_SM blocks an
    SM, and a grid of one wave of them, or fewer where a thread would
    otherwise get no vector (or, past the vectors, no head or tail
    element); 64-bit indices from budget.INT_WIDE_PAIRS pairs."""
    threads = budget.INT_THREADS
    vectors = (total - head) // 4
    scalars = total - 4 * vectors
    want = max(1, -(-vectors // threads), -(-scalars // threads))
    grid = min(want, sms * budget.INT_BLOCKS_PER_SM)
    return IntGeometry(budget.INT_BLOCKS_PER_SM, threads, grid,
                       total >= budget.INT_WIDE_PAIRS)


def _resolve_flash(rows: int, c: int, ks: KernelSpec) -> KernelSpec:
    bk, bn = flash_geometry(rows, c)
    if ks.bk is not None and int(ks.bk) != bk:
        raise ValueError(f"flash_attn compiles a chunk of {bk} slots; got "
                         f"bk={ks.bk}")
    if ks.bn is not None:
        bn = int(ks.bn)
        if bn < bk or bn % bk or bn > FLASH_MAX_SEGMENT_CHUNKS * bk:
            raise ValueError(
                f"flash_attn compiles segments of 1 to "
                f"{FLASH_MAX_SEGMENT_CHUNKS} chunks of {bk} slots; got "
                f"bn={bn}")
    depth = ks.pipeline.depth
    if depth is not None and int(depth) != FLASH_DEPTH:
        raise ValueError(f"flash_attn compiles depth {FLASH_DEPTH}; got "
                         f"{depth}")
    return replace(ks, bm=None, bn=bn, bk=bk,
                   pipeline=PipelineSpec(depth=FLASH_DEPTH))


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


def row_smem(bm: int, n: int, depth: int, warps: int = 1) -> int:
    """Shared memory of one row-divider block, as the kernel allocates
    it: the LUT (static), and two fold buffers of LANE partial sums
    where ROW_WARPS warps share a row.  At depth 1 all of it is static:
    where four warps share a row, K2/K3 also keep two copies of a row's
    held rounds (ROW_HOLD_N elements), from which they divide 16 B a
    thread; the one-warp form and K5 have neither.  At depth >= 2 (K8)
    the folds, then the ring of ``depth`` slabs of ``bm`` rows of
    ``n``, and for the row broadcast (``warps`` 0) the ring of each
    slab's ``bm`` denominators, all dynamic."""
    lut = 4 * 256
    fold = budget.LANE * budget.ELEM_BYTES if warps == budget.ROW_WARPS else 0
    if depth == 1:
        held = budget.ROW_HOLD_N * budget.ELEM_BYTES if fold else 0
        return lut + 2 * fold + 2 * held
    denoms = depth * bm * budget.ELEM_BYTES if warps == 0 else 0
    return lut + 2 * fold + depth * bm * n * budget.ELEM_BYTES + denoms


def _row_depth(n: int) -> int:
    """The deferred depth of a row divider: PIPELINE_BUFFERS, less where
    even one-row slabs at that depth would not fit one block."""
    depth = budget.PIPELINE_BUFFERS
    while depth > 1 and (row_smem(1, n, depth, budget.ROW_WARPS)
                         > budget.SMEM_PER_BLOCK):
        depth -= 1
    return depth


class RowGeometry(NamedTuple):
    """One row-divider call's geometry (:func:`row_geometry`)."""

    #: rows per slab
    bm: int
    #: warps on one row: ROW_WARPS (one thread per grouping lane), 1 (a
    #: warp per row), or 0 (the row broadcast's flat walk, where no warp
    #: owns a row)
    warps: int
    #: blocks one SM is assumed to hold at once
    blocks_per_sm: int
    #: blocks the kernel launches: the slabs, at most budget.SMS x
    #: blocks_per_sm (the kernel refuses a grid its card cannot hold at
    #: once); K5 at depth 1: :func:`int_geometry`'s
    grid: int
    #: shared memory of one block (:func:`row_smem`)
    smem: int
    #: K2/K3 at depth 1 only: the row is wider than a thread holds, so
    #: the rounds past the held ones are streamed (read again from L2
    #: for the divides)
    streams: bool = False


_ROW_FAMILIES = ("fused_rms", "fused_softmax", "fused_div_rowbcast")


def _blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes one SM holds at once, at most the
    kernel's launch bounds promise (0: not even one)."""
    unit = (budget.round_up(smem, budget.SMEM_ALLOC_UNIT)
            + budget.SMEM_RESERVED_PER_BLOCK)
    return min(budget.ROW_BLOCKS_PER_SM, budget.SMEM_PER_SM // unit)


def warp_rounds(n: int) -> int:
    """Rounds of LANE that the one-warp form of K2/K3 (depth 1) holds
    for a row of ``n``: 1, 2 or 4, so a warp holds WARP_HOLD / (4 x
    rounds) such rows at once (``csrc/fused_div.cu`` warp_rounds)."""
    rounds = -(-max(1, n) // budget.LANE)
    return 1 if rounds <= 1 else 2 if rounds <= 2 else 4


def _hold_geometry(family: str, rows: int, n: int, bm: Optional[int],
                   head: int) -> RowGeometry:
    """Depth 1.  K5: the stream of :func:`int_geometry` over the ``rows``
    x ``n`` elements with a head of ``head`` (no warp owns a row; ``bm``
    is not used, 1 unless given).  K2/K3:
    four warps a row (one thread a grouping lane, the row held in shared
    memory) from ROW_WIDE_N elements, or where the rows, a block each,
    fit one wave of the four-warp form (ROW_HOLD_BLOCKS_PER_SM an SM);
    otherwise a warp a row, each warp holding WARP_HOLD / (4 x
    :func:`warp_rounds`) rows at once in registers and a block
    ROW_WARPS such groups (the whole row: one warp only below
    ROW_WIDE_N).  The grid: a block a slab up to one wave; past it a
    block walks slabs g, g + grid, ...  Four-warp rows past ROW_HOLD_N
    are streamed (``streams``)."""
    if family == "fused_div_rowbcast":
        bm = 1 if bm is None else bm
        g = int_geometry(rows * n, budget.SMS, head)
        return RowGeometry(bm, 0, g.blocks_per_sm, g.grid,
                           row_smem(bm, n, 1, 0))
    wide = (n >= budget.ROW_WIDE_N
            or rows <= budget.SMS * budget.ROW_HOLD_BLOCKS_PER_SM)
    if wide:
        warps, per_sm = budget.ROW_WARPS, budget.ROW_HOLD_BLOCKS_PER_SM
    else:
        warps, per_sm = 1, budget.ROW_BLOCKS_PER_SM
    if bm is None:
        bm = 1 if wide else (budget.ROW_WARPS * budget.WARP_HOLD
                             // (4 * warp_rounds(n)))
    grid = min(-(-rows // bm), budget.SMS * per_sm)
    return RowGeometry(bm, warps, per_sm, grid, row_smem(bm, n, 1, warps),
                       wide and n > budget.ROW_HOLD_N)


@lru_cache(maxsize=1024)
def row_geometry(family: str, rows: int, n: int, depth: int,
                 bm: Optional[int] = None, head: int = 0) -> RowGeometry:
    """The geometry of a row divider over ``rows`` rows of ``n`` at
    stage count ``depth``; ``bm``, where given, is kept.

    At depth 1, K2/K3 read each row once onto the chip and K5 streams
    the elements 16 B a thread, after ``head`` single ones
    (:func:`int_split`; :func:`_hold_geometry`).  At depth >= 2 (K8):

    * warps on a row: rms / softmax rows from ROW_WIDE_N elements are
      shared by ROW_WARPS warps, one thread per grouping lane, and so
      are narrower ones where the rows, a block each, fit one wave (few
      rows: latency bounds them, and four warps a row shorten each
      row's chain of divides); otherwise a narrow row takes a warp; the
      row broadcast walks its slab flat;
    * rows per slab, at most MAX_ROW_BM and, past one row, within
      ROW_RING_BYTES for ``depth`` slabs: the fewest that keep every
      thread of a block busy (a wide row; a row a warp; 16 B a thread
      of the flat walk) and let one wave of blocks -- budget.SMS x the
      blocks an SM holds at that slab -- cover the rows; where none
      does, the fewest that put the most rows in one wave;
    * the grid: one block a slab up to that wave.  Only where the slabs
      outnumber it does a block walk several, ``depth`` of them in
      flight.
    """
    if family not in _ROW_FAMILIES:
        raise KeyError(f"unknown row-divider family {family!r}; have "
                       f"{_ROW_FAMILIES}")
    rows = max(1, rows)
    if depth == 1:
        return _hold_geometry(family, rows, n, bm, head)
    if family == "fused_div_rowbcast":
        warps = 0
    elif n >= budget.ROW_WIDE_N or rows <= budget.SMS * \
            _blocks_per_sm(row_smem(1, n, depth, budget.ROW_WARPS)):
        warps = budget.ROW_WARPS
    else:
        warps = 1
    if bm is None:
        width = max(1, n)
        cap = budget.ROW_RING_BYTES // (depth * width * budget.ELEM_BYTES)
        cap = max(1, min(budget.MAX_ROW_BM, rows, cap))
        least = {budget.ROW_WARPS: 1, 1: budget.ROW_WARPS,
                 0: -(-4 * budget.ROW_THREADS // width)}[warps]
        bm, most = min(cap, least), 0  # most: rows one wave holds at bm
        for b in range(bm, cap + 1):
            wave = budget.SMS * _blocks_per_sm(row_smem(b, n, depth, warps))
            if wave * b >= rows:
                bm = b
                break
            if wave * b > most:
                bm, most = b, wave * b
    smem = row_smem(bm, n, depth, warps)
    per_sm = _blocks_per_sm(smem)
    grid = min(-(-rows // bm), budget.SMS * max(1, per_sm))
    return RowGeometry(bm, warps, per_sm, grid, smem)


def resolve_spec(family: str, shapes: Sequence[int],
                 spec: Optional[KernelSpec] = None) -> KernelSpec:
    """Resolve a (possibly partial) spec to concrete geometry and depth.

    Per field: explicit > :func:`deferred_depth` > heuristic.
    Idempotent.  Raises on a K1 or K4 geometry or depth that
    ``csrc/log_matmul.cu`` / ``csrc/flash_attn.cu`` does not compile
    (K4 has one depth, which :func:`deferred_depth` does not move).
    """
    if family not in RESOLVED_FAMILIES:
        raise KeyError(f"unknown kernel family {family!r}; have "
                       f"{RESOLVED_FAMILIES}")
    ks = as_kernel_spec(spec)
    if family == "flash_attn":
        rows, c = (int(s) for s in shapes[:2])
        return _resolve_flash(rows, c, ks)
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
        rows, n = (int(s) for s in shapes[:2])
        depth = _row_depth(n) if depth is None else int(depth)
        if ks.bm is not None and int(ks.bm) < 1:
            raise ValueError(f"{family}: rows per slab must be >= 1, got "
                             f"{ks.bm}")
        bm = row_geometry(family, rows, n, depth,
                          None if ks.bm is None else int(ks.bm)).bm
        bn, bk = ks.bn, ks.bk
    return replace(ks, bm=bm, bn=bn, bk=bk, pipeline=PipelineSpec(depth=depth))
