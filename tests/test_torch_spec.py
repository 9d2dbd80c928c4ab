"""The port's kernel spec (``repro_torch.kernels.spec``) and its stage
counts on the CPU.

``resolve_spec`` and ``PipelineSpec`` validation; the shared-memory plan
check (``budget.check_smem``); and that the stage count moves no bits:
on the CPU every wrapper runs its plain version at any depth, and the
results equal the reference's.  The reference's own depth >= 2 Pallas
arms raise on this jax (``pltpu.TPUMemorySpace`` is gone; ROADMAP rule
1), so its arms here are the ``jnp`` oracle and the depth-1 Pallas
kernel in interpret mode, which the reference holds bit-exact against
its depth >= 2 form (``log_matmul.py:19-27``).

Tolerances: K1 bit-equal to the ``jnp`` scan at chunk 1 and to the
depth-1 Pallas kernel (one K block for K <= 512, so the same order);
K5 bit-equal to the reference's depth-1 Pallas arm; K2/K3 bit-equal to
the reference once fed its denominator, and within 2 (rms) / 4 (softmax)
ulp end to end (XLA groups the row sum its own way; ROADMAP §3).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (assert_same_bits, bits, randn,  # noqa: E402
                            special_sample, ulp_diff)
from repro.core import backend as jbe  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro.kernels.fused_div import ref as jfd  # noqa: E402
from repro.kernels.fused_div.ops import fused_elementwise_div as jdiv  # noqa: E402
from repro.kernels.log_matmul.ops import log_matmul as jlog_matmul  # noqa: E402
from repro.kernels.spec import KernelSpec as JKernelSpec  # noqa: E402
from repro.kernels.spec import PipelineSpec as JPipelineSpec  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.kernels import budget  # noqa: E402
from repro_torch.kernels import launch_counts_by_depth  # noqa: E402
from repro_torch.kernels.fused_div import ref as tref  # noqa: E402
from repro_torch.kernels.fused_div.ops import (  # noqa: E402
    div_rowbcast, fused_rms_div, fused_softmax_div)
from repro_torch.kernels.log_matmul.ops import log_matmul  # noqa: E402
from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,  # noqa: E402
                                      as_kernel_spec, matmul_geometry,
                                      matmul_regime, matmul_smem,
                                      resolve_spec, row_geometry, row_smem,
                                      warp_rounds)

T = torch.from_numpy
_JDEPTH1 = JKernelSpec(pipeline=JPipelineSpec(depth=1))


def _d(depth, **kw):
    return KernelSpec(pipeline=PipelineSpec(depth=depth), **kw)


# --------------------------------------------------------------------------
# PipelineSpec / KernelSpec / resolve_spec
# --------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 9, -1])
def test_pipeline_depth_outside_range_raises(depth):
    with pytest.raises(ValueError, match="outside"):
        PipelineSpec(depth=depth)


def test_deferred_depth_is_pipeline_buffers():
    assert budget.PIPELINE_BUFFERS == 2
    assert PipelineSpec().depth is None
    assert KernelSpec().depth == 2
    assert KernelSpec().with_depth(3).depth == 3
    assert resolve_spec("fused_rms", (512, 2560)).depth == 2
    # K1's prefill regime defers to its own A/B winner, 3 (spec.py)
    assert resolve_spec("log_matmul", (512, 6912, 2560)).depth == 3
    assert resolve_spec("log_matmul", (4, 2560, 2560)).depth == 2


def test_as_kernel_spec():
    assert as_kernel_spec(None) == KernelSpec()
    ks = _d(3)
    assert as_kernel_spec(ks) is ks
    with pytest.raises(TypeError):
        as_kernel_spec((8, 128, 128))


@pytest.mark.parametrize("m,n,geom,depth", [
    (4, 2560, (4, 32, 128), 2),     # decode: the live rows, 128-deep K blocks
    (1, 2560, (1, 32, 128), 2),     # decode, one row
    (2, 640, (2, 32, 128), 2),      # decode, two rows
    (3, 6912, (4, 32, 128), 2),     # decode, 3 rows on the 4-row instance
    (5, 2560, (8, 32, 64), 2),      # decode, 5 rows on the 8-row instance
    (8, 2560, (8, 32, 64), 2),      # decode, 8 rows: 64-deep K blocks
    (9, 2560, (16, 32, 64), 2),     # chunk from 9 rows
    (64, 2560, (16, 32, 64), 2),    # continuous prefill chunk
    (65, 2560, (32, 128, 16), 3),   # prefill from 65 rows
    (512, 6912, (32, 128, 16), 3),  # prefill / train
    (8, 8, (8, 8, 8), 1),           # JPEG's 8 x 8 blocks: depth 1
    (3, 5, (8, 8, 8), 1),           # ... and any output within 8 x 8
])
def test_resolve_log_matmul_regimes(m, n, geom, depth):
    ks = resolve_spec("log_matmul", (m, n, 2560))
    assert (ks.bm, ks.bn, ks.bk) == geom == matmul_geometry(m, n)
    assert ks.depth == depth
    assert resolve_spec("log_matmul", (m, n, 2560), ks) == ks  # idempotent


def test_resolve_explicit_fields_win():
    ks = resolve_spec("log_matmul", (64, 2560, 2560), _d(4))
    assert ks.depth == 4 and (ks.bm, ks.bn, ks.bk) == (16, 32, 64)
    assert resolve_spec("fused_rms", (512, 2560), _d(3, bm=5)).bm == 5
    assert resolve_spec("fused_softmax", (9, 128), _d(1)).depth == 1


def test_resolve_rejects_what_the_card_does_not_compile():
    with pytest.raises(ValueError, match="compiles"):
        resolve_spec("log_matmul", (512, 512, 512), KernelSpec(bm=128))
    with pytest.raises(ValueError, match="depths"):
        resolve_spec("log_matmul", (512, 512, 512), _d(5))
    with pytest.raises(KeyError):
        resolve_spec("rapid_mul", (4, 512))
    with pytest.raises(ValueError, match="compiles a chunk"):
        resolve_spec("flash_attn", (32, 512), KernelSpec(bk=16))
    for bn in (16, 48, 33 * 32):
        with pytest.raises(ValueError, match="compiles segments"):
            resolve_spec("flash_attn", (32, 512), KernelSpec(bn=bn))
    with pytest.raises(ValueError, match="compiles depth"):
        resolve_spec("flash_attn", (32, 512), _d(3))
    with pytest.raises(ValueError, match="rows per slab"):
        resolve_spec("fused_rms", (4, 80), KernelSpec(bm=0))


def _wave_rows(family, rows, n, depth, bm):
    """Rows one wave of K8 blocks holds at ``bm`` rows a slab."""
    g = row_geometry(family, rows, n, depth, bm)
    return budget.SMS * g.blocks_per_sm * bm


@pytest.mark.parametrize("n", [12, 128, 1000, 2560, 8192])
@pytest.mark.parametrize("depth", [2, 3, 4, 8])
def test_row_slabs_fit_the_ring(n, depth):
    """K8's rows per slab at 4096 rows: at most MAX_ROW_BM and, past one
    row, within ROW_RING_BYTES for ``depth`` slabs; every warp of a block
    has a row (a warp a row below ROW_WIDE_N, the four warps on one row
    from it); and the fewest that let one wave cover the rows, or, where
    none does, the fewest that put the most rows in one wave."""
    rows = 4096
    ks = resolve_spec("fused_rms", (rows, n), _d(depth))
    geom = row_geometry("fused_rms", rows, n, depth)
    assert ks.bm == geom.bm and 1 <= ks.bm <= budget.MAX_ROW_BM
    ring = depth * ks.bm * n * 4
    assert ks.bm == 1 or ring <= budget.ROW_RING_BYTES
    cap = max(1, min(budget.MAX_ROW_BM,
                     budget.ROW_RING_BYTES // (depth * n * 4)))
    if n >= budget.ROW_WIDE_N:
        assert geom.warps == budget.ROW_WARPS
    else:
        assert geom.warps == 1 and ks.bm >= min(cap, budget.ROW_WARPS)
    held = {b: _wave_rows("fused_rms", rows, n, depth, b)
            for b in range(1, cap + 1)}
    if held[ks.bm] >= rows:  # one wave: the fewest rows a slab that do it
        assert all(held[b] < rows for b in held
                   if b < ks.bm and (b >= budget.ROW_WARPS or n >= 512))
    else:  # blocks walk slabs: no slab size holds the rows in one wave
        assert max(held.values()) == held[ks.bm] < rows
        assert geom.grid < -(-rows // ks.bm)


# K8's geometry where the paths launch it: (family, rows, n) -> (rows a
# slab, warps a row, blocks) at depths 2 and 3
_PATH_GEOMETRY = [
    ("fused_rms", 1, 2560, (1, 4, 1)),        # one row
    ("fused_rms", 4, 2560, (1, 4, 4)),        # a decode step's norms
    ("fused_rms", 64, 2560, (1, 4, 64)),      # a continuous prefill tick
    ("fused_rms", 512, 2560, (1, 4, 512)),    # lockstep prefill, train
    ("fused_softmax", 16384, 128, (16, 1, 1024)),  # prefill attention
    ("fused_softmax", 33, 130, (1, 4, 33)),   # a ragged edge: few rows
    ("fused_div_rowbcast", 2048, 80, (7, 0, 293)),     # a 64-token chunk
    ("fused_div_rowbcast", 266240, 80, None),  # long prefill: blocks walk
]


@pytest.mark.parametrize("family,rows,n,want", _PATH_GEOMETRY)
@pytest.mark.parametrize("depth", [2, 3])
def test_row_geometry_at_the_path_shapes(family, rows, n, want, depth):
    """The grid covers the card where the rows allow: 4 wide rows are 4
    blocks, 64 are 64, 512 fill more than one block an SM; a slab is one
    wide row, a row a warp of the narrow ones, 16 B a thread of the flat
    walk; only the long prefill's slabs outnumber a wave."""
    geom = row_geometry(family, rows, n, depth)
    if want is None:
        assert geom.warps == 0 and geom.bm >= 16
        assert geom.grid == budget.SMS * geom.blocks_per_sm
        assert -(-rows // geom.bm) > depth * geom.grid
    else:
        assert (geom.bm, geom.warps, geom.grid) == want
    assert resolve_spec(family, (rows, n), _d(depth)).bm == geom.bm


@pytest.mark.parametrize("rows", [1, 4, 64, 512, 16384])
@pytest.mark.parametrize("n", [80, 128, 130, 2560, 6912])
def test_row_geometry_rule(rows, n):
    """For each op at depths 2 and 3: the warps a row, the grid (the
    slabs, at most one wave of the blocks an SM holds at that shared
    memory), the block's shared memory within the card's, and a block
    walking several slabs only where no slab size holds the rows in one
    wave."""
    for family in ("fused_rms", "fused_softmax", "fused_div_rowbcast"):
        for depth in (2, 3):
            g = row_geometry(family, rows, n, depth)
            if family == "fused_div_rowbcast":
                assert g.warps == 0
            else:  # four warps a row where wide, or where a wave holds
                # the rows at one block each
                one = row_smem(1, n, depth, budget.ROW_WARPS)
                wave = budget.SMS * min(
                    budget.ROW_BLOCKS_PER_SM, budget.SMEM_PER_SM
                    // (budget.round_up(one, 128) + 1024))
                wide = n >= budget.ROW_WIDE_N or rows <= wave
                assert g.warps == (budget.ROW_WARPS if wide else 1)
            assert 1 <= g.bm <= min(rows, budget.MAX_ROW_BM)
            assert g.smem == row_smem(g.bm, n, depth, g.warps)
            assert g.smem <= budget.SMEM_PER_BLOCK
            unit = budget.round_up(g.smem, 128) + 1024
            assert 1 <= g.blocks_per_sm <= budget.ROW_BLOCKS_PER_SM
            assert g.blocks_per_sm * unit <= budget.SMEM_PER_SM
            assert (g.blocks_per_sm == budget.ROW_BLOCKS_PER_SM
                    or (g.blocks_per_sm + 1) * unit > budget.SMEM_PER_SM)
            slabs = -(-rows // g.bm)
            assert g.grid == min(slabs, budget.SMS * g.blocks_per_sm)
            if g.warps == budget.ROW_WARPS and rows <= budget.SMS:
                assert g.grid == rows  # a block a wide row
            if slabs > g.grid:
                cap = max(1, min(budget.MAX_ROW_BM, rows,
                                 budget.ROW_RING_BYTES // (depth * n * 4)))
                assert all(_wave_rows(family, rows, n, depth, b) < rows
                           for b in range(1, cap + 1))


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("warps", [0, 1, 4])
def test_row_smem_counts_what_the_kernel_allocates(depth, warps):
    """``row_smem`` is csrc/fused_div.cu's allocation: the 1 KB LUT
    (static); at depth 1, where four warps share a row, K2/K3's two fold
    buffers of 128 partials and two copies of the 4096 held elements
    (static; the one-warp form and K5 have neither); at depth >= 2 (K8,
    dynamic) the two fold buffers, then the ring of ``depth`` slabs, and
    the row broadcast's ring of ``depth`` x ``bm`` denominators.  The
    card test ``test_cuda_row_smem_is_the_kernels`` holds the kernel's
    own figure to it."""
    for bm, n in ((1, 2560), (16, 128), (7, 80), (3, 130)):
        if depth == 1:
            want = 1024 + (1024 + 2 * 4096 * 4 if warps == 4 else 0)
        else:
            want = (1024 + (1024 if warps == 4 else 0) + depth * bm * n * 4
                    + (depth * bm * 4 if warps == 0 else 0))
        assert row_smem(bm, n, depth, warps) == want
    for rows, n in ((4, 2560), (512, 2560), (16384, 128), (266240, 80),
                    (64, 6912)):
        for family in ("fused_rms", "fused_softmax", "fused_div_rowbcast"):
            g = row_geometry(family, rows, n, depth)
            if depth > 1 and (g.warps == 0) != (warps == 0):
                continue
            budget.check_smem(g.smem, family)


def test_row_geometry_keeps_an_explicit_bm():
    for family in ("fused_rms", "fused_softmax", "fused_div_rowbcast"):
        g = row_geometry(family, 1000, 2560, 3, 5)
        assert g.bm == 5
        assert g.smem == row_smem(5, 2560, 3, g.warps)
        assert g.grid == min(200, budget.SMS * g.blocks_per_sm)
        ks = resolve_spec(family, (1000, 2560), _d(3, bm=5))
        assert ks.bm == 5 and resolve_spec(family, (1000, 2560), ks) == ks
        one = row_geometry(family, 12000, 20, 8, 1)
        assert one.bm == 1 and one.grid == budget.SMS * one.blocks_per_sm
        assert 12000 > 8 * one.grid  # each block walks more than 8 slabs
    with pytest.raises(KeyError):
        row_geometry("log_matmul", 4, 2560, 2)


def test_deferred_row_depth_falls_back_where_two_slabs_do_not_fit():
    # a 40 000-wide f32 row is 160 KB: two of them exceed the 227 KB
    assert resolve_spec("fused_rms", (4, 40_000)).depth == 1
    assert resolve_spec("fused_rms", (4, 20_000)).depth == 2


# K2/K3's geometry at depth 1 where the paths and the deferred-depth
# fallback meet it: (family, rows, n) -> (rows a block, warps a row,
# grid, blocks an SM, streams)
_HOLD_GEOMETRY = [
    ("fused_rms", 1, 2560, (1, 4, 1, 4, False)),         # one row
    ("fused_rms", 4, 2560, (1, 4, 4, 4, False)),         # a decode step
    ("fused_rms", 64, 2560, (1, 4, 64, 4, False)),       # a prefill tick
    ("fused_rms", 512, 2560, (1, 4, 512, 4, False)),     # prefill, train
    ("fused_softmax", 16384, 128, (16, 1, 1024, 8, False)),  # prefill attn
    ("fused_softmax", 33, 130, (1, 4, 33, 4, False)),    # a ragged edge
    ("fused_rms", 4, 40_000, (1, 4, 4, 4, True)),        # past two slabs
    ("fused_softmax", 9001, 200, (8, 1, 1056, 8, False)),   # blocks walk
    ("fused_rms", 1000, 601, (1, 4, 528, 4, False)),     # blocks walk
    ("fused_div_rowbcast", 2048, 80, (1, 0, 160, 4, False)),  # K5: a stream
]


@pytest.mark.parametrize("family,rows,n,want", _HOLD_GEOMETRY)
def test_row_geometry_at_depth_one(family, rows, n, want):
    """Depth 1 is planned as K8 is: four warps a wide row, or where the
    rows fit one wave of the four-warp form; a warp a row of narrow rows
    past it, 16 rows of 128 a block (a warp holds four); a grid of one
    block a slab up to one wave; the 40 000-wide rows of the deferred
    depth's fallback streamed.  K5 streams 16 B a thread, on
    ``int_geometry``'s grid: a vector a thread up to one wave."""
    g = row_geometry(family, rows, n, 1)
    assert (g.bm, g.warps, g.grid, g.blocks_per_sm, g.streams) == want
    assert g.smem == row_smem(g.bm, n, 1, g.warps)
    assert resolve_spec(family, (rows, n), _d(1)).bm == g.bm
    if n == 40_000:  # the depth the spec defers to at this width
        assert resolve_spec(family, (rows, n)).depth == 1


@pytest.mark.parametrize("rows", [1, 4, 33, 528, 529, 16384, 20000])
def test_row_geometry_rule_at_depth_one(rows):
    """For rms and softmax at depth 1, over widths around every edge:
    four warps from ROW_WIDE_N or where the rows fit the four-warp
    wave (ROW_HOLD_BLOCKS_PER_SM an SM), one row a slab, streamed past
    ROW_HOLD_N; else a warp a row under ROW_BLOCKS_PER_SM, holding
    WARP_HOLD / (4 x rounds) rows of 1, 2 or 4 rounds; the grid the
    slabs, at most one wave; and an explicit slab kept."""
    for n in (1, 30, 128, 129, 200, 256, 300, 511, 512, 2560, 4096, 4097,
              40_000):
        for family in ("fused_rms", "fused_softmax"):
            g = row_geometry(family, rows, n, 1)
            wide = (n >= budget.ROW_WIDE_N
                    or rows <= budget.SMS * budget.ROW_HOLD_BLOCKS_PER_SM)
            rounds = -(-n // budget.LANE)
            if wide:
                assert (g.warps, g.bm, g.blocks_per_sm) == (
                    budget.ROW_WARPS, 1, budget.ROW_HOLD_BLOCKS_PER_SM)
                assert g.streams == (n > budget.ROW_HOLD_N)
                assert g.streams == (rounds > budget.ROW_HOLD_ROUNDS)
            else:
                held = warp_rounds(n)
                assert held in (1, 2, 4) and held >= rounds > held // 2
                assert (g.warps, g.blocks_per_sm) == (
                    1, budget.ROW_BLOCKS_PER_SM)
                assert g.bm == budget.ROW_WARPS * budget.WARP_HOLD // (
                    4 * held)
                assert not g.streams
            assert 1 <= g.grid == min(-(-rows // g.bm),
                                      budget.SMS * g.blocks_per_sm)
            assert g.smem == 1024 + (
                1024 + 2 * budget.ROW_HOLD_N * 4 if wide else 0)
            one = row_geometry(family, rows, n, 1, 3)
            assert one.bm == 3 and one.warps == g.warps
            assert one.grid == min(-(-rows // 3), budget.SMS * g.blocks_per_sm)


# --------------------------------------------------------------------------
# K2/K3 at depth 1: the kernel's orders of summation, emulated
# --------------------------------------------------------------------------

def _warp_fold(s):
    """The steps h = 16 .. 1 as ``__shfl_down_sync``: lane l adds lane
    l + h (its own value where l + h > 31); lane 0's sum."""
    lanes = torch.arange(32)
    for h in (16, 8, 4, 2, 1):
        src = torch.where(lanes + h < 32, lanes + h, lanes)
        s = s + s[:, src]
    return s[:, 0]


def _chain(terms, idx, held):
    """One chain a column of ``idx`` [rounds, lanes] (element indices of
    each round), as the kernel runs it: from +0, the first ``held``
    rounds read onto the chip (shared memory under four warps,
    registers under one) before the first add, the rest streamed; an
    index past the row adds the padding's +0 (zero-filled, or not
    loaded)."""
    n = terms.shape[1]

    def load(k):
        j = idx[k]
        return torch.where(j < n, terms[:, j.clamp(max=n - 1)],
                           torch.zeros(()))

    regs = [load(k) for k in range(min(held, len(idx)))]
    p = torch.full((terms.shape[0], idx.shape[1]), 0.0)
    for v in regs:
        p = p + v
    for k in range(len(regs), len(idx)):
        p = p + load(k)
    return p


def _four_warp_sum(terms, held):
    """Four warps a row: thread t sums grouping lane t's elements t +
    128 k; the fold buffer's h = 64 and h = 32, then the shuffles."""
    rounds = -(-terms.shape[1] // 128)
    idx = torch.arange(128)[None] + 128 * torch.arange(rounds)[:, None]
    f = _chain(terms, idx, held)
    return _warp_fold((f[:, :32] + f[:, 64:96]) + (f[:, 32:64] + f[:, 96:]))


def _one_warp_sum(terms, held):
    """A warp a row: lane l holds grouping lanes l + 32 c (c = 0..3),
    element 128 k + 32 c + l; h = 64 and h = 32 in registers, then the
    shuffles."""
    rounds = -(-terms.shape[1] // 128)
    p = [_chain(terms, 32 * c + torch.arange(32)[None]
                + 128 * torch.arange(rounds)[:, None], held)
         for c in range(4)]
    return _warp_fold((p[0] + p[2]) + (p[1] + p[3]))


def _special_rows(n):
    """Rows of n: normals with special operands scattered (0, -0,
    +-inf, NaN, subnormals, the overflow edge), all -0, subnormals and
    -0 only, an inf of each sign, a NaN, and plain normals."""
    rng = np.random.default_rng(n)
    x = randn(rng, 6, n, scale=3.0)
    mask = rng.random(n) < 0.05
    mask[0] = True
    x[0, mask] = special_sample(rng, max(int(mask.sum()), 18))[:mask.sum()]
    x[1] = -0.0
    x[2] = rng.choice(np.array([1e-40, -1e-42, 1e-45, -0.0], np.float32), n)
    x[3, n // 2] = np.inf
    x[3, n // 3] = -np.inf
    x[4, n // 4] = np.nan
    return T(x)


@pytest.mark.parametrize("n", [1, 31, 80, 127, 128, 130, 2560, 40_000])
@pytest.mark.parametrize("form", ["four_warp", "one_warp", "streaming"])
def test_depth_one_sum_orders_are_lane_sums(form, n):
    """Each order of csrc/fused_div.cu's depth-1 kernel gives
    ``ref.lane_sum``'s bits, for the softmax sum and the rms sum of
    squares: four warps holding ROW_HOLD_ROUNDS rounds (past them,
    streamed: the 40 000-wide rows), one warp's lane mapping at
    ``warp_rounds(n)`` held rounds (the kernel runs it below ROW_WIDE_N;
    wider, the same order), and the streaming form with every round
    past the first streamed."""
    x = _special_rows(n)
    for terms in (x, x * x):
        want = tref.lane_sum(tref.pad_lanes(terms))[:, 0]
        if form == "four_warp":
            got = _four_warp_sum(terms, budget.ROW_HOLD_ROUNDS)
        elif form == "one_warp":
            got = _one_warp_sum(terms, warp_rounds(n))
        else:
            got = _four_warp_sum(terms, 1)
        assert_same_bits(got.numpy(), want.numpy())
    # a row of -0 sums to +0, as the reference's sum does, at every width
    assert bits(tref.lane_sum(tref.pad_lanes(x[1:2])).numpy())[0, 0] == 0


def test_check_smem_refuses_the_card_limit():
    budget.check_smem(budget.SMEM_PER_BLOCK)
    with pytest.raises(ValueError, match="exceeds"):
        budget.check_smem(budget.SMEM_PER_BLOCK + 1)
    # every K1 instance fits, the depth-8 arm included
    for m, n in ((4, 2560), (512, 2560), (8, 8)):
        assert matmul_smem(matmul_regime(m, n), *matmul_geometry(m, n),
                           8) <= budget.SMEM_PER_BLOCK
    assert matmul_smem("block8", 8, 8, 8, 1) <= budget.STATIC_SMEM_MAX
    # the depth-8 row slabs of an 8192-wide row do not: refused on the
    # CPU too, before any launch
    assert row_smem(1, 8192, 8) > budget.SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="exceeds"):
        fused_rms_div(torch.ones(4, 8192), 1e-6, "rapid9", spec=_d(8))
    out = fused_rms_div(torch.ones(4, 8192), 1e-6, "rapid9", spec=_d(4))
    assert out.shape == (4, 8192)


@pytest.mark.parametrize("m,n", [(1, 640), (2, 2560), (4, 2560), (8, 6912),
                                 (64, 2560), (512, 6912), (8, 8)])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
def test_matmul_smem_of_every_instance(m, n, depth):
    """The plan of each compiled K1 instance, within the card's 227 KB
    and its static part within the 48 KB a kernel may declare.  Static:
    the LUT, 8 bytes per staged operand (the decode regime stages only
    x) and the lean regimes' 8 reduction slots of 16 bytes; dynamic: the
    decode regime's f32 products and the ring at depth >= 2."""
    regime = matmul_regime(m, n)
    bm, bn, bk = matmul_geometry(m, n)
    ring = depth * 4 * (bm * bk + bk * bn) if depth > 1 else 0
    if regime == "decode":
        static = 1024 + 8 * bk * bm + 128
        dynamic = 4 * bk * bm * bn + ring
    else:
        static = 1024 + 8 * bk * (bm + bn) + (0 if regime == "block8" else 128)
        dynamic = ring
    assert matmul_smem(regime, bm, bn, bk, depth) == static + dynamic
    assert static <= budget.STATIC_SMEM_MAX
    assert static + dynamic <= budget.SMEM_PER_BLOCK
    with pytest.raises(KeyError):
        matmul_smem("tile", bm, bn, bk, depth)


def test_plain_calls_count_no_launches_at_any_depth():
    from repro_torch.kernels import reset_launch_counts
    reset_launch_counts()
    x = torch.ones(4, 64)
    for d in (1, 2, 4):
        log_matmul(x, torch.ones(64, 64), "rapid10", spec=_d(d))
        fused_rms_div(x, 1e-6, "rapid9", spec=_d(d))
    assert all(not v for v in launch_counts_by_depth().values())


# --------------------------------------------------------------------------
# the stage count moves no bits (CPU: the plain versions)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(4, 300, 70), (70, 129, 65), (9, 24, 130)])
def test_log_matmul_same_bits_at_every_depth(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x, w = randn(rng, m, k), randn(rng, k, n, scale=0.1)
    x[0, :3] = 0.0
    ref = np.asarray(jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                                         jfa.mul_lut_device("rapid10"), 1))
    pallas = np.asarray(jlog_matmul(jnp.asarray(x), jnp.asarray(w),
                                    "rapid10", spec=_JDEPTH1, interpret=True))
    np.testing.assert_array_equal(bits(pallas), bits(ref))
    for d in (1, 2, 3, 4):
        got = log_matmul(T(x), T(w), "rapid10", spec=_d(d)).numpy()
        np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("rows,n", [(64, 1000), (4, 2560), (37, 130)])
def test_row_dividers_same_bits_at_every_depth(rows, n):
    rng = np.random.default_rng(rows * n)
    x = randn(rng, rows, n, scale=3.0)
    e = np.exp(randn(rng, rows, n))
    b = np.abs(randn(rng, rows)) + 0.5
    lut = jfa.div_lut_device("rapid9")
    rms_ref = np.asarray(jfd.rms_div_ref(jnp.asarray(x), lut, 1e-6))
    rms_den = np.asarray(jfd.rms_denom(jfd.pad_lanes(jnp.asarray(x)), n, 1e-6))
    sm_ref = np.asarray(jfd.softmax_div_ref(jnp.asarray(e), lut))
    sm_den = np.asarray(jfd.softmax_denom(jfd.pad_lanes(jnp.asarray(e)),
                                          jfd.SOFTMAX_FLOOR))
    rb_ref = np.asarray(jdiv(jnp.asarray(x), jnp.asarray(b[:, None]),
                             "rapid9", spec=_JDEPTH1, interpret=True))
    tlut = tfa.div_lut_device("rapid9")
    np.testing.assert_array_equal(
        bits(tfa.log_div_f32(T(x), T(rms_den), tlut).numpy()), bits(rms_ref))
    np.testing.assert_array_equal(
        bits(tfa.log_div_f32(T(e), T(sm_den), tlut).numpy()), bits(sm_ref))
    first = None
    for d in (1, 2, 3, 4):
        got = (fused_rms_div(T(x), 1e-6, "rapid9", spec=_d(d)).numpy(),
               fused_softmax_div(T(e), "rapid9", spec=_d(d)).numpy(),
               div_rowbcast(T(x), T(b), "rapid9", spec=_d(d)).numpy())
        assert ulp_diff(got[0], rms_ref).max() <= 2
        assert ulp_diff(got[1], sm_ref).max() <= 4
        assert_same_bits(got[2], rb_ref)
        if first is None:
            first = got
        for a, r in zip(got, first):
            np.testing.assert_array_equal(bits(a), bits(r))


@pytest.mark.parametrize("rows,n", [(4, 2560), (33, 130), (64, 80)])
def test_row_dividers_plain_bits_at_every_depth_and_slab(rows, n):
    """On the CPU neither the stage count nor the slab moves a bit: at
    every depth 1-8, with the spec's slabs and with explicit ones, the
    plain route gives the depth-1 quotients and denominators, and the
    row broadcast the reference's depth-1 Pallas arm."""
    rng = np.random.default_rng(rows + n)
    x = randn(rng, rows, n, scale=3.0)
    e = np.exp(randn(rng, rows, n))
    b = np.abs(randn(rng, rows)) + 0.5
    rb_ref = np.asarray(jdiv(jnp.asarray(x), jnp.asarray(b[:, None]),
                             "rapid9", spec=_JDEPTH1, interpret=True))
    first = None
    for d in (1, 2, 3, 4, 5, 6, 7, 8):
        for bm in (None, 1, 3):
            spec = _d(d, bm=bm)
            if (row_geometry("fused_rms", rows, n, d, bm).smem
                    > budget.SMEM_PER_BLOCK):  # refused on either route
                with pytest.raises(ValueError, match="exceeds"):
                    fused_rms_div(T(x), 1e-6, "rapid9", spec=spec)
                continue
            got = (*fused_rms_div(T(x), 1e-6, "rapid9", spec=spec,
                                  return_denom=True),
                   *fused_softmax_div(T(e), "rapid9", spec=spec,
                                      return_denom=True),
                   div_rowbcast(T(x), T(b), "rapid9", spec=spec))
            got = [t.numpy() for t in got]
            assert_same_bits(got[4], rb_ref)
            if first is None:
                first = got
            for a, r in zip(got, first):
                np.testing.assert_array_equal(bits(a), bits(r))


@pytest.mark.parametrize("rows,c,bn", [
    (32, 512, 32),         # lockstep decode: 4 x 8 rows, 1-chunk segments
    (32, 256, 32),         # continuous decode tick: 256-slot paged views
    (32, 4096, 256),       # the full 4096-slot window: 8 chunks a segment
    (2, 1, 32),            # one slot: one chunk, one segment
    (256, 512, 256),       # many rows: 8 chunks a segment
    (32, 1 << 20, 1024),   # a very long cache: the 32-chunk limit
])
def test_resolve_flash_attn_geometry(rows, c, bn):
    """K4's geometry from (rows, C): chunks of FLASH_CHUNK slots and
    segments of whole chunks, as short as keep the grid within one wave
    of blocks, so rows x segments reaches the card's SMs where the cache
    has the chunks for it."""
    from repro_torch.kernels.spec import (FLASH_CHUNK, FLASH_DEPTH,
                                          flash_geometry)
    ks = resolve_spec("flash_attn", (rows, c))
    assert (ks.bk, ks.bn) == (FLASH_CHUNK, bn) == flash_geometry(rows, c)
    assert ks.depth == FLASH_DEPTH and ks.bm is None
    assert resolve_spec("flash_attn", (rows, c), ks) == ks  # idempotent
    n_chunks = -(-c // FLASH_CHUNK)
    n_seg = -(-n_chunks // (bn // FLASH_CHUNK))
    assert rows * n_seg >= min(budget.SMS, rows * n_chunks)
    explicit = resolve_spec("flash_attn", (rows, c), KernelSpec(bn=64))
    assert (explicit.bk, explicit.bn) == (FLASH_CHUNK, 64)


def test_deferred_depth_context_overrides_the_heuristic_only():
    from repro_torch.kernels.spec import deferred_depth
    with deferred_depth(1):
        assert resolve_spec("log_matmul", (512, 2560, 2560)).depth == 1
        assert resolve_spec("fused_rms", (512, 2560)).depth == 1
        assert resolve_spec("fused_rms", (512, 2560), _d(3)).depth == 3
        with deferred_depth(4):
            assert resolve_spec("log_matmul", (4, 2560, 2560)).depth == 4
        assert resolve_spec("log_matmul", (4, 2560, 2560)).depth == 1
        assert resolve_spec("flash_attn", (32, 512)).depth == 2  # one depth
    assert resolve_spec("log_matmul", (64, 2560, 2560)).depth == 2
    assert resolve_spec("log_matmul", (512, 2560, 2560)).depth == 3
    with pytest.raises(ValueError):
        with deferred_depth(0):
            pass


# --------------------------------------------------------------------------
# K9 / K10: int_split / int_geometry (csrc/rapid_int.cu's partition)
# --------------------------------------------------------------------------

def _walk_int_kernel(total, head, geom):
    """How often csrc/rapid_int.cu writes each element: thread t of the
    grid's S threads walks vectors t, t + S, t + 2 S, ... below V, the
    head and tail elements t, t + S, ... below their count.  Returns the
    count of each element and of each thread's vectors."""
    vectors = (total - head) // 4
    stride = geom.grid * geom.threads
    hits = np.zeros(total, dtype=np.int64)
    v = np.arange(vectors)
    for j in range(4):
        np.add.at(hits, head + 4 * v + j, 1)
    per_thread = np.bincount(v % stride, minlength=stride)
    tail = head + 4 * vectors
    for i in range(head + total - tail):
        hits[i if i < head else tail + i - head] += 1
    return hits, per_thread


@pytest.mark.parametrize("total", [1, 3, 4, 5, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0),
                                     (0, 3)])
@pytest.mark.parametrize("sms", [132, 7])
def test_int_split_covers_every_element_once(total, offsets, sms):
    """For ragged totals and operands starting 0-3 elements past a 16 B
    boundary (the result placed as the wrapper places it: at the first
    operand's offset where the two operands share theirs, else aligned),
    the head, the 16 B vector body and the tail cover every element
    exactly once, the body starts 16 B aligned for all three, the threads
    walk the same count of vectors to within one and the grid never
    exceeds one wave."""
    from repro_torch.kernels.spec import int_geometry, int_split
    a_off, b_off = offsets
    out_off = a_off if a_off == b_off else 0
    addresses = (4096 + 4 * a_off, 65536 + 4 * b_off, (1 << 20) + 4 * out_off)
    head, vectors, tail = int_split(total, *addresses)
    assert head + 4 * vectors + tail == total and 0 <= tail < 4
    if a_off == b_off:
        assert head == min(total, -a_off % 4)
        assert head == total or all((p + 4 * head) % 16 == 0
                                    for p in addresses)
    else:
        assert (head, vectors, tail) == (total, 0, 0)
    geom = int_geometry(total, sms, head)
    assert geom.threads == budget.INT_THREADS and not geom.wide
    assert geom.blocks_per_sm == budget.INT_BLOCKS_PER_SM
    assert 1 <= geom.grid <= sms * budget.INT_BLOCKS_PER_SM
    hits, per_thread = _walk_int_kernel(total, head, geom)
    assert (hits == 1).all()
    assert per_thread.max() - per_thread.min() <= 1


@pytest.mark.parametrize("total,head,grid", [
    (1 << 24, 0, 132 * budget.INT_BLOCKS_PER_SM),  # 2^24 pairs: one wave
    (1 << 17, 0, 128),           # 2^15 vectors: a vector a thread
    (65536, 0, 64),              # the 8-bit exhaustive call
    (65536, 3, 64),              # a head of 3, 16383 vectors, a tail of 1
    (4097, 0, 4),                # 1024 vectors, and a tail element
    (300, 300, 2),               # no vector body: 300 single elements
    (3, 0, 1), (1, 1, 1),
])
def test_int_geometry_rule(total, head, grid):
    """One wave of resident blocks, or fewer where a thread would get no
    vector (or no single element); the kernel's THREADS; 64-bit indices
    from 2^31 pairs."""
    from repro_torch.kernels.spec import int_geometry
    geom = int_geometry(total, budget.SMS, head)
    assert geom == (budget.INT_BLOCKS_PER_SM, budget.INT_THREADS, grid,
                    False)
    assert int_geometry(1 << 31, budget.SMS).wide
    assert not int_geometry((1 << 31) - 1, budget.SMS).wide


def test_int_split_refuses_unaligned_addresses():
    from repro_torch.kernels.spec import int_split
    with pytest.raises(ValueError):
        int_split(8, 2, 0, 0)


# --------------------------------------------------------------------------
# K5 / K6: the same split and geometry, as their wrappers place the result
# --------------------------------------------------------------------------

def _k56_addresses(kind, total, a_off, b_off):
    """(streamed addresses, the head) of a K6 call (a, b and the result
    streamed) or a K5 call (a and the result; b is read by row) whose
    operands start ``a_off`` / ``b_off`` elements past a 16 B boundary:
    the result starts where ``a`` does mod 16 B wherever the streamed
    operands share their offset (``_launch.result_like``), else aligned."""
    from repro_torch.kernels.spec import int_split
    a, b = 4096 + 4 * a_off, 65536 + 4 * b_off
    shared = kind == "K5" or a_off == b_off
    out = (1 << 20) + (4 * a_off if shared else 0)
    addresses = (a, b, out) if kind == "K6" else (a, out)
    return addresses, int_split(total, *addresses)


@pytest.mark.parametrize("kind", ["K5", "K6"])
@pytest.mark.parametrize("total", [1, 2, 3, 4, 5, 7, 4097, 2048 * 80,
                                   (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(a, b) for a in range(4)
                                     for b in range(4)])
def test_div_stream_split_covers_every_element_once(kind, total, offsets):
    """K5 / K6 take K9 / K10's split and geometry (``int_split``,
    ``int_geometry``; K5 through ``row_geometry`` at depth 1, for the
    head its wrapper finds): at ragged and tiny totals and at every
    offset pair mod 16 B, the head, the 16 B body and the tail cover each
    element once, the body starts 16 B aligned for every streamed
    pointer, K5 (whose result follows ``a``) always has a body past a
    head of at most 3, K6 only where a and b share their offset, and the
    grid is at most one wave."""
    from repro_torch.kernels.spec import int_geometry, row_geometry
    addresses, (head, vectors, tail) = _k56_addresses(kind, total, *offsets)
    assert head + 4 * vectors + tail == total and 0 <= tail < 4
    if kind == "K5" or offsets[0] == offsets[1]:
        assert head == min(total, -offsets[0] % 4)
        assert head == total or all((p + 4 * head) % 16 == 0
                                    for p in addresses)
    else:
        assert (head, vectors, tail) == (total, 0, 0)
    geom = int_geometry(total, budget.SMS, head)
    if kind == "K5":
        for n in {1, 3, 80, total}:
            if total % n:
                continue
            g = row_geometry("fused_div_rowbcast", total // n, n, 1, None,
                             head)
            assert (g.warps, g.blocks_per_sm, g.grid) == (
                0, geom.blocks_per_sm, geom.grid)
    assert 1 <= geom.grid <= budget.SMS * budget.INT_BLOCKS_PER_SM
    hits, per_thread = _walk_int_kernel(total, head, geom)
    assert (hits == 1).all()
    assert per_thread.max() - per_thread.min() <= 1


@pytest.mark.parametrize("rows,n", [(5, 3), (33, 129), (2048, 80), (7, 4),
                                    (3, 130), (1, 40_000)])
@pytest.mark.parametrize("head", [0, 1, 2, 3])
def test_div_rowbcast_stream_finds_each_row(rows, n, head):
    """A model of K5's denominators (csrc/fused_div.cu ``DivStream``):
    where n % 4 == 0 and the body starts at element 0, each vector takes
    the row of its first element; otherwise every element its own, by the
    wrapper's magic multiply.  Every element meets ``b[i // n]``."""
    from repro_torch.kernels.fused_div.ops import row_index, row_magic
    total = rows * n
    head = min(head, total)
    vectors = (total - head) // 4
    magic, shift = (np.uint64(v) for v in row_magic(n))
    e = np.arange(total, dtype=np.uint64)
    row = row_index(e, magic, shift)  # the head, the tail, ROW_AN_ELEMENT
    if n % 4 == 0 and head == 0:  # ROW_A_VECTOR
        v = np.arange(vectors, dtype=np.uint64)
        row[:4 * vectors] = np.repeat(row_index(4 * v, magic, shift), 4)
    np.testing.assert_array_equal(row, e // np.uint64(n))


def test_result_like_starts_where_its_operand_does():
    """The streaming wrappers' result: the operand's shape and the given
    dtype, starting at the operand's address mod 16 B."""
    from repro_torch.kernels._launch import result_like
    buf = torch.zeros(64)
    for k in range(4):
        t = buf[k:k + 40].view(5, 8)
        for dtype in (None, torch.float32, torch.uint32):
            out = result_like(t, dtype)
            assert out.shape == t.shape and out.is_contiguous()
            assert out.dtype == (dtype or t.dtype)
            assert out.data_ptr() % 16 == t.data_ptr() % 16
