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

from _torch_helpers import assert_same_bits, bits, randn, ulp_diff  # noqa: E402
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
from repro_torch.kernels.fused_div.ops import (  # noqa: E402
    div_rowbcast, fused_rms_div, fused_softmax_div)
from repro_torch.kernels.log_matmul.ops import log_matmul  # noqa: E402
from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,  # noqa: E402
                                      as_kernel_spec, matmul_geometry,
                                      matmul_regime, matmul_smem,
                                      resolve_spec, row_smem)

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
        resolve_spec("flash_attn", (4, 512, 4, 80))
    with pytest.raises(ValueError, match="rows per slab"):
        resolve_spec("fused_rms", (4, 80), KernelSpec(bm=0))


@pytest.mark.parametrize("n", [12, 128, 1000, 2560, 8192])
@pytest.mark.parametrize("depth", [2, 3, 4, 8])
def test_row_slabs_fit_the_ring(n, depth):
    ks = resolve_spec("fused_rms", (4096, n), _d(depth))
    assert 1 <= ks.bm <= budget.MAX_ROW_BM
    ring = depth * ks.bm * n * 4
    assert ks.bm == 1 or ring <= budget.ROW_RING_BYTES
    if ks.bm >= budget.ROW_WARPS:
        assert ks.bm % budget.ROW_WARPS == 0


def test_deferred_row_depth_falls_back_where_two_slabs_do_not_fit():
    # a 40 000-wide f32 row is 160 KB: two of them exceed the 227 KB
    assert resolve_spec("fused_rms", (4, 40_000)).depth == 1
    assert resolve_spec("fused_rms", (4, 20_000)).depth == 2


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


def test_deferred_depth_context_overrides_the_heuristic_only():
    from repro_torch.kernels.spec import deferred_depth
    with deferred_depth(1):
        assert resolve_spec("log_matmul", (512, 2560, 2560)).depth == 1
        assert resolve_spec("fused_rms", (512, 2560)).depth == 1
        assert resolve_spec("fused_rms", (512, 2560), _d(3)).depth == 3
        with deferred_depth(4):
            assert resolve_spec("log_matmul", (4, 2560, 2560)).depth == 4
        assert resolve_spec("log_matmul", (4, 2560, 2560)).depth == 1
    assert resolve_spec("log_matmul", (64, 2560, 2560)).depth == 2
    assert resolve_spec("log_matmul", (512, 2560, 2560)).depth == 3
    with pytest.raises(ValueError):
        with deferred_depth(0):
            pass
