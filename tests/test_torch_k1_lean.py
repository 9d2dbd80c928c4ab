"""K1's lean product path and its proof, as plain PyTorch models (CPU).

``csrc/log_matmul.cu`` sums a K block through a lean loop -- one
address add, one LUT gather, one IADD3 and the FADD per product -- when
a proof over the block's in-bounds operands says that the sign-folded
product is exact, and through the full product elsewhere.  Its plain
models live in ``kernels/log_matmul/ops.py``: ``lean_block_ok`` (the
proof), ``lean_product`` (the sign-folded product), ``lut_bounds`` (the
coefficient range the proof adds) and ``log_matmul_blocks`` (the
blockwise choice).  Here they are held against the port's
``float_approx.log_mul_f32`` and the JAX reference's.

Tolerances: bit-equal everywhere (integer arithmetic, and sums in the
same K order).  Hypothesis draws tiles where it is installed; seeded
numpy cases cover the same domains either way.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import bits, randn, special_sample  # noqa: E402
from repro.core import backend as jbe  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.core import schemes  # noqa: E402
from repro_torch.kernels.log_matmul.ops import (  # noqa: E402
    edge_blocks, edge_pair, lean_block_ok, lean_product, log_matmul_blocks,
    log_matmul_plain, lut_bounds, mixed_blocks)
from repro_torch.kernels.spec import matmul_geometry  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - the seeded cases still run
    given = None

T = torch.from_numpy
MIN_NORMAL, INF_BITS, BIAS = 0x00800000, 0x7F800000, 127 << 23


def _f32(u32) -> np.ndarray:
    return np.asarray(u32, np.uint32).view(np.float32)


def _log_mul_bits(x, w, scheme):
    """The port's and the reference's log_mul_f32 bits of x * w (both
    must agree; returns the port's)."""
    got = tfa.log_mul_f32(T(x), T(w), tfa.mul_lut_device(scheme)).numpy()
    ref = np.asarray(jfa.log_mul_f32(jnp.asarray(x), jnp.asarray(w),
                                     jfa.mul_lut_device(scheme)))
    np.testing.assert_array_equal(bits(got), bits(ref))
    return bits(got)


def _tile(rng, rows, cols, lo, hi):
    """Normal f32 operands of either sign with magnitudes 2^[lo, hi)."""
    mag = 2.0 ** rng.uniform(lo, hi, (rows, cols))
    return (rng.choice([-1.0, 1.0], (rows, cols)) * mag).astype(np.float32)


def _check_sound(x, w, scheme):
    """If the proof holds for x[r, k], w[k, c], every product of the
    block is the lean product; returns the verdict."""
    ok = lean_block_ok(T(x), T(w), scheme)
    if ok:
        xs, ws = x[:, :, None], w[None]
        xs, ws = np.broadcast_arrays(xs, ws)
        want = _log_mul_bits(np.ascontiguousarray(xs),
                             np.ascontiguousarray(ws), scheme)
        got = bits(lean_product(T(np.ascontiguousarray(xs)),
                                T(np.ascontiguousarray(ws)), scheme).numpy())
        np.testing.assert_array_equal(got, want)
    return ok


# --------------------------------------------------------------------------
# the LUT's extremes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", sorted(schemes.MUL_SCHEMES))
def test_lut_bounds_match_every_scheme(scheme):
    lo, hi = lut_bounds(scheme)
    for lut in (tfa.mul_lut(scheme), np.asarray(jfa.mul_lut(scheme))):
        assert (lo, hi) == (int(lut.min()), int(lut.max()))
    assert 0 <= lo <= hi < MIN_NORMAL  # a coefficient never moves an exponent by 1


# --------------------------------------------------------------------------
# the sign-folded product where the proof holds
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scheme", sorted(schemes.MUL_SCHEMES))
@pytest.mark.parametrize("seed", range(4))
def test_lean_product_equals_log_mul_on_model_operands(scheme, seed):
    """Activations and weights at model scale: every block is proved and
    every product is log_mul_f32's, signs included."""
    rng = np.random.default_rng(seed)
    x = randn(rng, 16, 64, scale=3.0)
    w = randn(rng, 64, 32, scale=64 ** -0.5)
    assert _check_sound(x, w, scheme)


@pytest.mark.parametrize("seed", range(6))
def test_lean_product_equals_log_mul_on_4000_wide_pairs(seed):
    """4000 random pairs over 2^+-9 in magnitude, either sign (rapid10)."""
    rng = np.random.default_rng(100 + seed)
    x = _tile(rng, 1, 4000, -9, 9)[0]
    w = _tile(rng, 1, 4000, -9, 9)[0]
    np.testing.assert_array_equal(
        bits(lean_product(T(x), T(w), "rapid10").numpy()),
        _log_mul_bits(x, w, "rapid10"))


@pytest.mark.parametrize("lo,hi,proved", [
    (-60, 60, True), (-30, 30, True), (0, 62, True), (-62, 0, True),
    (-70, 0, False),    # the smallest products flush to 0
    (0, 70, False),     # the largest saturate to inf
    (-126, 127, False),
])
@pytest.mark.parametrize("scheme", ["rapid10", "mitchell"])
def test_proof_is_sound_across_the_exponent_range(lo, hi, proved, scheme):
    """Tiles whose operands span 2^[lo, hi), so their products run up to
    the underflow or the overflow edge: whatever the proof accepts is
    exact, and tiles whose products cross an edge are refused."""
    rng = np.random.default_rng((lo + 200) * 1000 + hi)
    for _ in range(6):
        assert _check_sound(_tile(rng, 8, 16, lo, hi),
                            _tile(rng, 16, 8, lo, hi), scheme) == proved


if given is not None:
    @pytest.mark.hypothesis
    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 6), st.integers(1, 6), st.integers(1, 6),
           st.integers(-126, 126), st.integers(1, 253),
           st.sampled_from(sorted(schemes.MUL_SCHEMES)),
           st.integers(0, 2**32 - 1))
    def test_proof_is_sound_on_drawn_tiles(rows, k, cols, lo, span, scheme,
                                           seed):
        hi = min(lo + span, 127)
        rng = np.random.default_rng(seed)
        _check_sound(_tile(rng, rows, k, lo, hi),
                     _tile(rng, k, cols, lo, hi), scheme)

    @pytest.mark.hypothesis
    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 5), st.integers(1, 5),
           st.integers(0, 2**32 - 1), st.booleans(), st.integers(0, 2**32 - 1))
    def test_proof_refuses_drawn_special_operands(rows, cols, raw, x_side,
                                                  seed):
        """Any bit pattern that is 0, -0, subnormal, inf or NaN anywhere
        in either tile is refused."""
        mag = raw & 0x7FFFFFFF
        if MIN_NORMAL <= mag < INF_BITS:
            raw &= 0x807FFFFF  # force it out of the normal range
        rng = np.random.default_rng(seed)
        x = _tile(rng, rows, 4, -5, 5)
        w = _tile(rng, 4, cols, -5, 5)
        t = x if x_side else w
        t.flat[rng.integers(t.size)] = _f32([raw])[0]
        assert not lean_block_ok(T(x), T(w), "rapid10")


# --------------------------------------------------------------------------
# what the proof refuses
# --------------------------------------------------------------------------

_SPECIALS = {"zero": 0x00000000, "neg_zero": 0x80000000,
             "subnormal": 0x00000001, "neg_subnormal": 0x807FFFFF,
             "inf": 0x7F800000, "neg_inf": 0xFF800000, "nan": 0x7FC00000,
             "neg_nan": 0xFFC00001}


@pytest.mark.parametrize("name", sorted(_SPECIALS))
@pytest.mark.parametrize("side", ["x", "w"])
@pytest.mark.parametrize("where", [0, -1])
def test_proof_refuses_special_operands(name, side, where):
    rng = np.random.default_rng(len(name))
    x = randn(rng, 4, 16)
    w = randn(rng, 16, 8, scale=0.25)
    assert lean_block_ok(T(x), T(w), "rapid10")
    t = x if side == "x" else w
    t.flat[where] = _f32([_SPECIALS[name]])[0]
    assert not lean_block_ok(T(x), T(w), "rapid10")


def _pair(scheme, prod_bits, bound=None):
    """``edge_pair`` as 1-element arrays."""
    return tuple(np.array([v], np.float32)
                 for v in edge_pair(scheme, prod_bits, bound))


_EDGES = [MIN_NORMAL - 1, MIN_NORMAL, MIN_NORMAL + 1, INF_BITS - 1,
          INF_BITS, INF_BITS + 1]


@pytest.mark.parametrize("prod_bits", _EDGES)
@pytest.mark.parametrize("scheme", ["rapid10", "rapid3", "mitchell"])
@pytest.mark.parametrize("negate", [False, True])
def test_lean_product_at_the_clamp_edges(prod_bits, scheme, negate):
    """A single product at, just inside and just outside the
    MIN_NORMAL / INF_BITS edges: the lean product equals log_mul_f32
    exactly where no clamp applies, and the proof never accepts a pair
    where it does not."""
    x, w = _pair(scheme, prod_bits)
    if negate:
        x = -x
    lean = int(bits(lean_product(T(x), T(w), scheme).numpy())[0])
    assert lean & 0x7FFFFFFF == prod_bits
    exact = int(_log_mul_bits(x, w, scheme)[0]) == lean
    # a sum of exactly INF_BITS is inf either way; the proof refuses it
    assert exact == (MIN_NORMAL <= prod_bits <= INF_BITS)
    if lean_block_ok(T(x[None]), T(w[None]), scheme):
        assert exact


@pytest.mark.parametrize("scheme", ["rapid10", "rapid3", "mitchell"])
@pytest.mark.parametrize("negate", [False, True])
def test_proof_at_its_own_edges(scheme, negate):
    """The proof's bounds are exact: a + m + lut_min == MIN_NORMAL and a +
    m + lut_max == INF_BITS - 1 are accepted, one step further out is
    refused (int64 sums, so nothing wraps); each pair's own LUT cell
    holds the extreme coefficient, so its product sits on the bound."""
    for target, bound, proved in ((MIN_NORMAL, "min", True),
                                  (MIN_NORMAL - 1, "min", False),
                                  (INF_BITS - 1, "max", True),
                                  (INF_BITS, "max", False)):
        x, w = _pair(scheme, target, bound)
        if negate:
            w = -w
        assert lean_block_ok(T(x[None]), T(w[None]), scheme) == proved
        if proved:
            np.testing.assert_array_equal(
                bits(lean_product(T(x), T(w), scheme).numpy()),
                _log_mul_bits(x, w, scheme))


@pytest.mark.parametrize("scheme", ["rapid10", "rapid5"])
def test_proof_refuses_a_block_with_one_clamping_pair(scheme):
    """Ordinary operands plus one pair whose sum would clamp: the bounds
    over the whole block refuse it, though each operand is normal."""
    rng = np.random.default_rng(5)
    x = randn(rng, 3, 8)
    w = randn(rng, 8, 5, scale=0.3)
    assert lean_block_ok(T(x), T(w), scheme)
    for big, small in ((2.0 ** 120, 2.0 ** 20), (2.0 ** -100, 2.0 ** -40)):
        xx, ww = x.copy(), w.copy()
        xx[1, 2], ww[2, 3] = big, small
        assert not lean_block_ok(T(xx), T(ww), scheme)


def test_proof_refuses_an_empty_tile():
    with pytest.raises(ValueError, match="empty"):
        lean_block_ok(torch.ones(0, 4), torch.ones(4, 3), "rapid10")


# --------------------------------------------------------------------------
# the blockwise model: lean and full blocks in one product
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(1, 33), (4, 70), (9, 40), (64, 130),
                                 (65, 130), (200, 259)])
def test_blockwise_model_bit_equal_to_plain_and_reference(m, n):
    """The kernel's geometry for (m, n); blocks 1-5 are refused where
    their special operands lie, the rest proved; the output equals the
    plain version's and the reference's chunk=1 scan, bit for bit."""
    bm, bn, bk = matmul_geometry(m, n)
    k = 6 * bk + 7
    x, w = mixed_blocks(np.random.default_rng(m * n), m, k, n, bk)
    out, verdicts = log_matmul_blocks(T(x), T(w), "rapid10", bm, bn, bk)
    assert any(verdicts.values()) and not all(verdicts.values())
    # the tile holding row 0 and column 0 refuses blocks 3-5 (an inf, a
    # clamping pair, the clamp edges lie inside it) and proves 0 and 6
    assert verdicts[(0, 0, 0)] and verdicts[(0, 0, 6 * bk)]
    assert not any(verdicts[(0, 0, b * bk)] for b in (3, 4, 5))
    ref = log_matmul_plain(T(x), T(w), "rapid10").numpy()
    jref = np.asarray(jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                                          jfa.mul_lut_device("rapid10"), 1))
    np.testing.assert_array_equal(bits(out.numpy()), bits(ref))
    np.testing.assert_array_equal(bits(out.numpy()), bits(jref))


def _tile_sums(x, w, scheme):
    """The proof's two int64 sums over one tile's K block: min a + min m
    + lut_min and max a + max m + lut_max."""
    mx = x.view(np.int32).astype(np.int64) & 0x7FFFFFFF
    mw = w.view(np.int32).astype(np.int64) & 0x7FFFFFFF
    lo, hi = lut_bounds(scheme)
    return (int(mx.min()) - BIAS + int(mw.min()) + lo,
            int(mx.max()) - BIAS + int(mw.max()) + hi)


@pytest.mark.parametrize("m,n", [(1, 33), (3, 133), (8, 70), (9, 40),
                                 (64, 133), (65, 130), (200, 259)])
@pytest.mark.parametrize("scheme", ["rapid10", "rapid3"])
def test_edge_blocks_sit_on_the_bounds(m, n, scheme):
    """The card tests' edge operands, in the kernel's geometry: in every
    output tile that holds row 0 mod 8 and columns 0 and 4 mod 8, block
    0's sums are MIN_NORMAL and INF_BITS - 1 exactly (proved), block 1's
    lower sum MIN_NORMAL - 1 and block 2's upper INF_BITS (refused); the
    blockwise model still gives the plain version's and the reference's
    bits."""
    bm, bn, bk = matmul_geometry(m, n)
    k = 4 * bk + 5
    x, w = edge_blocks(np.random.default_rng(m + n), m, k, n, bk, scheme)
    out, verdicts = log_matmul_blocks(T(x), T(w), scheme, bm, bn, bk)
    for r0 in range(0, m, bm):
        for c0 in range(0, n, bn):
            if min(bn, n - c0) < 5:
                continue
            sums = [_tile_sums(x[r0:r0 + bm, b * bk:(b + 1) * bk],
                               w[b * bk:(b + 1) * bk, c0:c0 + bn], scheme)
                    for b in range(3)]
            assert sums[0] == (MIN_NORMAL, INF_BITS - 1)
            assert sums[1][0] == MIN_NORMAL - 1
            assert sums[2] == (MIN_NORMAL, INF_BITS)
            assert [verdicts[(r0, c0, b * bk)] for b in range(3)] == [
                True, False, False]
    ref = log_matmul_plain(T(x), T(w), scheme).numpy()
    jref = np.asarray(jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                                          jfa.mul_lut_device(scheme), 1))
    np.testing.assert_array_equal(bits(out.numpy()), bits(ref))
    np.testing.assert_array_equal(bits(out.numpy()), bits(jref))


@pytest.mark.parametrize("seed", range(3))
def test_blockwise_model_on_special_samples(seed):
    """Every operand drawn from the special sample (a quarter raw bit
    patterns): nearly every block is refused, and the model still gives
    the plain version's bits."""
    rng = np.random.default_rng(seed)
    x = special_sample(rng, 9 * 40).reshape(9, 40)
    w = special_sample(rng, 40 * 37).reshape(40, 37)
    out, _ = log_matmul_blocks(T(x), T(w), "rapid10", 4, 32, 16)
    ref = log_matmul_plain(T(x), T(w), "rapid10").numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(out.numpy()), nan)
    np.testing.assert_array_equal(bits(out.numpy())[~nan], bits(ref)[~nan])
