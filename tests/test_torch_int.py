"""The port's integer RAPID units (K9 / K10 plain versions), the DRUM /
AAXD baselines, ``approx_mul`` / ``approx_div`` and ``qmatmul_batched``
against the JAX reference (CPU, plain torch).

Contract: the integer units bit-equal to the reference's Pallas kernels
in interpret mode, to its jnp units and to its numpy oracle; the numpy
oracles equal; the truncated baselines and the elementwise float ops
bit-equal, specials included; ``qmatmul_batched`` within rtol 1e-5 of
the reference's (which sums in chunks of 64 k's, the port one k at a
time), and the batched plain K1 bit-equal to its 2-D calls.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (assert_same_bits, int_pairs,  # noqa: E402
                            special_sample)
from repro.core import bitops as jbit  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro.core import mitchell as jmit  # noqa: E402
from repro.core import ops as jops  # noqa: E402
from repro.core import schemes as jsch  # noqa: E402
from repro.core import truncated as jtr  # noqa: E402
from repro.kernels.rapid_div.ops import rapid_div as jrapid_div  # noqa: E402
from repro.kernels.rapid_mul.ops import rapid_mul as jrapid_mul  # noqa: E402
from repro_torch.core import bitops as tbit  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.core import mitchell as tmit  # noqa: E402
from repro_torch.core import ops as tops  # noqa: E402
from repro_torch.core import schemes as tsch  # noqa: E402
from repro_torch.core import truncated as ttr  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.log_matmul.ops import log_matmul_plain  # noqa: E402
from repro_torch.kernels.rapid_div.ops import rapid_div  # noqa: E402
from repro_torch.kernels.rapid_mul.ops import rapid_mul  # noqa: E402

T = torch.from_numpy


def _grid(n):
    g = np.arange(n, dtype=np.uint32)
    a, b = np.meshgrid(g, g)
    return a.ravel().copy(), b.ravel().copy()


# --------------------------------------------------------------------------
# bitops
# --------------------------------------------------------------------------

def test_ilog2_all_16bit_values():
    v = np.arange(1 << 16, dtype=np.int32)
    ref = np.asarray(jbit.ilog2(jnp.asarray(v)))
    np.testing.assert_array_equal(tbit.ilog2(T(v)).numpy(), ref)


@pytest.mark.parametrize("fn", ["smear32", "popcount32", "ilog2"])
def test_bitops_int32_lanes(fn):
    rng = np.random.default_rng(1)
    v = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    v[:6] = [0, 1, -1, 2**31 - 1, -2**31, 2**30]
    ref = np.asarray(getattr(jbit, fn)(jnp.asarray(v)))
    got = getattr(tbit, fn)(T(v)).numpy()
    np.testing.assert_array_equal(got.astype(np.int64), ref.astype(np.int64))


def test_ilog2_np_copy():
    rng = np.random.default_rng(2)
    v = rng.integers(0, 2**63, 1000, dtype=np.uint64)
    v[:4] = [0, 1, 2**63, 2**64 - 1]
    np.testing.assert_array_equal(tbit.ilog2_np(v), jbit.ilog2_np(v))


# --------------------------------------------------------------------------
# the numpy oracles and the integer units
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("kind,scheme,n_bits", [
    ("mul", "mitchell", 8), ("mul", "rapid10", 16), ("mul", "rapid3", 12),
    ("div", "mitchell", 4), ("div", "rapid9", 8), ("div", "rapid5", 15)])
def test_numpy_oracles_equal_reference(kind, scheme, n_bits, quantize):
    rng = np.random.default_rng(n_bits)
    if kind == "mul":
        a, b = int_pairs(rng, 5000, n_bits, n_bits)
        ref = jmit.mitchell_mul_np(a, b, jsch.MUL_SCHEMES[scheme], n_bits,
                                   quantize)
        got = tmit.mitchell_mul_np(a, b, tsch.MUL_SCHEMES[scheme], n_bits,
                                   quantize)
    else:
        a, b = int_pairs(rng, 5000, 2 * n_bits, n_bits)
        ref = jmit.mitchell_div_np(a, b, jsch.DIV_SCHEMES[scheme], n_bits,
                                   quantize)
        got = tmit.mitchell_div_np(a, b, tsch.DIV_SCHEMES[scheme], n_bits,
                                   quantize)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def _check_mul(a, b, scheme, n_bits):
    """Port plain K9 (through the wrapper's CPU route and the core unit)
    against the reference's Pallas kernel (interpret), jnp unit and
    numpy oracle."""
    got = rapid_mul(T(a.astype(np.int64)), T(b.astype(np.int64)), scheme,
                    n_bits)
    assert got.dtype == torch.int64
    core = tmit.mitchell_mul(T(a.astype(np.int64)), T(b.astype(np.int64)),
                             tsch.MUL_SCHEMES[scheme], n_bits)
    pallas = np.asarray(jrapid_mul(jnp.asarray(a), jnp.asarray(b), scheme,
                                   n_bits, interpret=True))
    unit = np.asarray(jmit.mitchell_mul(jnp.asarray(a), jnp.asarray(b),
                                        jsch.MUL_SCHEMES[scheme], n_bits))
    oracle = np.minimum(jmit.mitchell_mul_np(a, b, jsch.MUL_SCHEMES[scheme],
                                             n_bits), np.uint64(0xFFFFFFFF))
    for ref in (pallas, unit, oracle):
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(core.numpy(), got.numpy())


def _check_div(a, b, scheme, n_bits):
    got = rapid_div(T(a.astype(np.int64)), T(b.astype(np.int64)), scheme,
                    n_bits)
    core = tmit.mitchell_div(T(a.astype(np.int64)), T(b.astype(np.int64)),
                             tsch.DIV_SCHEMES[scheme], n_bits)
    pallas = np.asarray(jrapid_div(jnp.asarray(a), jnp.asarray(b), scheme,
                                   n_bits, interpret=True))
    unit = np.asarray(jmit.mitchell_div(jnp.asarray(a), jnp.asarray(b),
                                        jsch.DIV_SCHEMES[scheme], n_bits))
    oracle = jmit.mitchell_div_np(a, b, jsch.DIV_SCHEMES[scheme], n_bits)
    for ref in (pallas, unit, oracle):
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(core.numpy(), got.numpy())


@pytest.mark.parametrize("n_bits", [8, 16])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid3", "rapid10"])
@pytest.mark.parametrize("n", [7, 1000, 4096])
def test_rapid_mul_bit_exact_vs_reference(n_bits, scheme, n):
    a, b = int_pairs(np.random.default_rng(n + n_bits), n, n_bits, n_bits)
    _check_mul(a, b, scheme, n_bits)


@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid9"])
@pytest.mark.parametrize("n", [129, 2048])
def test_rapid_div_bit_exact_vs_reference(n_bits, scheme, n):
    a, b = int_pairs(np.random.default_rng(n + n_bits), n, 2 * n_bits, n_bits)
    _check_div(a, b, scheme, n_bits)


@pytest.mark.parametrize("kind,scheme", [("mul", "mitchell"),
                                         ("mul", "rapid10"),
                                         ("div", "mitchell"),
                                         ("div", "rapid9")])
def test_integer_units_exhaustive_8bit(kind, scheme):
    """Every pair of 8-bit operands (the Table III method)."""
    a, b = _grid(256)
    (_check_mul if kind == "mul" else _check_div)(a, b, scheme, 8)


@pytest.mark.parametrize("kind,n_bits", [("mul", 2), ("mul", 4), ("mul", 15),
                                         ("div", 2), ("div", 12),
                                         ("div", 15)])
def test_integer_units_other_widths(kind, n_bits):
    """Narrow widths (below 4 fraction bits the reference's cell index
    is XLA's sign fill) and the widest the units take."""
    rng = np.random.default_rng(n_bits)
    if kind == "mul":
        _check_mul(*int_pairs(rng, 3000, n_bits, n_bits), "rapid10", n_bits)
    else:
        _check_div(*int_pairs(rng, 3000, 2 * n_bits, n_bits), "rapid9", n_bits)


@pytest.mark.parametrize("kind,n_bits", [("mul", 8), ("mul", 16),
                                         ("div", 4), ("div", 8), ("div", 15)])
@pytest.mark.parametrize("scheme_i", range(4))
def test_shift_amounts_stay_in_range(kind, n_bits, scheme_i):
    """The CUDA kernels shift by these amounts and rely on them being
    below 32 (C++ leaves larger shifts undefined): the multiplier's left
    shift is at most n_bits and its right shift at most n_bits - 1; the
    divider's left shift is 0 and its right shift is capped at 31."""
    rng = np.random.default_rng(7)
    if kind == "mul":
        a, b = _grid(256) if n_bits == 8 else int_pairs(rng, 1 << 16, 16, 16)
        sch = list(tsch.MUL_SCHEMES.values())[scheme_i]
        mant, shift = tmit.mul_terms(T(a.astype(np.int64)),
                                     T(b.astype(np.int64)), sch, n_bits)
        assert int(shift.max()) <= n_bits and int(-shift.min()) <= n_bits - 1
    else:
        a, b = int_pairs(rng, 1 << 16, 2 * n_bits, n_bits)
        sch = list(tsch.DIV_SCHEMES.values())[scheme_i]
        mant, shift = tmit.div_terms(T(a.astype(np.int64)),
                                     T(b.astype(np.int64)), sch, n_bits)
        assert int(shift.max()) <= 0
        assert int(mant.max()) < 2**31
    assert int(mant.min()) >= 0


def test_integer_wrappers_route_cpu_and_defaults():
    reset_launch_counts()
    a = torch.arange(300, dtype=torch.int32)
    b = torch.arange(300, dtype=torch.int16).flip(0)
    np.testing.assert_array_equal(
        rapid_mul(a, b).numpy(),
        tmit.mitchell_mul(a, b, tsch.MUL_SCHEMES["rapid10"], 16).numpy())
    np.testing.assert_array_equal(
        rapid_div(a, b[:1]).numpy(),  # broadcast divisor
        tmit.mitchell_div(a, b[:1], tsch.DIV_SCHEMES["rapid9"], 8).numpy())
    assert launch_counts()["rapid_mul"] == launch_counts()["rapid_div"] == 0
    with pytest.raises(TypeError):
        rapid_mul(a.float(), b)
    with pytest.raises(ValueError):
        tmit.mitchell_div(a, b, tsch.DIV_SCHEMES["rapid9"], 16)
    with pytest.raises(ValueError):
        tmit.mitchell_mul(a, b, tsch.DIV_SCHEMES["rapid9"], 8)


def test_lut_device_uploads_once():
    s = tsch.MUL_SCHEMES["rapid10"]
    first = tmit.lut_device(s, 15, "cpu")
    assert first is tmit.lut_device(s, 15, torch.device("cpu"))
    np.testing.assert_array_equal(first.numpy(),
                                  np.asarray(jmit.lut_device(
                                      jsch.MUL_SCHEMES["rapid10"], 15)))


# --------------------------------------------------------------------------
# DRUM / AAXD baselines and the elementwise float ops
# --------------------------------------------------------------------------

_SUB = [1e-40, -1e-40, 1e-20, 2.0, 0.0, -0.0, 3.0, 5.0, np.inf, 1e-38]


def _float_operands(seed):
    rng = np.random.default_rng(seed)
    a = special_sample(rng, 4096)
    b = special_sample(rng, 4096)[::-1].copy()
    # subnormal and zero pairings, which XLA flushes
    a[-len(_SUB):] = _SUB
    b[-len(_SUB):] = _SUB[::-1]
    a[-40:-30] = 0.0
    b[-30:-20] = -0.0
    return a, b


@pytest.mark.parametrize("fn,k", [("drum_mul_f32", 6), ("drum_mul_f32", 4),
                                  ("aaxd_div_f32", 8), ("aaxd_div_f32", 4)])
def test_truncated_baselines_bit_exact(fn, k):
    a, b = _float_operands(k)
    ref = np.asarray(getattr(jtr, fn)(jnp.asarray(a), jnp.asarray(b), k))
    got = getattr(ttr, fn)(T(a), T(b), k).numpy()
    assert_same_bits(got, ref)


@pytest.mark.parametrize("op,scheme", [("mul", "rapid10"), ("mul", "rapid5"),
                                       ("mul", "mitchell"), ("div", "rapid9"),
                                       ("div", "rapid5"), ("div", "mitchell")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_approx_ops_bit_exact(op, scheme, dtype):
    a, b = _float_operands(len(scheme))
    if dtype == "bfloat16":  # the two casts of a NaN to bf16 differ in sign
        a[np.isnan(a)] = 1.0
    jfn = jfa.approx_mul if op == "mul" else jfa.approx_div
    tfn = tfa.approx_mul if op == "mul" else tfa.approx_div
    ja = jnp.asarray(a).astype(dtype)
    ta = T(a).to(getattr(torch, dtype))
    ref = np.asarray(jfn(ja, jnp.asarray(b), scheme).astype(jnp.float32))
    got = tfn(ta, T(b), scheme)
    assert got.dtype == ta.dtype
    assert_same_bits(got.float().numpy(), ref)


# --------------------------------------------------------------------------
# qmatmul_batched and the batched plain K1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 8, 8, 8), (4, 16, 64, 32),
                                   (3, 1, 130, 17)],
                         ids=["jpeg", "moe", "ragged"])
@pytest.mark.parametrize("bias_kind", [None, "shared", "per_batch"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_qmatmul_batched_vs_reference(shape, bias_kind, act):
    b, m, k, n = shape
    rng = np.random.default_rng(b + m)
    x = rng.standard_normal((b, m, k)).astype(np.float32)
    w = (rng.standard_normal((b, k, n)) * 0.2).astype(np.float32)
    bias = {None: None, "shared": rng.standard_normal(n).astype(np.float32),
            "per_batch": rng.standard_normal((b, n)).astype(np.float32)
            }[bias_kind]
    for scheme in ("rapid10", None):
        ref = jops.qmatmul_batched(
            jnp.asarray(x), jnp.asarray(w), scheme, backend="jnp",
            bias=None if bias is None else jnp.asarray(bias), activation=act)
        got = tops.qmatmul_batched(T(x), T(w), scheme,
                                   bias=None if bias is None else T(bias),
                                   activation=act)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


def test_qmatmul_batched_two_batch_dims_and_fallback():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    w = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)
    bias = rng.standard_normal((2, 3, 8)).astype(np.float32)
    ref = jops.qmatmul_batched(jnp.asarray(x), jnp.asarray(w), "rapid10",
                               backend="jnp", bias=jnp.asarray(bias))
    got = tops.qmatmul_batched(T(x), T(w), "rapid10", bias=T(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    w2 = w[0, 0]
    np.testing.assert_array_equal(
        tops.qmatmul_batched(T(x), T(w2), "rapid10").numpy(),
        tops.qmatmul(T(x), T(w2), "rapid10").numpy())


@pytest.mark.parametrize("bad", ["batch", "bias"])
def test_qmatmul_batched_value_errors(bad):
    x = torch.ones(4, 2, 8)
    w = torch.ones(4 if bad == "bias" else 3, 8, 5)
    bias = torch.ones(3, 5) if bad == "bias" else None
    for fn, xx, ww, bb in (
            (tops.qmatmul_batched, x, w, bias),
            (jops.qmatmul_batched, jnp.asarray(x.numpy()),
             jnp.asarray(w.numpy()),
             None if bias is None else jnp.asarray(bias.numpy()))):
        with pytest.raises(ValueError):
            fn(xx, ww, "rapid10", bias=bb)


@pytest.mark.parametrize("bcast", ["none", "x", "w"])
def test_batched_plain_k1_equals_2d_calls(bcast):
    rng = np.random.default_rng(5)
    x = T(rng.standard_normal((6, 5, 40)).astype(np.float32))
    w = T(rng.standard_normal((6, 40, 9)).astype(np.float32))
    if bcast == "x":
        x = x[:1].expand(6, 5, 40)
    elif bcast == "w":
        w = w[:1].expand(6, 40, 9)
    bias = T(rng.standard_normal((6, 9)).astype(np.float32))
    res = T(rng.standard_normal((6, 5, 9)).astype(np.float32))
    # no activation: torch's CPU silu rounds differently in its vector
    # body and its scalar tail, so it depends on the tensor's shape
    got = log_matmul_plain(x, w, "rapid10", bias=bias, residual=res)
    for i in range(6):
        ref = log_matmul_plain(x[i], w[i], "rapid10", bias=bias[i],
                               residual=res[i])
        assert_same_bits(got[i].numpy(), ref.numpy())
