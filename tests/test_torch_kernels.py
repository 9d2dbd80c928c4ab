"""The port's kernel modules: plain versions against the JAX reference
(CPU), and each CUDA kernel against its plain version (card only).

Tolerances, each with its reason:
  * log_matmul plain vs ``log_matmul_scan(chunk=1)``: bit-exact (same
    products, same K-order sums; north-star rule 2).
  * epilogues on a shared pre-activation: bias/identity/residual
    bit-exact (IEEE adds); silu <= 2 ulp (torch's silu differs from
    XLA's in the last bit on ~23% of elements, rule 4).
  * rms / softmax divides: bit-exact once fed the reference's
    denominator; end to end <= 2 ulp (rms) and <= 4 ulp (softmax, a sum
    of up to 1000 positive terms), because the port fixes the row-sum
    grouping itself and XLA groups it otherwise (rule 3).
  * flash decode plain vs ``decode_attn_ref``: rtol 1e-5, atol 1e-6
    (the plain version keeps the kernel's running max over 32-slot
    chunks within a segment and combines the segments' maxima, the
    reference takes one max; sums in other orders).
  * elementwise divides (K5 row-broadcast, K6 general) vs
    ``float_approx.approx_div`` and the reference's depth-1 Pallas
    ``fused_elementwise_div`` in interpret mode: bit-exact, special
    operands included (NaN positions equal, payloads not compared).

The CUDA kernels are held against these plain versions on the card by
``tests/test_torch_gpu.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_helpers import (assert_same_bits, bits,  # noqa: E402
                            decode_case, randn, special_sample, ulp_diff)
from repro.core import backend as jbe  # noqa: E402
from repro.core import float_approx as jfa  # noqa: E402
from repro.kernels.flash_attn import ref as jflash  # noqa: E402
from repro.kernels.fused_div import ref as jfd  # noqa: E402
from repro.kernels.fused_div.ops import (  # noqa: E402
    fused_elementwise_div as jfused_div)
from repro.kernels.spec import KernelSpec, PipelineSpec  # noqa: E402
from repro_torch.core import backend as tbe  # noqa: E402
from repro_torch.core import float_approx as tfa  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels.flash_attn.ops import flash_decode_attn  # noqa: E402
from repro_torch.kernels.fused_div import ops as tfdops  # noqa: E402
from repro_torch.kernels.fused_div import ref as tfd  # noqa: E402
from repro_torch.kernels.fused_div.ops import (  # noqa: E402
    div_plain, div_rowbcast_plain, fused_elementwise_div, fused_rms_div,
    fused_softmax_div)
from repro_torch.kernels.log_matmul.ops import log_matmul  # noqa: E402
from repro_torch.kernels.rapid_div.ops import rapid_div  # noqa: E402
from repro_torch.kernels.rapid_mul.ops import rapid_mul  # noqa: E402

T = torch.from_numpy


# --------------------------------------------------------------------------
# K1 log_matmul (plain)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(4, 80, 40), (7, 130, 33), (16, 257, 129),
                                   (1, 1, 1), (33, 64, 200)])
@pytest.mark.parametrize("scheme", ["rapid10", "mitchell"])
def test_log_matmul_plain_bit_exact_vs_scan_chunk1(m, k, n, scheme):
    rng = np.random.default_rng(m * 1000 + k + n)
    x, w = randn(rng, m, k), randn(rng, k, n, scale=0.1)
    x[0, : min(3, k)] = 0.0  # zero operands: dead products
    ref = jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                              jfa.mul_lut_device(scheme), 1)
    got = log_matmul(T(x), T(w), scheme)
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


def _pre(seed, m=6, k=70, n=200):
    rng = np.random.default_rng(seed)
    x, w = randn(rng, m, k), randn(rng, k, n, scale=0.2)
    acc = np.asarray(jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                                         jfa.mul_lut_device("rapid10"), 1))
    return x, w, acc, randn(rng, n), randn(rng, m, n)


@pytest.mark.parametrize("use_bias,use_res", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_epilogue_elementwise_bit_exact(use_bias, use_res):
    x, w, acc, bias, res = _pre(3)
    b = bias if use_bias else None
    r = res if use_res else None
    ref = jbe.apply_epilogue_tile(
        jnp.asarray(acc), None if b is None else jnp.asarray(b),
        None if r is None else jnp.asarray(r), jbe.Epilogue(), n=acc.shape[1])
    got = log_matmul(T(x), T(w), "rapid10",
                     bias=None if b is None else T(b),
                     residual=None if r is None else T(r))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref))


def test_epilogue_silu_within_ulps():
    x, w, acc, bias, res = _pre(4)
    ep = jbe.Epilogue(activation="silu")
    ref = np.asarray(jbe.apply_epilogue_tile(jnp.asarray(acc), jnp.asarray(bias),
                                             jnp.asarray(res), ep, n=acc.shape[1]))
    got = log_matmul(T(x), T(w), "rapid10", bias=T(bias), residual=T(res),
                     activation="silu").numpy()
    # the residual add turns a silu ulp into an ulp of the (larger) sum
    np.testing.assert_allclose(got, ref, rtol=2.5e-7, atol=2.5e-7)
    silu_only = log_matmul(T(x), T(w), "rapid10", activation="silu").numpy()
    silu_ref = np.asarray(jbe.apply_epilogue_tile(jnp.asarray(acc), None, None,
                                                  ep, n=acc.shape[1]))
    assert ulp_diff(silu_only, silu_ref).max() <= 2


@pytest.mark.parametrize("act", ["relu", "gelu_erf", "tanh", "gelu"])
def test_epilogue_other_activations_close(act):
    x, w, acc, _, _ = _pre(5)
    ref = jbe.apply_epilogue_tile(jnp.asarray(acc), None, None,
                                  jbe.Epilogue(activation=act), n=acc.shape[1])
    got = log_matmul(T(x), T(w), "rapid10", activation=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("norm", ["rms", "softmax"])
def test_epilogue_norm_keep_prenorm(norm):
    """Prefill's ``rms(wo @ h + residual)`` tail with its pre-norm output:
    the pre-norm value bit-exact, the normalized value bit-exact on the
    reference's denominator and <= 2 ulp end to end."""
    x, w, acc, _, res = _pre(6, m=5, k=90, n=300)
    if norm == "softmax":  # softmax norms take non-negative weights
        x, w, res = np.abs(x), np.abs(w), np.abs(res)
        acc = np.asarray(jbe.log_matmul_scan(jnp.asarray(x), jnp.asarray(w),
                                             jfa.mul_lut_device("rapid10"), 1))
    ep_j = jbe.Epilogue(norm=norm, div_scheme="rapid9", eps=1e-6,
                        keep_prenorm=True)
    ep_t = tbe.Epilogue(norm=norm, div_scheme="rapid9", eps=1e-6,
                        keep_prenorm=True)
    tail_r, pre_r = jbe._finish_epilogue_jnp(jnp.asarray(acc), None,
                                             jnp.asarray(res), ep_j)
    tail, pre = log_matmul(T(x), T(w), "rapid10", residual=T(res), epilogue=ep_t)
    np.testing.assert_array_equal(bits(pre.numpy()), bits(pre_r))
    n = acc.shape[1]
    zp = jfd.pad_lanes(jnp.asarray(pre_r))
    denom = (jfd.rms_denom(zp, n, 1e-6) if norm == "rms"
             else jfd.softmax_denom(zp, jfd.SOFTMAX_FLOOR))
    shared = tfa.log_div_f32(pre, T(np.asarray(denom)),
                             tfa.div_lut_device("rapid9"))
    np.testing.assert_array_equal(bits(shared.numpy()), bits(tail_r))
    assert ulp_diff(tail.numpy(), tail_r).max() <= 2


# --------------------------------------------------------------------------
# K2 / K3 fused divides (plain)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rows,n", [(64, 1000), (4, 2560), (3, 80), (17, 128)])
def test_rms_div_plain_vs_reference(rows, n):
    x = randn(np.random.default_rng(rows + n), rows, n, scale=3.0)
    ref_out = np.asarray(jfd.rms_div_ref(jnp.asarray(x),
                                         jfa.div_lut_device("rapid9"), 1e-6))
    ref_den = np.asarray(jfd.rms_denom(jfd.pad_lanes(jnp.asarray(x)), n, 1e-6))
    got, den = fused_rms_div(T(x), 1e-6, "rapid9", return_denom=True)
    shared = tfa.log_div_f32(T(x), T(ref_den), tfa.div_lut_device("rapid9"))
    np.testing.assert_array_equal(bits(shared.numpy()), bits(ref_out))
    assert ulp_diff(den.numpy(), ref_den).max() <= 2
    assert ulp_diff(got.numpy(), ref_out).max() <= 2


@pytest.mark.parametrize("rows,n", [(64, 1000), (16, 128), (5, 12)])
def test_softmax_div_plain_vs_reference(rows, n):
    e = np.exp(randn(np.random.default_rng(rows * n), rows, n))
    e[0, : n // 2] = 0.0
    ref_out = np.asarray(jfd.softmax_div_ref(jnp.asarray(e),
                                             jfa.div_lut_device("rapid9")))
    ref_den = np.asarray(jfd.softmax_denom(jfd.pad_lanes(jnp.asarray(e)),
                                           jfd.SOFTMAX_FLOOR))
    got = fused_softmax_div(T(e), "rapid9")
    shared = tfa.log_div_f32(T(e), T(ref_den), tfa.div_lut_device("rapid9"))
    np.testing.assert_array_equal(bits(shared.numpy()), bits(ref_out))
    assert ulp_diff(got.numpy(), ref_out).max() <= 4


def test_softmax_div_fully_masked_row_is_zero():
    e = np.zeros((2, 40), np.float32)
    e[1] = 1.0
    got = fused_softmax_div(T(e), "rapid9").numpy()
    assert np.all(got[0] == 0.0) and np.all(np.isfinite(got))


def test_lane_sum_grouping():
    """The port's fixed grouping: per-lane sums in order, then halving."""
    x = np.random.default_rng(9).standard_normal((3, 384)).astype(np.float32)
    lanes = x[:, :128] + x[:, 128:256]
    lanes = lanes + x[:, 256:384]
    h = 64
    while h:
        lanes = lanes[:, :h] + lanes[:, h:2 * h]
        h //= 2
    got = tfd.lane_sum(T(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(lanes))


@pytest.mark.parametrize("n", [128, 256, 2560])
def test_softmax_div_plain_negative_zero_rows_vs_reference(n):
    """Rows of -0 at ``floor=0.0`` (a width that is a multiple of 128,
    so no padding's +0 joins the sum): the reference's sum starts at +0,
    so its denominator is +0 and every quotient -0; the port's
    ``lane_sum`` starts each lane's chain at +0 and gives the same bits,
    signs of zero included."""
    e = np.full((2, n), -0.0, np.float32)
    lut = jfa.div_lut_device("rapid9")
    ref_out = np.asarray(jfd.softmax_div_ref(jnp.asarray(e), lut, floor=0.0))
    ref_den = np.asarray(jfd.softmax_denom(jfd.pad_lanes(jnp.asarray(e)),
                                           0.0))
    got, den = tfdops.softmax_div_plain(T(e), "rapid9", floor=0.0,
                                        return_denom=True)
    np.testing.assert_array_equal(bits(den.numpy()), bits(ref_den))
    np.testing.assert_array_equal(bits(got.numpy()), bits(ref_out))
    assert (bits(den.numpy()) == 0).all()  # +0
    assert (bits(got.numpy()) == bits(np.float32(-0.0))).all()  # -0


def _lane_sum_from_first_group(x):
    """``lane_sum`` as it was before its chains started at +0: each
    lane's chain starts from the row's first lane group."""
    acc = x[:, :128]
    for j in range(1, x.shape[1] // 128):
        acc = acc + x[:, 128 * j:128 * (j + 1)]
    h = 64
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc


@pytest.mark.parametrize("n", [128, 256, 2560])
def test_lane_sum_plus_zero_start_moves_only_negative_zero_lanes(n):
    """Starting the chains at +0 changes the sum of a row only where a
    whole lane is -0 (its -0 becomes +0): rows of normals, of normals
    and -0, of -0 and +0, of special operands and of subnormals keep
    their bits; a row of -0 sums to +0, where it summed to -0."""
    rng = np.random.default_rng(n)
    x = randn(rng, 6, n, scale=3.0)
    x[1, rng.random(n) < 0.5] = -0.0
    x[2] = -0.0
    x[2, n // 2] = 0.0
    x[3] = special_sample(rng, max(n, 18))[:n]
    x[4] = rng.choice(np.array([1e-40, -1e-42, -0.0], np.float32), n)
    x[5] = -0.0
    got = tfd.lane_sum(T(x)).numpy()
    old = _lane_sum_from_first_group(T(x)).numpy()
    assert_same_bits(got[:5], old[:5])
    assert bits(got[5])[0] == 0 and bits(old[5])[0] == bits(np.float32(-0.0))
    # the mixed rows' quotients, against the reference fed the port's
    # denominators, and the -0 row's against the reference's own
    lut = jfa.div_lut_device("rapid9")
    e = np.abs(x[:2])
    e[0, :3] = -0.0
    got, den = tfdops.softmax_div_plain(T(e), "rapid9", floor=0.0,
                                        return_denom=True)
    np.testing.assert_array_equal(
        bits(got.numpy()),
        bits(np.asarray(jfa.log_div_f32(jnp.asarray(e),
                                        jnp.asarray(den.numpy()), lut))))


# --------------------------------------------------------------------------
# K5's row index: the wrapper's magic multiply in place of i // n
# --------------------------------------------------------------------------

_MAGIC_WIDTHS = list(range(1, 4097)) + [40_000, 2**30, 2**30 + 1,
                                        3 * 2**29, 2**31 - 1]


def test_row_magic_is_floor_division():
    """``row_index(i, *row_magic(n))`` -- a model of csrc/fused_div.cu's
    ``umulhi(2 i, magic) >> shift`` in uint32 arithmetic -- equals
    ``i // n`` for every n in 1..4096, 80, 40 000 and the widest ones, at
    i = 0, n - 1, n, the last index below 2^31 and random indices."""
    rng = np.random.default_rng(21)
    last = 2**31 - 1
    for n in _MAGIC_WIDTHS:
        magic, shift = tfdops.row_magic(n)
        assert 0 < magic < 2**32 and 0 <= shift <= 31
        idx = [0, n - 1, n, 2 * n - 1, 2 * n, last, last - 1,
               last - last % n, last - last % n - 1]
        idx += rng.integers(0, 2**31, 8).tolist()
        idx = np.array([i for i in idx if 0 <= i <= last], np.uint64)
        got = tfdops.row_index(idx, np.uint64(magic), np.uint64(shift))
        np.testing.assert_array_equal(got, idx // np.uint64(n))
        for i in (0, n - 1, last):  # and in Python's unbounded ints
            assert tfdops.row_index(i, magic, shift) == i // n


@pytest.mark.parametrize("n", [1, 3, 80, 130, 40_000])
def test_row_magic_every_index_of_a_call(n):
    """At the card tests' widths, every element index of a call of
    about 2^20 elements finds its row."""
    i = np.arange(-(-(1 << 20) // n) * n, dtype=np.uint64)
    magic, shift = tfdops.row_magic(n)
    np.testing.assert_array_equal(
        tfdops.row_index(i, np.uint64(magic), np.uint64(shift)),
        i // np.uint64(n))


def test_row_magic_refuses_a_width_past_the_index():
    for n in (0, -1, 2**31):
        with pytest.raises(ValueError):
            tfdops.row_magic(n)


# --------------------------------------------------------------------------
# K4 flash decode (plain)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("ring,empty", [(False, 0), (True, 0), (False, 7)])
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_flash_decode_plain_vs_reference(window, ring, empty, scheme):
    qf, kc, vc, sp, pos = decode_case(11, ring=ring, empty=empty)
    ref = jflash.decode_attn_ref(jnp.asarray(qf), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(sp),
                                 jnp.int32(pos), window, scheme)
    got = flash_decode_attn(T(qf), T(kc), T(vc), T(sp), pos, window, scheme)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_flash_decode_vector_pos_and_fully_masked():
    qf, kc, vc, sp, _ = decode_case(12, B=3, G=1, hd=32, KV=4)
    posv = np.array([5, -1, 30], np.int32)  # row 1 sees no slot at all
    ref = jflash.decode_attn_ref(jnp.asarray(qf), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(sp),
                                 jnp.asarray(posv), 0, "rapid9")
    got = flash_decode_attn(T(qf), T(kc), T(vc), T(sp), T(posv), 0, "rapid9")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert np.all(got.numpy()[1] == 0.0)


def _flash_case(seed, B, C, KV=2, G=4, hd=16):
    rng = np.random.default_rng(seed)
    qf = randn(rng, B, KV, G, hd, scale=0.3)
    kc, vc = randn(rng, B, C, KV, hd), randn(rng, B, C, KV, hd)
    sp = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    return qf, kc, vc, sp


def _flash_vs_reference(qf, kc, vc, sp, pos, window, scheme, spec=None):
    ref = jflash.decode_attn_ref(jnp.asarray(qf), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(sp),
                                 jnp.asarray(pos), window, scheme)
    tpos = T(pos) if isinstance(pos, np.ndarray) else pos
    got = flash_decode_attn(T(qf), T(kc), T(vc), T(sp), tpos, window,
                            scheme, spec=spec)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    return got.numpy()


# (C, segment bn or None for the spec's): one slot; one chunk; one
# segment of two chunks; three one-chunk segments; 7 chunks in segments
# of 2 with a ragged last chunk; 5 chunks in segments of 3
_FLASH_GEOMETRIES = [(1, None), (32, None), (64, 64), (96, None),
                     (200, 64), (130, 96)]


@pytest.mark.parametrize("C,bn", _FLASH_GEOMETRIES)
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_flash_decode_plain_geometries_vs_reference(C, bn, scheme):
    """The split-cache order at every geometry against the one-max
    oracle: per-row positions (the last slot, mid-cache, none at all),
    empty slots, a sliding window and a ring cache."""
    from repro_torch.kernels.spec import KernelSpec
    spec = None if bn is None else KernelSpec(bn=bn)
    qf, kc, vc, sp = _flash_case(C + (bn or 0), 4, C)
    sp[1, C // 2:] = np.iinfo(np.int32).max           # empty tail
    sp[2] = (sp[2] - 3) % C + 1000                     # a ring, wrapped
    posv = np.array([C - 1, C - 1, 1000 + C - 4, -1], np.int32)
    out = _flash_vs_reference(qf, kc, vc, sp, posv, 0, scheme, spec)
    assert np.all(out[3] == 0.0)                       # fully masked row
    _flash_vs_reference(qf, kc, vc, sp, posv, max(1, C // 3), scheme, spec)
    _flash_vs_reference(qf, kc, vc, sp, C // 2, 5, scheme, spec)


@pytest.mark.parametrize("pos", [63, 64, 31, 32, 127])
def test_flash_decode_plain_live_region_at_segment_edges(pos):
    """The live slots end on a segment edge (63: segment 0 full, segment
    1 empty), start one past it (64: a single live slot opens segment
    1), or end on a chunk edge inside a segment (31, 32), or fill all."""
    from repro_torch.kernels.spec import KernelSpec
    qf, kc, vc, sp = _flash_case(pos, 2, 128)
    for window in (0, 1):
        _flash_vs_reference(qf, kc, vc, sp, pos, window, "rapid9",
                            KernelSpec(bn=64))


def _skip_cases(seed, C=160, hd=16):
    """Rows whose chunks are mostly empty: row 0's one live slot opens a
    chunk (slot 64), row 1's closes one (slot 95), row 2 is a ring cache
    with holes (every third slot empty), row 3 sees nothing."""
    qf, kc, vc, sp = _flash_case(seed, 4, C, hd=hd)
    empty = np.iinfo(np.int32).max
    sp[0], sp[1] = empty, empty
    sp[0, 64], sp[1, 95] = 500, 500
    sp[2] = (np.arange(C) - 7) % C + 300
    sp[2, ::3] = empty
    posv = np.array([500, 500, 300 + C - 1, -1], np.int32)
    return qf, kc, vc, sp, posv


@pytest.mark.parametrize("bn", [32, 64])
def test_flash_decode_plain_skip_equals_fold(bn):
    """Skipping a chunk with no live slot gives the bits of folding it."""
    from _torch_helpers import fold_every_chunk
    from repro_torch.kernels.spec import KernelSpec
    qf, kc, vc, sp, posv = _skip_cases(bn)
    args = [T(a) for a in (qf, kc, vc, sp)]
    for window in (0, 40):
        got = flash_decode_attn(*args, T(posv), window, "rapid9",
                                spec=KernelSpec(bn=bn))
        ref = fold_every_chunk(*args, T(posv), window, "rapid9", 32, bn)
        assert_same_bits(got.numpy(), ref.numpy())
    assert not got.numpy()[3].any()


def test_flash_decode_plain_same_for_every_segment_length():
    """Segment lengths move only the order of the combine: every
    geometry agrees within the oracle's tolerance."""
    from repro_torch.kernels.spec import KernelSpec
    qf, kc, vc, sp = _flash_case(3, 2, 300)
    outs = [flash_decode_attn(T(qf), T(kc), T(vc), T(sp), 250, 0, "rapid9",
                              spec=KernelSpec(bn=bn)).numpy()
            for bn in (32, 64, 96, 320)]
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# K5 / K6 elementwise divides (plain)
# --------------------------------------------------------------------------

# the reference's Pallas arm at depth 1: its default depth 2 needs
# pltpu.TPUMemorySpace, which this jax no longer has
_DEPTH1 = KernelSpec(pipeline=PipelineSpec(depth=1))


def _div_operands(case, rng):
    """(a, b, expected arm) for each dispatch shape of the reference."""
    a = special_sample(rng, 6 * 5 * 80).reshape(6, 5, 80)
    col = special_sample(rng, 6 * 5).reshape(6, 5, 1)
    return {
        "rowbcast": (a, col, "rowbcast"),
        "rowbcast_lead_bcast": (a, col[:1], "rowbcast"),  # b [1, 5, 1]
        "scalar": (a, np.float32(1.7e-38), "rowbcast"),
        "general_row_vector": (a, special_sample(rng, 80), "general"),
        "general_same_shape": (a, special_sample(rng, a.size).reshape(a.shape),
                               "general"),
        "general_b_wider": (a[:, :1, :1], col, "general"),  # out != a.shape
    }[case]


@pytest.mark.parametrize("case", ["rowbcast", "rowbcast_lead_bcast", "scalar",
                                  "general_row_vector", "general_same_shape",
                                  "general_b_wider"])
@pytest.mark.parametrize("scheme", ["rapid9", "mitchell"])
def test_fused_elementwise_div_bit_exact_vs_reference(case, scheme,
                                                      monkeypatch):
    """Both arms, scalar and broadcast denominators, over 0, -0, +-inf,
    NaN bit patterns, subnormals and the overflow edge: bit-equal to
    ``approx_div`` and to the reference's Pallas arm (depth 1)."""
    a, b, arm = _div_operands(case, np.random.default_rng(len(case)))
    calls = []
    for name in ("div_rowbcast", "div_elementwise"):
        real = getattr(tfdops, name)
        monkeypatch.setattr(tfdops, name, lambda *x, _n=name, _f=real:
                            calls.append(_n) or _f(*x))
    got = fused_elementwise_div(T(a), torch.as_tensor(b), scheme).numpy()
    assert calls == ["div_rowbcast" if arm == "rowbcast" else
                     "div_elementwise"]
    oracle = np.asarray(jfa.approx_div(jnp.asarray(a), jnp.asarray(b), scheme))
    pallas = np.asarray(jfused_div(jnp.asarray(a), jnp.asarray(b), scheme,
                                   spec=_DEPTH1, interpret=True))
    assert_same_bits(got, oracle)
    assert_same_bits(got, pallas)


def test_fused_elementwise_div_keeps_dtype():
    a = torch.linspace(-3, 3, 40).reshape(4, 10).to(torch.bfloat16)
    b = torch.full((4, 1), 0.7, dtype=torch.bfloat16)
    got = fused_elementwise_div(a, b, "rapid9")
    assert got.dtype == torch.bfloat16 and got.shape == a.shape
    ref = tfa.log_div_f32(a.float(), b.float(), tfa.div_lut_device("rapid9"))
    assert torch.equal(got, ref.to(torch.bfloat16))


@pytest.mark.parametrize("x,y", [((4, 2, 80), (4, 2, 1)), ((4, 2, 80), ()),
                                 ((3, 1), (1, 5)), ((0, 3), (1, 3)),
                                 ((1,), (2, 0))])
def test_broadcast_shape_matches_torch(x, y):
    assert tfdops._broadcast_shape(x, y) == torch.broadcast_shapes(x, y)
    with pytest.raises(ValueError):
        tfdops._broadcast_shape(x + (3,), y + (2,))


def test_fused_elementwise_div_first_call_imports_no_sympy():
    """The dispatch broadcasts shapes in plain Python: torch's
    ``broadcast_shapes`` imports ``torch._refs`` and sympy at its first
    call, which cost a fresh server seconds on its first chunked-prefill
    tick.  Both arms, in a fresh process."""
    code = ("import sys, torch\n"
            "from repro_torch.kernels.fused_div.ops import "
            "fused_elementwise_div as f\n"
            "before = 'sympy' in sys.modules\n"
            "f(torch.ones(2, 8), torch.ones(2, 1), 'rapid9')\n"
            "f(torch.ones(2, 8), torch.ones(8), 'rapid9')\n"
            "print(before, 'sympy' in sys.modules)\n")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert out.stdout.split() == ["False", "False"]


@pytest.mark.parametrize("m,n", [(2048, 80), (7, 3), (1, 1)])
def test_div_plain_versions_bit_exact(m, n):
    """The kernels' own contracts: K5 ``a [M, N] / b [M]``, K6 same-shape."""
    rng = np.random.default_rng(m + n)

    def sample(k):  # special_sample puts its 18 fixed operands first
        return special_sample(rng, max(k, 18))[:k]
    a = sample(m * n).reshape(m, n)
    bv = sample(m)
    bf = sample(m * n).reshape(m, n)
    row = div_rowbcast_plain(T(a), T(bv), "rapid9").numpy()
    assert_same_bits(row, jfa.approx_div(jnp.asarray(a),
                                         jnp.asarray(bv)[:, None], "rapid9"))
    full = div_plain(T(a), T(bf), "rapid9").numpy()
    assert_same_bits(full, jfa.approx_div(jnp.asarray(a), jnp.asarray(bf),
                                          "rapid9"))


def test_plain_calls_do_not_count_launches():
    reset_launch_counts()
    log_matmul(torch.ones(2, 3), torch.ones(3, 4), "rapid10")
    fused_rms_div(torch.ones(2, 8), 1e-6, "rapid9")
    fused_elementwise_div(torch.ones(2, 8), torch.ones(2, 1), "rapid9")
    fused_elementwise_div(torch.ones(2, 8), torch.ones(8), "rapid9")
    rapid_mul(torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32))
    rapid_div(torch.ones(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32))
    assert launch_counts() == {"log_matmul": 0, "rms_div": 0,
                               "softmax_div": 0, "flash_decode": 0,
                               "div_rowbcast": 0, "div": 0,
                               "rapid_mul": 0, "rapid_div": 0}


def test_mixed_devices_raise():
    meta = torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError):
        log_matmul(meta, torch.ones(3, 4), "rapid10")
