"""Shared helpers for the port's tests (``tests/test_torch_*.py``): numpy
inputs made from a seed, and bit / ulp comparisons of float32 arrays."""
import numpy as np


def bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def ulp_diff(a, b) -> np.ndarray:
    """|a - b| in units in the last place, for finite float32 arrays."""
    ia = bits(a).astype(np.int64)
    ib = bits(b).astype(np.int64)
    # map sign-magnitude to a monotone integer line
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def special_sample(rng, n: int) -> np.ndarray:
    """float32 operands over the whole exponent range, a quarter of them
    raw bit patterns (NaNs included), plus 0, -0, +-inf, subnormals and
    the operands next to the overflow edge."""
    mag = rng.uniform(-45, 45, n)
    x = (rng.choice([-1.0, 1.0], n) * 2.0 ** mag).astype(np.float32)
    raw = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[: n // 4] = raw[: n // 4].view(np.float32)
    sp = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-42, 3.4e38,
                   -3.4e38, 1.0, 1e-38, 2.0**64, 2.0**-64], np.float32)
    edge = np.array([0x7F7FFFFF, 0x7F7FFFFE, 0x7F000000, 0x00800000,
                     0x00800001, 0xFF7FFFFF], np.uint32).view(np.float32)
    x[: len(sp)] = sp
    x[len(sp): len(sp) + len(edge)] = edge
    return x


def randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def decode_case(seed, B=2, C=40, KV=2, G=4, hd=80, ring=False, empty=0):
    rng = np.random.default_rng(seed)
    qf = randn(rng, B, KV, G, hd, scale=0.1)
    kc, vc = randn(rng, B, C, KV, hd), randn(rng, B, C, KV, hd)
    if ring:  # ring cache: slot i holds position base + (i - base) % C
        base = 57
        slots = np.array([base - C + ((i - base) % C) for i in range(C)],
                         np.int32)
        pos = base - 1
    else:
        slots = np.arange(C, dtype=np.int32)
        pos = C - 1 - empty
    sp = np.broadcast_to(slots, (B, C)).copy()
    if empty:
        sp[:, C - empty:] = np.iinfo(np.int32).max
    return qf, kc, vc, sp, pos


def assert_same_bits(got, ref) -> None:
    """float32 arrays bit-equal, NaN payloads aside: NaN in the same
    places, every other element the same bit pattern (so +0 != -0)."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    nan_g, nan_r = np.isnan(got), np.isnan(ref)
    np.testing.assert_array_equal(nan_g, nan_r, err_msg="NaN positions")
    bad = np.flatnonzero((bits(got) != bits(ref)) & ~nan_g)
    assert bad.size == 0, (
        f"{bad.size} elements differ, first at flat index {bad[0]}: "
        f"{got.flat[bad[0]]!r} ({bits(got).flat[bad[0]]:#010x}) vs "
        f"{ref.flat[bad[0]]!r} ({bits(ref).flat[bad[0]]:#010x})")


def int_pairs(rng, n: int, a_bits: int, b_bits: int):
    """Random unsigned operand pairs (uint32) headed by the special
    operands of the integer units: 0 on either side and on both, 1, the
    largest values, a < b, and the divider's b = 0."""
    a = rng.integers(0, 1 << a_bits, n).astype(np.uint32)
    b = rng.integers(0, 1 << b_bits, n).astype(np.uint32)
    amax, bmax = (1 << a_bits) - 1, (1 << b_bits) - 1
    sa = [0, 5, 0, 1, 1, amax, amax, 1, 3, bmax, amax, 2]
    sb = [7, 0, 0, 1, bmax, 1, bmax, 0, bmax, 1, 0, 3]
    k = min(n, len(sa))
    a[:k], b[:k] = sa[:k], sb[:k]
    return a, b
