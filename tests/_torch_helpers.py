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


def perturb_ln(tree, seed: int = 5):
    """A model's param tree (nested dicts of arrays) with every LN's scale
    and bias (a dict holding both) drawn from a seed, as float32 numpy,
    instead of the init's ones and zeros, so both reach the logits."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if not isinstance(t, dict):
            return t
        if {"scale", "bias"} <= set(t):
            shape = np.shape(t["scale"])
            return dict(t, scale=(1.0 + 0.2 * rng.standard_normal(shape)
                                  ).astype(np.float32),
                        bias=(0.2 * rng.standard_normal(shape)
                              ).astype(np.float32))
        return {k: walk(v) for k, v in t.items()}
    return walk(tree)


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


def fold_every_chunk(qf, kc, vc, sp, pos, window, scheme, bc, seg):
    """K4's order of operations with no chunk skipped (torch tensors on
    any device): ``flash_decode_plain`` folds a chunk without a live slot
    into (m, l, acc) here instead of passing over it, so equal bits show
    that the skip moves nothing (for finite caches: 0 x inf would not
    vanish)."""
    import torch

    from repro_torch.core import float_approx as fa
    from repro_torch.kernels.fused_div.ref import SOFTMAX_FLOOR
    B, KV, G, hd = qf.shape
    C = kc.shape[1]
    n = -(-C // bc)
    pad = n * bc - C
    posq = torch.as_tensor(pos, dtype=torch.int32,
                           device=qf.device).reshape(-1, 1)
    valid = sp <= posq
    if window:
        valid &= sp > posq - window
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    kt = torch.nn.functional.pad(kc.float(), (0, 0, 0, 0, 0, pad))
    vt = torch.nn.functional.pad(vc.float(), (0, 0, 0, 0, 0, pad))
    kt, vt = kt.permute(0, 2, 3, 1), vt.permute(0, 2, 1, 3)
    dot = torch.zeros((B, KV, G, n * bc), device=qf.device)
    for d in range(hd):
        dot = dot + qf[..., d, None] * kt[:, :, None, d, :]
    s = torch.where(valid[:, None, None, :], dot, -torch.inf)
    parts = []
    for lo in range(0, n, seg // bc):
        m = torch.full((B, KV, G), -torch.inf, device=qf.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, hd), device=qf.device)
        for ci in range(lo, min(lo + seg // bc, n)):
            sc = s[..., ci * bc:(ci + 1) * bc]
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.where(torch.isfinite(m_new)[..., None],
                            torch.exp(sc - m_new[..., None]), 0.0)
            pv = torch.zeros_like(acc)
            for j in range(bc):
                pv = pv + p[..., j, None] * vt[:, :, None, ci * bc + j, :]
            total = p
            while total.shape[-1] > 1:
                h = total.shape[-1] // 2
                total = total[..., :h] + total[..., h:]
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
            l = l * corr + total[..., 0]
            acc = acc * corr[..., None] + pv
            m = m_new
        parts.append((m, l, acc))
    m_g = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    l_g, acc_g = torch.zeros_like(m_g), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_g), 0.0)
        l_g = l_g + l * corr
        acc_g = acc_g + acc * corr[..., None]
    den = torch.where(l_g < SOFTMAX_FLOOR, SOFTMAX_FLOOR, l_g)[..., None]
    if scheme:
        return fa.log_div_f32(acc_g, den,
                              fa.div_lut_device(scheme, qf.device))
    return acc_g / den
