"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; they skip where no CUDA device is present).

Run on the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX: the machine with the card has none.

Tolerances: K1 bit-equal to its plain version run on the card (same
products, same K order; torch's CUDA silu is x / (1 + expf(-x)), as the
kernel's); K2/K3 bit-equal (the kernels reduce in the plain version's
fixed lane grouping); K4 bit-equal to its plain version on the card
(the plain version takes the kernel's steps in its order) and within
rtol 1e-5, atol 1e-6 of it on the CPU (the CPU's exp and the card's
differ in the last bit); K5/K6 bit-equal (one log-domain divide per
element, no reduction).

The special-operand cases feed each kernel 0, -0, +-inf, NaNs,
subnormals and the operands next to the overflow edge
(``_torch_helpers.special_sample``), which reach the kernels' uint32
overflow test and their saturate / flush / sign logic, and require
bit-equality with the plain version on the same card, NaN payloads
aside (``assert_same_bits``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_helpers import (assert_same_bits, bits,  # noqa: E402
                            decode_case, int_pairs, randn, special_sample)
from repro_torch.kernels.flash_attn.ops import (  # noqa: E402
    flash_decode_attn, flash_decode_plain)
from repro_torch.kernels.fused_div.ops import (  # noqa: E402
    div_elementwise, div_plain, div_rowbcast, div_rowbcast_plain,
    fused_elementwise_div, fused_rms_div, fused_softmax_div, rms_div_plain,
    softmax_div_plain)
from repro_torch.kernels.log_matmul.ops import (log_matmul,  # noqa: E402
                                                log_matmul_plain)

T = torch.from_numpy


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 2560, 640), (9, 300, 130), (1, 5, 3),
                                   (70, 129, 65)])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_log_matmul_bit_exact(cuda, m, k, n, act, with_bias):
    rng = np.random.default_rng(m + k + n)
    x = T(randn(rng, m, k)).to(cuda)
    w = T(randn(rng, k, n, scale=0.05)).to(cuda)
    res = T(randn(rng, m, n)).to(cuda)
    bias = T(randn(rng, n)).to(cuda) if with_bias else None
    got = log_matmul(x, w, "rapid10", bias=bias, activation=act, residual=res)
    ref = log_matmul_plain(x, w, "rapid10", bias=bias, activation=act,
                           residual=res)
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(ref.cpu().numpy()))
    if act is None and not with_bias:  # and the CPU's plain version too
        cpu = log_matmul(x.cpu(), w.cpu(), "rapid10", residual=res.cpu())
        np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                      bits(cpu.numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(4, 2560), (33, 1000), (7, 12)])
def test_cuda_rms_div_matches_plain(cuda, rows, n):
    x = T(randn(np.random.default_rng(n), rows, n, scale=2.0)).to(cuda)
    got, den = fused_rms_div(x, 1e-6, "rapid9", return_denom=True)
    ref, rden = fused_rms_div(x.cpu(), 1e-6, "rapid9", return_denom=True)
    np.testing.assert_array_equal(bits(den.cpu().numpy()), bits(rden.numpy()))
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(ref.numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(512, 128), (3, 300)])
def test_cuda_softmax_div_matches_plain(cuda, rows, n):
    e = T(np.exp(randn(np.random.default_rng(n), rows, n))).to(cuda)
    got = fused_softmax_div(e, "rapid9")
    ref = fused_softmax_div(e.cpu(), "rapid9")
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(ref.numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("window,ring,empty", [(0, False, 0), (8, True, 0),
                                               (0, False, 7)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_decode_matches_plain(cuda, window, ring, empty, dtype):
    qf, kc, vc, sp, pos = decode_case(13, ring=ring, empty=empty, C=100)
    args = [T(qf).to(cuda), T(kc).to(cuda, dtype), T(vc).to(cuda, dtype),
            T(sp).to(cuda)]
    got = flash_decode_attn(*args, pos, window, "rapid9")
    ref = flash_decode_attn(*[a.cpu() for a in args], pos, window, "rapid9")
    np.testing.assert_allclose(got.cpu().numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("window,ring,empty", [(0, False, 0), (8, True, 0),
                                               (0, False, 7), (0, False, 0)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_cuda_flash_decode_bit_equal_on_card(cuda, window, ring, empty, dtype,
                                             scheme):
    """K4 and its plain version on the same card: the same bits, with a
    ragged cache (100 slots: 3 chunks and a padded one), per-slot
    positions and a fully masked row."""
    qf, kc, vc, sp, pos = decode_case(17, B=3, ring=ring, empty=empty, C=100)
    args = [T(qf).to(cuda), T(kc).to(cuda, dtype), T(vc).to(cuda, dtype),
            T(sp).to(cuda)]
    posv = torch.tensor([pos, -1, pos - 20], dtype=torch.int32, device=cuda)
    for p in (pos, posv):
        got = flash_decode_attn(*args, p, window, scheme)
        ref = flash_decode_plain(*args, p, window, scheme)
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_cuda_flash_decode_paged_decode_tick(cuda, scheme):
    """K4 at the continuous engine's decode tick: 4 slots, each gathering
    its 256-slot view out of a [65, 16, 8, 80] bf16 page pool through a
    page table, slot positions from kv_len (INT32_MAX past it), a [4]
    position vector of distinct depths and one inactive slot (kv_len 0:
    every slot masked)."""
    rng = np.random.default_rng(23)
    B, NP, PS, P, KV, G, hd = 4, 65, 16, 16, 8, 4, 80
    pool_k = T(randn(rng, NP, PS, KV, hd)).to(cuda, torch.bfloat16)
    pool_v = T(randn(rng, NP, PS, KV, hd)).to(cuda, torch.bfloat16)
    pages = rng.permutation(np.arange(1, NP, dtype=np.int64))
    table = np.zeros((B, P), np.int64)
    table[:3] = pages[:3 * P].reshape(3, P)  # slot 3 inactive: page 0
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=cuda)
    pos = torch.clamp(kv_len - 1, min=0)
    pt = T(table).to(cuda)
    kg = pool_k[pt].reshape(B, P * PS, KV, hd)
    vg = pool_v[pt].reshape(B, P * PS, KV, hd)
    j = torch.arange(P * PS, dtype=torch.int32, device=cuda)
    sp = torch.where(j[None] < kv_len[:, None], j[None], 2**31 - 1)
    qf = T(randn(rng, B, KV, G, hd, scale=hd ** -0.5)).to(cuda)
    got = flash_decode_attn(qf, kg, vg, sp, pos, 4096, scheme)
    ref = flash_decode_plain(qf, kg, vg, sp, pos, 4096, scheme)
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    assert not got[3].any()  # the inactive slot attends to nothing


@pytest.mark.gpu
def test_cuda_log_matmul_refuses_unported_activation(cuda):
    x = torch.ones(2, 3, device=cuda)
    w = torch.ones(3, 4, device=cuda)
    with pytest.raises(NotImplementedError, match="gelu"):
        log_matmul(x, w, "rapid10", activation="gelu")


# operands near 1 and 2, whose products sit next to the overflow edge when
# the other operand is 0x7F7FFFFF
_NEAR_ONE = np.array([1.0000001, 1.9999999, 2.0, 1.5, 0.99999994],
                     np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("regime_m", [None, 4, 9, 100])
def test_cuda_log_matmul_special_operands(cuda, k, act, regime_m):
    """K = 1 is every pair of special operands as one product each; K = 3
    adds the sums (inf - inf, overflow of the accumulator).  ``regime_m``
    sets M to land in the decode, chunk or prefill regime (None: 256
    rows at K = 1, 64 at K = 3)."""
    rng = np.random.default_rng(100 + k + (regime_m or 0))
    m, n = (256, 256) if k == 1 else (64, 96)
    m = regime_m or m
    if regime_m is None:
        xs = special_sample(rng, m * k).reshape(m, k)
    else:  # a few rows: a shuffled draw, so they are not all 0 / inf
        xs = rng.permutation(special_sample(rng, max(m * k, 64)))
        xs = xs[:m * k].reshape(m, k)
    ws = special_sample(rng, k * n)
    ws[-len(_NEAR_ONE):] = _NEAR_ONE
    x, w = T(xs).to(cuda), T(ws.reshape(k, n)).to(cuda)
    res = T(randn(rng, m, n)).to(cuda)
    got = log_matmul(x, w, "rapid10", activation=act, residual=res)
    ref = log_matmul_plain(x, w, "rapid10", activation=act, residual=res)
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


def _special_rms_rows(rng, rows, n):
    """Rows over the whole exponent range (sums of squares that overflow
    to inf or underflow to 0), a zero row, and one special operand per
    row in column 0."""
    x = randn(rng, rows, n) * (10.0 ** rng.uniform(-40, 37, (rows, 1)))
    x = x.astype(np.float32)
    x[0] = 0.0
    x[:, 0] = special_sample(rng, rows)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", [(64, 2560), (300, 3)])
@pytest.mark.parametrize("eps", [1e-6, 0.0])
def test_cuda_rms_div_special_operands(cuda, rows, n, eps):
    """eps = 0 lets the denominator reach 0 and subnormal values, so the
    divide meets x / 0 and quotients past the overflow edge."""
    rng = np.random.default_rng(rows + n)
    x = (_special_rms_rows(rng, rows, n) if n > 3
         else special_sample(rng, rows * n).reshape(rows, n))
    xt = T(x).to(cuda)
    got, den = fused_rms_div(xt, eps, "rapid9", return_denom=True)
    ref, rden = rms_div_plain(xt, eps, "rapid9", return_denom=True)
    assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


def _cancelling_rows():
    """Rows whose sums cancel to 0 or go negative, so the floored
    denominator (1e-20) meets large dividends: quotients past inf."""
    big = np.array([[3.0e38, -3.0e38, 1.0], [1e30, -1e30, 1e-10],
                    [1e19, -2e19, 0.0], [-5.0, 1.0, 1.0],
                    [3.4028235e38, -3.4028233e38, 0.0],
                    [1e-30, -1e-30, 1e-45]], np.float32)
    return big


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 3, 128])
def test_cuda_softmax_div_special_operands(cuda, n):
    rng = np.random.default_rng(7 * n)
    e = special_sample(rng, 512 * n).reshape(512, n)
    if n == 3:
        e[-6:] = _cancelling_rows()
    et = T(e).to(cuda)
    got, den = fused_softmax_div(et, "rapid9", return_denom=True)
    ref, rden = softmax_div_plain(et, "rapid9", return_denom=True)
    assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_special_values(cuda, dtype):
    """The final divide acc / max(l, floor) on special dividends.  With
    q = 0 every live score is exactly 0, so both versions weigh each live
    slot by 1: l is the live count (1, 3, 7, 41) and acc is slot 0's
    value, a special operand, since the other slots hold zeros."""
    B, C, KV, G, hd = 4, 48, 2, 4, 80
    rng = np.random.default_rng(11)
    qf = np.zeros((B, KV, G, hd), np.float32)
    kc = randn(rng, B, C, KV, hd)
    vc = np.zeros((B, C, KV, hd), np.float32)
    vc[:, 0] = special_sample(rng, B * KV * hd).reshape(B, KV, hd)
    sp = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    pos = torch.tensor([0, 2, 6, 40], dtype=torch.int32, device=cuda)
    args = [T(qf).to(cuda), T(kc).to(cuda, dtype), T(vc).to(cuda, dtype),
            T(sp).to(cuda)]
    got = flash_decode_attn(*args, pos, 0, "rapid9")
    ref = flash_decode_plain(*args, pos, 0, "rapid9")
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("m,n", [(2048, 80), (266240, 80), (5, 3), (33, 129)])
def test_cuda_div_rowbcast_matches_plain(cuda, m, n):
    """K5 at the chunked-prefill (2048 x 80) and blockwise (266240 x 80)
    shapes and ragged ones, special operands in both operands."""
    rng = np.random.default_rng(m + n)
    a = T(special_sample(rng, max(m * n, 18))[: m * n].reshape(m, n)).to(cuda)
    b = T(special_sample(rng, max(m, 18))[:m]).to(cuda)
    got = div_rowbcast(a, b, "rapid9")
    ref = div_rowbcast_plain(a, b, "rapid9")
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2048, 2048), (7, 5), (1,)])
def test_cuda_div_elementwise_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    k = int(np.prod(shape))
    a = T(special_sample(rng, max(k, 18))[:k].reshape(shape)).to(cuda)
    b = T(special_sample(rng, max(k, 18))[::-1][:k].copy().reshape(shape))
    got = div_elementwise(a, b.to(cuda), "rapid9")
    ref = div_plain(a, b.to(cuda), "rapid9")
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("b_shape", [(), (1,), (4, 2, 1), (2, 1), (80,),
                                     (4, 2, 80)])
def test_cuda_fused_elementwise_div_matches_cpu(cuda, b_shape):
    """Both arms through the dispatch (scalar, [..., 1] and general
    broadcasts of b against a [4, 2, 80]), on the card and on the CPU:
    the same bits."""
    rng = np.random.default_rng(len(b_shape))
    a = special_sample(rng, 640).reshape(4, 2, 80)
    b = special_sample(rng, max(int(np.prod(b_shape)), 18))
    b = b[: int(np.prod(b_shape))].reshape(b_shape)
    got = fused_elementwise_div(T(a).to(cuda), T(b).to(cuda), "rapid9")
    ref = fused_elementwise_div(T(a), T(b), "rapid9")
    assert_same_bits(got.cpu().numpy(), ref.numpy())


@pytest.mark.gpu
def test_cuda_div_kernels_count_launches(cuda):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    a = torch.ones(4, 80, device=cuda)
    fused_elementwise_div(a, torch.full((4, 1), 3.0, device=cuda), "rapid9")
    fused_elementwise_div(a, torch.full((80,), 3.0, device=cuda), "rapid9")
    counts = launch_counts()
    assert counts["div_rowbcast"] == 1 and counts["div"] == 1


# --------------------------------------------------------------------------
# K9 / K10: the integer RAPID units, bit-equal to their plain versions
# --------------------------------------------------------------------------

def _int_operands(rng, n, a_bits, b_bits):
    return (T(v.astype(np.int64)) for v in int_pairs(rng, n, a_bits, b_bits))


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [8, 12, 16])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid3", "rapid5", "rapid10"])
def test_cuda_rapid_mul_matches_plain(cuda, n_bits, scheme):
    from repro_torch.kernels.rapid_mul.ops import rapid_mul, rapid_mul_plain
    if n_bits == 8:  # exhaustive, the Table III method
        g = np.arange(256, dtype=np.int64)
        a, b = (T(v.ravel().copy()) for v in np.meshgrid(g, g))
    else:
        a, b = _int_operands(np.random.default_rng(n_bits), 1 << 20,
                             n_bits, n_bits)
    got = rapid_mul(a.to(cuda).to(torch.int32), b.to(cuda), scheme, n_bits)
    ref = rapid_mul_plain(a.to(cuda), b.to(cuda), scheme, n_bits)
    assert got.dtype == torch.int64
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), rapid_mul_plain(a, b, scheme, n_bits),
                               rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [4, 8, 15])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid3", "rapid5", "rapid9"])
def test_cuda_rapid_div_matches_plain(cuda, n_bits, scheme):
    from repro_torch.kernels.rapid_div.ops import rapid_div, rapid_div_plain
    a, b = _int_operands(np.random.default_rng(n_bits), 1 << 20,
                         2 * n_bits, n_bits)
    if n_bits == 8:  # every divisor against a sweep of dividends
        g = np.arange(1 << 16, dtype=np.int64)
        a = torch.cat([a, T(np.tile(g, 4))])
        b = torch.cat([b, T(np.repeat(np.arange(256, dtype=np.int64), 1024))])
    got = rapid_div(a.to(cuda), b.to(cuda).to(torch.int16), scheme, n_bits)
    ref = rapid_div_plain(a.to(cuda), b.to(cuda), scheme, n_bits)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got.cpu(), rapid_div_plain(a, b, scheme, n_bits),
                               rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_rapid_int_broadcast_empty_and_counts(cuda):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.rapid_div.ops import rapid_div, rapid_div_plain
    from repro_torch.kernels.rapid_mul.ops import rapid_mul, rapid_mul_plain
    reset_launch_counts()
    a = torch.arange(60, device=cuda).reshape(3, 20)
    b = torch.arange(20, device=cuda)
    torch.testing.assert_close(rapid_mul(a, b), rapid_mul_plain(a, b),
                               rtol=0, atol=0)
    torch.testing.assert_close(rapid_div(a, b[:1] + 3), rapid_div_plain(a, b[:1] + 3),
                               rtol=0, atol=0)
    assert rapid_mul(a[:0], b).shape == (0, 20)
    with pytest.raises(TypeError):
        rapid_mul(a.float(), b)
    counts = launch_counts()
    assert counts["rapid_mul"] == 1 and counts["rapid_div"] == 1


# --------------------------------------------------------------------------
# K1 with a batch dimension
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("b,m,k,n", [(1024, 8, 8, 8), (3, 5, 70, 33),
                                     (2, 9, 300, 130), (4, 1, 5, 3)])
@pytest.mark.parametrize("bcast", ["none", "x", "w"])
@pytest.mark.parametrize("bias_kind", [None, "shared", "per_batch"])
def test_cuda_log_matmul_batched_bit_exact(cuda, b, m, k, n, bcast, bias_kind):
    rng = np.random.default_rng(b + m + k + n)
    x = T(randn(rng, b, m, k)).to(cuda)
    w = T(randn(rng, b, k, n, scale=0.1)).to(cuda)
    if bcast == "x":
        x = x[:1].expand(b, m, k)  # stride 0: never copied
    elif bcast == "w":
        w = w[:1].expand(b, k, n)
    bias = {None: None, "shared": T(randn(rng, n)),
            "per_batch": T(randn(rng, b, n))}[bias_kind]
    bias = None if bias is None else bias.to(cuda)
    res = T(randn(rng, b, m, n)).to(cuda)
    for act, r in ((None, None), ("silu", res)):
        got = log_matmul(x, w, "rapid10", bias=bias, activation=act, residual=r)
        ref = log_matmul_plain(x, w, "rapid10", bias=bias, activation=act,
                               residual=r)
        assert got.shape == (b, m, n)
        np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                      bits(ref.cpu().numpy()))
    # and each batch entry equals the 2-D call on it
    got = log_matmul(x, w, "rapid10")
    for i in (0, b - 1):
        np.testing.assert_array_equal(
            bits(got[i].cpu().numpy()),
            bits(log_matmul(x[i].contiguous(), w[i].contiguous(),
                            "rapid10").cpu().numpy()))


@pytest.mark.gpu
def test_cuda_qmatmul_batched_one_launch(cuda):
    from repro_torch.core.ops import qmatmul_batched
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(0)
    c = T(randn(rng, 8, 8)).to(cuda)
    blocks = T(randn(rng, 4096, 8, 8)).to(cuda)
    reset_launch_counts()
    out = qmatmul_batched(c.expand(4096, 8, 8), blocks, "rapid10")
    assert launch_counts()["log_matmul"] == 1
    ref = log_matmul_plain(c, blocks, "rapid10")
    np.testing.assert_array_equal(bits(out.cpu().numpy()),
                                  bits(ref.cpu().numpy()))


# --------------------------------------------------------------------------
# the applications: kernel route == plain route on the card
# --------------------------------------------------------------------------

APP_VARIANTS = ["accurate", "rapid", "rapid5", "mitchell", "truncated"]


def _both_routes(fn):
    """``fn()`` through the kernels and through the plain versions, with
    the launch counts of each run."""
    from repro_torch.kernels import (launch_counts, plain_versions,
                                     reset_launch_counts)
    reset_launch_counts()
    got = fn()
    k_counts = launch_counts()
    reset_launch_counts()
    with plain_versions():
        ref = fn()
    assert not any(launch_counts().values()), launch_counts()
    return got, ref, k_counts


@pytest.mark.gpu
@pytest.mark.parametrize("variant", APP_VARIANTS)
def test_cuda_apps_kernel_route_equals_plain(cuda, variant):
    from repro_torch.apps import harris, jpeg, pan_tompkins
    from repro_torch.apps.arith import VARIANTS
    v = VARIANTS[variant]
    scheme = variant not in ("accurate", "truncated")
    img = jpeg.synthetic_aerial(64, seed=1)
    got, ref, counts = _both_routes(lambda: jpeg.jpeg_roundtrip(img, v))
    np.testing.assert_array_equal(bits(got), bits(ref))
    assert (counts["log_matmul"] == 4 and counts["div"] == 1) == scheme
    sig, _ = pan_tompkins.synthetic_ecg(8, seed=1)
    der = torch.from_numpy(pan_tompkins._bandpass_derivative(sig)).to(cuda)
    got, ref, counts = _both_routes(
        lambda: pan_tompkins.integrate_energy(der, v))
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(ref.cpu().numpy()))
    assert (counts["div"] == 1) == scheme
    gx, gy = harris.normalized_gradients(harris.synthetic_scene(96, seed=1))
    got, ref, counts = _both_routes(lambda: harris.harris_response(gx, gy, v))
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(ref.cpu().numpy()))
    assert (counts["div"] == 1) == scheme


# --------------------------------------------------------------------------
# K7 / K8: stage counts of K1 and K2/K3/K5, bit-equal at every depth
# --------------------------------------------------------------------------

def _depth(d):
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    return KernelSpec(pipeline=PipelineSpec(depth=d))


def _misaligned(t):
    """``t``'s values in a contiguous tensor whose data starts 4 B past a
    16 B boundary, so the kernels take their 4 B copies."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,k,n", [
    (4, 2560, 640),   # decode regime, 40 K blocks
    (4, 20, 640),     # decode, one K block (nk < depth)
    (130, 256, 192),  # prefill, 16 B copies, ragged M
    (64, 300, 130),   # K % BK != 0, N % 4 != 0 (4 B copies for w)
    (70, 129, 65),    # K % 4 != 0 (4 B copies for x)
    (9, 24, 130),     # two K blocks, fewer than depth 3, 4, 8
    # every decode instance (1, 2, 4, 8 warps) and the regime edges,
    # each with N ragged against the 32- and 128-column tiles and not a
    # multiple of 4
    (1, 200, 97),     # decode, one warp
    (2, 130, 33),     # decode, two warps, one column past a tile
    (3, 300, 70),     # decode, a padding warp (4 for 3 rows)
    (5, 129, 131),    # decode, three padding warps (8 for 5 rows)
    (8, 64, 65),      # decode, eight warps, exactly one K block
    (63, 100, 97),    # chunk, a ragged last 16-row tile
    (65, 70, 130),    # prefill, one live row in the last 32-row tile
    (512, 48, 259),   # prefill at the train path's M
])
def test_cuda_log_matmul_depths_bit_exact(cuda, depth, m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = T(randn(rng, m, k)).to(cuda)
    w = T(randn(rng, k, n, scale=k ** -0.5)).to(cuda)
    bias = T(randn(rng, n)).to(cuda)
    res = T(randn(rng, m, n)).to(cuda)
    for kw in (dict(), dict(bias=bias, activation="silu", residual=res)):
        got = log_matmul(x, w, "rapid10", spec=_depth(depth), **kw)
        ref = log_matmul_plain(x, w, "rapid10", **kw)
        np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                      bits(ref.cpu().numpy()))
    got = log_matmul(_misaligned(x), _misaligned(w), "rapid10",
                     spec=_depth(depth))
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(log_matmul_plain(x, w, "rapid10")
                                       .cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
def test_cuda_log_matmul_depths_norm_tail_and_batched(cuda, depth):
    """The rms tail (a K2 launch at K1's depth) with keep_prenorm, and
    JPEG's batched 8 x 8 products with the basis broadcast (nk = 1)."""
    from repro_torch.core.backend import Epilogue
    rng = np.random.default_rng(depth)
    x = T(randn(rng, 33, 200)).to(cuda)
    w = T(randn(rng, 200, 300, scale=0.07)).to(cuda)
    res = T(randn(rng, 33, 300)).to(cuda)
    ep = Epilogue(norm="rms", div_scheme="rapid9", keep_prenorm=True)
    got = log_matmul(x, w, "rapid10", residual=res, epilogue=ep,
                     spec=_depth(depth))
    ref = log_matmul_plain(x, w, "rapid10", residual=res, epilogue=ep)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(bits(a.cpu().numpy()),
                                      bits(b.cpu().numpy()))
    basis = T(randn(rng, 8, 8)).to(cuda)
    blocks = T(randn(rng, 256, 8, 8)).to(cuda)
    for xb, wb in ((basis.expand(256, 8, 8), blocks),
                   (blocks, basis.expand(256, 8, 8))):
        got = log_matmul(xb, wb, "rapid10", spec=_depth(depth))
        ref = log_matmul_plain(xb, wb, "rapid10")
        np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                      bits(ref.cpu().numpy()))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64, 512])
def test_cuda_log_matmul_counts_launches_by_depth(cuda, m):
    """One count per launch, filed under the depth the call resolved to
    (the regime's default when the spec defers it), in every regime."""
    from repro_torch.kernels import (launch_counts, launch_counts_by_depth,
                                     reset_launch_counts)
    from repro_torch.kernels.spec import resolve_spec
    x = torch.ones(m, 64, device=cuda)
    w = torch.ones(64, 64, device=cuda)
    default = resolve_spec("log_matmul", (m, 64, 64)).depth
    reset_launch_counts()
    log_matmul(x, w, "rapid10")
    log_matmul(x, w, "rapid10", spec=_depth(1))
    log_matmul(x, w, "rapid10", spec=_depth(3))
    assert launch_counts()["log_matmul"] == 3
    expect = {}
    for d in (default, 1, 3):
        expect[d] = expect.get(d, 0) + 1
    assert launch_counts_by_depth()["log_matmul"] == expect


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m,n", [(4, 70), (1, 33), (64, 130), (200, 259)])
def test_cuda_log_matmul_lean_and_full_blocks_in_one_call(cuda, depth, m, n):
    """One call whose K blocks take both paths: a zero, a subnormal, an
    inf and -0 each in a block of their own, and products at the lean
    proof's MIN_NORMAL / INF_BITS edges; the plain blockwise model says
    which blocks are lean, and the kernel must give the plain version's
    bits at every depth."""
    from repro_torch.kernels.log_matmul.ops import (log_matmul_blocks,
                                                    mixed_blocks)
    from repro_torch.kernels.spec import matmul_geometry
    rng = np.random.default_rng(7 * m + n + depth)
    bk = matmul_geometry(m, n)[2]
    x, w = mixed_blocks(rng, m, 7 * bk + 5, n, bk)
    verdicts = log_matmul_blocks(T(x), T(w), "rapid10",
                                 *matmul_geometry(m, n))[1].values()
    assert any(verdicts) and not all(verdicts)
    xt, wt = T(x).to(cuda), T(w).to(cuda)
    for args in ((xt, wt), (_misaligned(xt), _misaligned(wt))):
        got = log_matmul(*args, "rapid10", spec=_depth(depth))
        ref = log_matmul_plain(xt, wt, "rapid10")
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("m", [1, 3, 8, 9, 64, 65, 512])
def test_cuda_log_matmul_lean_proof_at_its_edges(cuda, depth, m):
    """The in-kernel proof at its own bounds, in every regime: in each
    output tile, K block 0's operands give min a + min m + lut_min ==
    MIN_NORMAL and max a + max m + lut_max == INF_BITS - 1 exactly (the
    plain model proves it lean), block 1 sits one step below the lower
    bound and block 2 one step above the upper (the model refuses both),
    with real products on each bound; the kernel must give the plain
    version's bits at every depth, N ragged against the tiles."""
    from repro_torch.kernels.log_matmul.ops import (edge_blocks,
                                                    log_matmul_blocks)
    from repro_torch.kernels.spec import matmul_geometry
    n = 133
    geom = matmul_geometry(m, n)
    bk = geom[2]
    x, w = edge_blocks(np.random.default_rng(m + depth), m, 4 * bk + 5, n, bk)
    verdicts = log_matmul_blocks(T(x), T(w), "rapid10", *geom)[1]
    assert [verdicts[(0, 0, b * bk)] for b in range(4)] == [True, False,
                                                             False, True]
    xt, wt = T(x).to(cuda), T(w).to(cuda)
    ref = log_matmul_plain(xt, wt, "rapid10")
    assert torch.isfinite(ref).any()
    for args in ((xt, wt), (_misaligned(xt), _misaligned(wt))):
        got = log_matmul(*args, "rapid10", spec=_depth(depth))
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
def test_cuda_log_matmul_refuses_an_uncompiled_regime(cuda):
    """The entry point launches the regime the wrapper passes and
    refuses a regime / geometry pair it did not compile for the shape."""
    from repro_torch.core.backend import Epilogue
    from repro_torch.kernels.log_matmul import ops
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    x = torch.ones(9, 64, device=cuda)
    w = torch.ones(64, 64, device=cuda)
    for regime, geom in (("decode", (8, 32, 64)), ("prefill", (64, 64, 16)),
                         ("chunk", (32, 128, 16)), ("block8", (8, 8, 8))):
        ks = KernelSpec(*geom, pipeline=PipelineSpec(depth=1))
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._kernel(x, w, "rapid10", None, None, Epilogue(), ks, regime)


_ROW_CASES = [
    (1, 2560, None),    # one slab, fewer than depth
    (37, 1000, None),   # ragged last slab, n % 128 != 0
    (33, 130, 3),       # n % 4 != 0: 4 B copies; bm = 3
    (512, 2560, None),  # the train path's ln1 / ln2 / final norm
    (5000, 12, 1),      # more slabs than blocks: each block walks several
]


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rows,n,bm", _ROW_CASES)
def test_cuda_row_dividers_depths_bit_exact(cuda, depth, rows, n, bm):
    """K2 / K3 / K5 at every depth against their plain versions on the
    card, denominators included; special operands head every row set."""
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    spec = KernelSpec(bm=bm, pipeline=PipelineSpec(depth=depth))
    rng = np.random.default_rng(rows + n + depth)
    x = T(randn(rng, rows, n, scale=2.0)).to(cuda)
    x.view(-1)[:18] = T(special_sample(rng, 18)).to(cuda)
    got, den = fused_rms_div(x, 1e-6, "rapid9", return_denom=True, spec=spec)
    ref, rden = rms_div_plain(x, 1e-6, "rapid9", return_denom=True)
    assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    e = torch.exp(x.clamp(-30, 30))
    e.view(-1)[:18] = x.view(-1)[:18]
    got, den = fused_softmax_div(e, "rapid9", return_denom=True, spec=spec)
    ref, rden = softmax_div_plain(e, "rapid9", return_denom=True)
    assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    b = T(special_sample(rng, max(rows, 18))[:rows]).to(cuda)
    got = div_rowbcast(x, b, "rapid9", spec=spec)
    assert_same_bits(got.cpu().numpy(),
                     div_rowbcast_plain(x, b, "rapid9").cpu().numpy())
    if depth > 1:  # and from a start 4 B past a 16 B boundary
        got = fused_rms_div(_misaligned(x), 1e-6, "rapid9", spec=spec)
        assert_same_bits(got.cpu().numpy(),
                         rms_div_plain(x, 1e-6, "rapid9").cpu().numpy())


@pytest.mark.gpu
def test_cuda_loss_backward_through_kernels_equals_plain(cuda):
    """``loss.backward()`` of a reduced RAPID model (4 x 32 tokens: K1 in
    its prefill regime at its default depth, 3 -- K7 --, K2/K3 at depth
    2) through the kernels
    and through the plain versions on the card.  Bound: every kernel is
    bit-equal to its plain version (silu within 2 ulp) and the backward
    is the same torch ops, so the loss agrees within rel 1e-5 and every
    gradient within 1e-5 x its largest magnitude."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import (launch_counts_by_depth, plain_versions,
                                     reset_launch_counts)
    from repro_torch.kernels.spec import resolve_spec
    from repro_torch.models.model import Model
    from repro_torch.models.params import tree_leaves

    cfg = get_config("h2o_danube_1_8b").reduced().with_(approx=RAPID,
                                                         remat="block")
    model = Model(cfg)
    params = model.init(0, cuda)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in
             SyntheticLM(cfg.vocab_size, 32, 4, seed=2).batch_at(0).items()}
    runs = []
    for plain in (False, True):
        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        reset_launch_counts()
        if plain:
            with plain_versions():
                loss = model.loss_fn(params, batch)
                loss.backward()
        else:
            loss = model.loss_fn(params, batch)
            loss.backward()
        runs.append((float(loss), [p.grad.clone() for p in leaves],
                     launch_counts_by_depth()))
    (lk, gk, ck), (lp, gp, cp) = runs
    k1_depth = resolve_spec("log_matmul", (4 * 32, cfg.d_model,
                                           cfg.d_model)).depth
    assert k1_depth >= 2  # K7
    assert ck["log_matmul"].get(k1_depth, 0) > 0
    assert ck["rms_div"].get(2, 0) > 0
    assert ck["softmax_div"].get(2, 0) > 0
    assert not any(sum(v.values()) for v in cp.values())
    assert abs(lk - lp) <= 1e-5 * abs(lp)
    for a, b in zip(gk, gp):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
