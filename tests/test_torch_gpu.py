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
def test_cuda_log_matmul_special_operands(cuda, k, act):
    """K = 1 is every pair of special operands as one product each; K = 3
    adds the sums (inf - inf, overflow of the accumulator)."""
    rng = np.random.default_rng(100 + k)
    m, n = (256, 256) if k == 1 else (64, 96)
    xs = special_sample(rng, m * k).reshape(m, k)
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
