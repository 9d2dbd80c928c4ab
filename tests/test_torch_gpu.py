"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; they skip where no CUDA device is present).

Run on the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX: the machine with the card has none.

Tolerances: K1 bit-equal to its plain version run on the card (same
products, same K order; torch's CUDA silu is x / (1 + expf(-x)), as the
kernel's); K2/K3 bit-equal (the kernels reduce in the plain version's
fixed lane grouping); K4 rtol 1e-5, atol 1e-6 (online vs global softmax
max, different dot orders).

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
                            decode_case, randn, special_sample)
from repro_torch.kernels.flash_attn.ops import (  # noqa: E402
    flash_decode_attn, flash_decode_plain)
from repro_torch.kernels.fused_div.ops import (  # noqa: E402
    fused_rms_div, fused_softmax_div, rms_div_plain, softmax_div_plain)
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
