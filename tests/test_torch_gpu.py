"""The port's CUDA kernels against their plain PyTorch versions, on the
card (marked ``gpu``; they skip where no CUDA device is present).

Run on the card with ``python -m pytest -q -m gpu tests/test_torch_gpu.py``.
This file imports no JAX: the machine with the card has none.

Tolerances: K1 bit-equal to its plain version run on the card (same
products, same K order; torch's CUDA silu is x / (1 + expf(-x)), as the
kernel's), its tanh gelu epilogue within GELU_ULP of torch's
``F.gelu(approximate="tanh")`` on the card (the kernel takes torch's
steps, its one fma written out; measured bit-equal); K2/K3 bit-equal
(the kernels reduce in the plain version's fixed lane grouping); K4
bit-equal to its plain version on the card
(the plain version takes the kernel's steps in its order) and within
rtol 1e-5, atol 1e-6 of it on the CPU (the CPU's exp and the card's
differ in the last bit), at every segment geometry, run to run, and
equal to the order that folds the chunks its skips; K5/K6 bit-equal
(one log-domain divide per element, no reduction); K9/K10 bit-equal,
uint32 as the reference (integer units).

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
                            decode_case, int_pairs, randn, special_sample,
                            ulp_diff)
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


def _flash_rows(seed, B, C, KV=2, G=4, hd=80):
    rng = np.random.default_rng(seed)
    qf = randn(rng, B, KV, G, hd, scale=hd ** -0.5)
    kc, vc = randn(rng, B, C, KV, hd), randn(rng, B, C, KV, hd)
    sp = np.broadcast_to(np.arange(C, dtype=np.int32), (B, C)).copy()
    return qf, kc, vc, sp


def _on(cuda, dtype, qf, kc, vc, sp):
    return [T(qf).to(cuda), T(kc).to(cuda, dtype), T(vc).to(cuda, dtype),
            T(sp).to(cuda)]


@pytest.mark.gpu
@pytest.mark.parametrize("C,bn", [(1, None), (32, None), (64, 64),
                                  (96, None), (200, 64), (130, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_cuda_flash_decode_geometries_bit_equal(cuda, C, bn, dtype, scheme):
    """The split-cache kernel at every geometry the CPU tests hold the
    plain version to the reference at: per-row positions (last slot, an
    empty tail, a wrapped ring, none at all), windows, a scalar pos."""
    from repro_torch.kernels.spec import KernelSpec
    spec = None if bn is None else KernelSpec(bn=bn)
    qf, kc, vc, sp = _flash_rows(C + (bn or 0), 4, C)
    sp[1, C // 2:] = np.iinfo(np.int32).max
    sp[2] = (sp[2] - 3) % C + 1000
    args = _on(cuda, dtype, qf, kc, vc, sp)
    posv = torch.tensor([C - 1, C - 1, 1000 + C - 4, -1], dtype=torch.int32,
                        device=cuda)
    for p, window in ((posv, 0), (posv, max(1, C // 3)), (C // 2, 5)):
        got = flash_decode_attn(*args, p, window, scheme, spec=spec)
        ref = flash_decode_plain(*args, p, window, scheme, spec=spec)
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
        if p is posv and not window:
            assert not got[3].any()  # row 3 sees no slot


def _lockstep(cuda, dtype, C=512, live=136):
    qf, kc, vc, _ = _flash_rows(C, 4, C, KV=8)
    base = np.arange(C, dtype=np.int32)
    sp = np.broadcast_to(np.where(base < live, base, 2**31 - 1),
                         (4, C)).copy()
    return _on(cuda, dtype, qf, kc, vc, sp), live - 1


def _paged(cuda, dtype):
    rng = np.random.default_rng(29)
    B, NP, PS, P, KV, G, hd = 4, 65, 16, 16, 8, 4, 80
    pool_k = T(randn(rng, NP, PS, KV, hd)).to(cuda, dtype)
    pool_v = T(randn(rng, NP, PS, KV, hd)).to(cuda, dtype)
    table = np.zeros((B, P), np.int64)
    table[:3] = rng.permutation(np.arange(1, NP))[:3 * P].reshape(3, P)
    pt = T(table).to(cuda)
    kv_len = torch.tensor([131, 98, 201, 0], dtype=torch.int32, device=cuda)
    j = torch.arange(P * PS, dtype=torch.int32, device=cuda)
    sp = torch.where(j[None] < kv_len[:, None], j[None], 2**31 - 1)
    qf = T(randn(rng, B, KV, G, hd, scale=hd ** -0.5)).to(cuda)
    return ([qf, pool_k[pt].reshape(B, P * PS, KV, hd),
             pool_v[pt].reshape(B, P * PS, KV, hd), sp],
            torch.clamp(kv_len - 1, min=0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["lockstep", "paged", "window4096"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_cuda_flash_decode_main_path_shapes(cuda, shape, dtype, scheme):
    """K4 at the serve paths' shapes with the spec's own geometry: the
    lockstep step (4 x 8 rows, 512 slots, 136 live), the continuous tick
    (256-slot paged views, kv_len 131/98/201/0) and the full 4096-slot
    window, all live; rows x segments fill the 132 SMs."""
    from repro_torch.kernels.spec import resolve_spec
    if shape == "paged":
        args, pos = _paged(cuda, dtype)
    else:
        C = 512 if shape == "lockstep" else 4096
        args, pos = _lockstep(cuda, dtype, C, 136 if C == 512 else C)
    rows, C = args[0].shape[0] * args[0].shape[1], args[1].shape[1]
    ks = resolve_spec("flash_attn", (rows, C))
    assert rows * -(-C // ks.bn) >= 132
    got = flash_decode_attn(*args, pos, 4096, scheme)
    ref = flash_decode_plain(*args, pos, 4096, scheme)
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [32, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_decode_skip_equals_fold(cuda, bn, dtype):
    """On the card, the kernel (which skips chunks with no live slot)
    gives the bits of the order that folds every chunk: a lone live slot
    opening a chunk and one closing a chunk, a ring with holes, a fully
    masked row."""
    from _torch_helpers import fold_every_chunk
    from repro_torch.kernels.spec import KernelSpec
    qf, kc, vc, sp = _flash_rows(bn, 4, 160)
    empty = np.iinfo(np.int32).max
    sp[0], sp[1] = empty, empty
    sp[0, 64], sp[1, 95] = 500, 500
    sp[2] = (np.arange(160) - 7) % 160 + 300
    sp[2, ::3] = empty
    args = _on(cuda, dtype, qf, kc, vc, sp)
    posv = torch.tensor([500, 500, 459, -1], dtype=torch.int32, device=cuda)
    for window in (0, 40):
        got = flash_decode_attn(*args, posv, window, "rapid9",
                                spec=KernelSpec(bn=bn))
        ref = fold_every_chunk(*args, posv, window, "rapid9", 32, bn)
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    assert not got[3].any()


@pytest.mark.gpu
def test_cuda_flash_decode_same_bits_run_to_run(cuda):
    """The combine reads the segments' partials in index order, whichever
    block finishes last: 20 launches give one result, one launch each."""
    for C, live in ((512, 136), (4096, 4096)):
        args, pos = _lockstep(cuda, torch.bfloat16, C, live)
        before = flash_decode_attn.launches
        first = flash_decode_attn(*args, pos, 4096, "rapid9")
        for _ in range(19):
            again = flash_decode_attn(*args, pos, 4096, "rapid9")
            assert_same_bits(again.cpu().numpy(), first.cpu().numpy())
        assert flash_decode_attn.launches - before == 20


@pytest.mark.gpu
def test_cuda_flash_decode_refuses_an_uncompiled_geometry(cuda):
    """The entry point refuses a chunk or segment it did not compile,
    and the wrapper a head_dim the 16 B staging cannot take."""
    from repro_torch.kernels.flash_attn import ops
    args, pos = _lockstep(cuda, torch.bfloat16, 128, 100)
    posv = torch.full((4,), pos, dtype=torch.int32, device=cuda)
    for bk, bn in ((16, 64), (32, 48), (32, 16), (32, 33 * 32), (64, 64)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._launch(*args, posv, None, 0, 1e-30, bk, bn)
    q, k, v, sp = args
    with pytest.raises(ValueError, match="16 B"):
        flash_decode_attn(q[..., :12].contiguous(), k[..., :12].contiguous(),
                          v[..., :12].contiguous(), sp, pos)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["relu", "gelu_erf", "tanh"])
def test_cuda_log_matmul_refuses_unported_activation(cuda, act):
    x = torch.ones(2, 3, device=cuda)
    w = torch.ones(3, 4, device=cuda)
    with pytest.raises(NotImplementedError, match=act):
        log_matmul(x, w, "rapid10", activation=act)


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
    from repro_torch.kernels import (launch_counts, launch_counts_by_depth,
                                     reset_launch_counts)
    reset_launch_counts()
    a = torch.ones(4, 80, device=cuda)
    fused_elementwise_div(a, torch.full((4, 1), 3.0, device=cuda), "rapid9")
    fused_elementwise_div(a, torch.full((80,), 3.0, device=cuda), "rapid9")
    counts = launch_counts()
    assert counts["div_rowbcast"] == 1 and counts["div"] == 1
    assert launch_counts_by_depth()["div"] == {1: 1}


def _sentinel_result(cuda, total, lag):
    """The address at which the next ``total + lag``-element allocation
    lands, its memory filled with a sentinel first, so a test sees every
    element the kernel leaves unwritten."""
    fill = torch.full((total + lag,), float("nan"), device=cuda)
    fill.view(torch.int32).fill_(0x7FA5A5A5)
    at = fill.data_ptr()
    del fill  # the result's allocation takes this block back
    return at + 4 * lag


_K6_TOTALS = [1, 3, 4, 5, 4097, (1 << 20) + 3]
_OFFSET_PAIRS = [(a, b) for a in range(4) for b in range(4)]


@pytest.mark.gpu
@pytest.mark.parametrize("total", _K6_TOTALS)
@pytest.mark.parametrize("offsets", _OFFSET_PAIRS)
def test_cuda_div_elementwise_ragged_and_offset(cuda, total, offsets):
    """K6 from every offset pair mod 16 B (``a[k:]`` of a contiguous
    buffer) at ragged totals: a shared offset takes a head of single
    elements before the 16 B body (the result starts where a does),
    different offsets one element a thread for the whole call; special
    operands lead both operands; bit-equal to the plain version, every
    element written."""
    rng = np.random.default_rng(total + 7 * offsets[0] + offsets[1])
    a = T(special_sample(rng, max(total + 3, 18))).to(cuda)
    b = T(special_sample(rng, max(total + 3, 18))[::-1].copy()).to(cuda)
    a = a[offsets[0]:offsets[0] + total]
    b = b[offsets[1]:offsets[1] + total]
    b[:18] = T(special_sample(rng, 18))[:min(18, total)].to(cuda)
    ref = div_plain(a, b, "rapid9")
    lag = offsets[0] if offsets[0] == offsets[1] else 0
    at = _sentinel_result(cuda, total, lag)
    got = div_elementwise(a, b, "rapid9")
    assert got.data_ptr() == at
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())


def _k5_cases():
    for n in (1, 3, 80, 130, 40_000):
        for rows in sorted({1, 3, -(-((1 << 20) + 3) // n)}):
            yield rows, n


@pytest.mark.gpu
@pytest.mark.parametrize("rows,n", list(_k5_cases()))
@pytest.mark.parametrize("offsets", _OFFSET_PAIRS)
def test_cuda_div_rowbcast_depth_one_ragged_and_offset(cuda, rows, n,
                                                       offsets):
    """K5 (depth 1) from every offset pair of a and b mod 16 B, at n = 1,
    3, 80, 130 and 40 000 and totals up to 2^20 + 3: the result starts
    where a does, so a head of at most 3 single elements precedes the
    16 B body (the row found once a vector where n % 4 == 0 and the head
    is 0, else once an element); special operands lead a and b;
    bit-equal to the plain version, every element written, one launch a
    call at depth 1."""
    from repro_torch.kernels import launch_counts_by_depth, reset_launch_counts
    rng = np.random.default_rng(rows * n + 7 * offsets[0] + offsets[1])
    total = rows * n
    a = T(special_sample(rng, max(total + 3, 18))).to(cuda)
    a = a[offsets[0]:offsets[0] + total].view(rows, n)
    b = T(special_sample(rng, max(rows + 3, 18))[::-1].copy()).to(cuda)
    b = b[offsets[1]:offsets[1] + rows]
    b[:18] = T(special_sample(rng, 18))[:min(18, rows)].to(cuda)
    ref = div_rowbcast_plain(a, b, "rapid9")
    at = _sentinel_result(cuda, total, offsets[0])
    reset_launch_counts()
    got = div_rowbcast(a, b, "rapid9", spec=_depth(1))
    assert got.data_ptr() == at
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    assert launch_counts_by_depth()["div_rowbcast"] == {1: 1}


@pytest.mark.gpu
def test_cuda_div_stream_refuses_what_it_did_not_compile(cuda):
    """K6 and K5 (depth 1) refuse a block or thread count they did not
    compile, a grid past one wave or empty, a head that leaves the body
    misaligned, 2^31 elements or more, and (K5) a magic pair that does
    not divide by n."""
    import ctypes

    from repro_torch.core import float_approx as fa
    from repro_torch.kernels import _build, budget
    from repro_torch.kernels._launch import ptr, sm_count, stream
    from repro_torch.kernels.fused_div.ops import row_magic
    a = torch.ones(64 * 80, device=cuda)
    b = torch.ones(64 * 80, device=cuda)
    out = torch.empty(64 * 80, device=cuda)
    lut = fa.div_lut_device("rapid9", cuda)
    k6 = _build.function("fused_div", "rapid_div",
                         [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    k5 = _build.function("fused_div", "rapid_div_rowbcast_stream",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                         + [ctypes.c_longlong] + [ctypes.c_uint] * 2
                         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    blocks, threads = budget.INT_BLOCKS_PER_SM, budget.INT_THREADS
    wave = sm_count(cuda.index or 0) * blocks

    def call6(total=64 * 80, head=0, blocks_per_sm=blocks, threads=threads,
              grid=1, x=a):
        return k6(ptr(x), ptr(b), ptr(out), ptr(lut), total, head,
                  blocks_per_sm, threads, grid, stream(cuda))

    def call5(rows=64, n=80, head=0, magic=None, blocks_per_sm=blocks,
              threads=threads, grid=1, x=a):
        m, s = row_magic(n) if magic is None else magic
        return k5(ptr(x), ptr(b), ptr(out), ptr(lut), rows, n, head, m, s,
                  blocks_per_sm, threads, grid, stream(cuda))

    for call in (call6, call5):
        assert call() == 0
        assert call(grid=wave) == 0
        torch.cuda.synchronize()
        for bad in (dict(blocks_per_sm=blocks + 1), dict(threads=128),
                    dict(grid=0), dict(grid=wave + 1), dict(head=1),
                    dict(head=4), dict(x=a[1:])):
            assert call(**bad) != 0, (call.__name__, bad)
    assert call6(total=1 << 31) != 0
    assert call5(rows=1 << 16, n=1 << 15) != 0  # 2^31 elements
    assert call5(magic=row_magic(81)) != 0
    assert call5(magic=(row_magic(80)[0], 32)) != 0
    assert call6(x=a[1:], total=63, head=63) == 0  # single elements only
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# K9 / K10: the integer RAPID units, bit-equal to their plain versions
# --------------------------------------------------------------------------

def _int_operands(rng, n, a_bits, b_bits):
    return (T(v.astype(np.int64)) for v in int_pairs(rng, n, a_bits, b_bits))


def _assert_same_uint32(got, ref):
    """uint32 results equal bit for bit (compared as int32 views: torch
    has few uint32 ops)."""
    assert got.dtype == ref.dtype == torch.uint32
    assert got.shape == ref.shape
    assert torch.equal(got.view(torch.int32).cpu(), ref.view(torch.int32).cpu())


def _unit(kind):
    from repro_torch.kernels.rapid_div.ops import rapid_div, rapid_div_plain
    from repro_torch.kernels.rapid_mul.ops import rapid_mul, rapid_mul_plain
    return (rapid_mul, rapid_mul_plain) if kind == "mul" else (
        rapid_div, rapid_div_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [8, 12, 16])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid3", "rapid5", "rapid10"])
def test_cuda_rapid_mul_matches_plain(cuda, n_bits, scheme):
    rapid_mul, rapid_mul_plain = _unit("mul")
    if n_bits == 8:  # exhaustive, the Table III method
        g = np.arange(256, dtype=np.int64)
        a, b = (T(v.ravel().copy()) for v in np.meshgrid(g, g))
    else:
        a, b = _int_operands(np.random.default_rng(n_bits), 1 << 20,
                             n_bits, n_bits)
    got = rapid_mul(a.to(cuda).to(torch.int32), b.to(cuda), scheme, n_bits)
    _assert_same_uint32(got, rapid_mul_plain(a.to(cuda), b.to(cuda), scheme,
                                             n_bits))
    _assert_same_uint32(got, rapid_mul_plain(a, b, scheme, n_bits))


@pytest.mark.gpu
@pytest.mark.parametrize("n_bits", [4, 8, 15])
@pytest.mark.parametrize("scheme", ["mitchell", "rapid3", "rapid5", "rapid9"])
def test_cuda_rapid_div_matches_plain(cuda, n_bits, scheme):
    rapid_div, rapid_div_plain = _unit("div")
    a, b = _int_operands(np.random.default_rng(n_bits), 1 << 20,
                         2 * n_bits, n_bits)
    if n_bits == 8:  # every divisor against a sweep of dividends
        g = np.arange(1 << 16, dtype=np.int64)
        a = torch.cat([a, T(np.tile(g, 4))])
        b = torch.cat([b, T(np.repeat(np.arange(256, dtype=np.int64), 1024))])
    got = rapid_div(a.to(cuda), b.to(cuda).to(torch.int16), scheme, n_bits)
    _assert_same_uint32(got, rapid_div_plain(a.to(cuda), b.to(cuda), scheme,
                                             n_bits))
    _assert_same_uint32(got, rapid_div_plain(a, b, scheme, n_bits))


@pytest.mark.gpu
@pytest.mark.parametrize("kind,n_bits", [("mul", n) for n in range(1, 17)]
                         + [("div", n) for n in range(1, 16)])
def test_cuda_rapid_int_every_width(cuda, kind, n_bits):
    """Every width each unit takes, every registered scheme, random pairs
    headed by the special operands (0 on either side and both, 1, the
    largest values, a < b, K10's b = 0), and the largest 64 x 64
    operands; bit-equal to the plain version on the card."""
    from repro_torch.core import schemes
    fn, plain = _unit(kind)
    a_bits = n_bits if kind == "mul" else 2 * n_bits
    a, b = (v.to(cuda) for v in _int_operands(
        np.random.default_rng(n_bits), 40_000, a_bits, n_bits))
    top = torch.arange(max(0, (1 << n_bits) - 64), 1 << n_bits, device=cuda)
    a = torch.cat([a, top.repeat_interleave(top.numel()) << (a_bits - n_bits)])
    b = torch.cat([b, top.repeat(top.numel())])
    for scheme in (schemes.MUL_SCHEMES if kind == "mul"
                   else schemes.DIV_SCHEMES):
        _assert_same_uint32(fn(a, b, scheme, n_bits),
                            plain(a, b, scheme, n_bits))


@pytest.mark.gpu
def test_cuda_rapid_mul_saturates_as_plain(cuda):
    """K9 at 16 bits saturates at 0xFFFFFFFF where the approximate product
    of near-maximal operands passes 2^32, as the plain version does."""
    rapid_mul, rapid_mul_plain = _unit("mul")
    top = torch.arange(65536 - 256, 65536, device=cuda)
    a, b = top.repeat_interleave(256), top.repeat(256)
    for scheme in ("mitchell", "rapid3", "rapid5", "rapid10"):
        got = rapid_mul(a, b, scheme, 16)
        _assert_same_uint32(got, rapid_mul_plain(a, b, scheme, 16))
        if scheme != "mitchell":
            assert int((got.view(torch.int32) == -1).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mul", "div"])
@pytest.mark.parametrize("total", [1, 3, 4, 5, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (2, 2), (3, 3), (1, 0),
                                     (2, 3)])
def test_cuda_rapid_int_ragged_and_offset(cuda, kind, total, offsets):
    """Ragged totals and operands that start 0-3 elements past a 16 B
    boundary (``a[k:]`` of a contiguous buffer): a shared offset takes a
    head of single elements before the 16 B vector body, different
    offsets the single-element path for the whole call; bit-equal to the
    plain version, every element written (the result's memory is filled
    with a sentinel first)."""
    fn, plain = _unit(kind)
    n_bits = 16 if kind == "mul" else 8
    a_bits = n_bits if kind == "mul" else 2 * n_bits
    a, b = (v.to(cuda).to(torch.int32) for v in _int_operands(
        np.random.default_rng(total), total + 3, a_bits, n_bits))
    a, b = a[offsets[0]:offsets[0] + total], b[offsets[1]:offsets[1] + total]
    # the result starts where a does mod 16 B when a and b share an offset
    lag = offsets[0] if offsets[0] == offsets[1] else 0
    ref = plain(a, b, None, n_bits)
    for sentinel in (0x5A5A5A5A, 0x7FFFFFFF):
        fill = torch.full((total + lag,), sentinel, dtype=torch.int32,
                          device=cuda)
        at = fill.data_ptr()
        del fill  # the result's allocation takes this block back
        got = fn(a, b, None, n_bits)
        assert got.data_ptr() == at + 4 * lag
        _assert_same_uint32(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mul", "div"])
def test_cuda_rapid_int_wide_indices(cuda, kind):
    """The 64-bit index form (taken from 2^31 pairs) on a small call,
    with a head of single elements, through the C entry point."""
    from repro_torch.core import mitchell, schemes
    from repro_torch.kernels import _build, _rapid_int
    from repro_torch.kernels._launch import ptr, stream
    from repro_torch.kernels.spec import int_geometry, int_split
    _, plain = _unit(kind)
    n_bits = 16 if kind == "mul" else 8
    a_bits = n_bits if kind == "mul" else 2 * n_bits
    a, b = (v.to(cuda).to(torch.int32)[1:] for v in _int_operands(
        np.random.default_rng(5), 100_003, a_bits, n_bits))
    scheme, frac = ((schemes.MUL_SCHEMES["rapid10"], n_bits - 1)
                    if kind == "mul"
                    else (schemes.DIV_SCHEMES["rapid9"], 2 * n_bits - 1))
    out = torch.empty(a.numel() + 1, dtype=torch.uint32, device=cuda)[1:]
    head, _, _ = int_split(a.numel(), a.data_ptr(), b.data_ptr(),
                           out.data_ptr())
    assert 0 < head < 4
    geom = int_geometry(a.numel(), _rapid_int.sm_count(cuda.index or 0),
                        head)
    assert not geom.wide
    fn = _build.function("rapid_int", f"rapid_{kind}_int",
                         _rapid_int.ARGTYPES)
    err = fn(ptr(a), ptr(b), ptr(mitchell.lut_device(scheme, frac, cuda)),
             ptr(out), a.numel(), head, n_bits, geom.blocks_per_sm,
             geom.threads, geom.grid, 1, stream(cuda))
    assert err == 0
    _assert_same_uint32(out, plain(a, b, None, n_bits))


@pytest.mark.gpu
def test_cuda_rapid_int_refuses_what_it_did_not_compile(cuda):
    """The kernel refuses a block or thread count it did not compile, a
    grid past one wave or empty, a head that leaves its body misaligned,
    and 32-bit indices from 2^31 pairs."""
    from repro_torch.core import mitchell, schemes
    from repro_torch.kernels import _build, _rapid_int, budget
    from repro_torch.kernels._launch import ptr, stream
    a = torch.ones(64, dtype=torch.int32, device=cuda)
    out = torch.empty(64, dtype=torch.uint32, device=cuda)
    lut = mitchell.lut_device(schemes.MUL_SCHEMES["rapid10"], 15, cuda)
    fn = _build.function("rapid_int", "rapid_mul_int", _rapid_int.ARGTYPES)
    blocks = budget.INT_BLOCKS_PER_SM
    wave = _rapid_int.sm_count(cuda.index or 0) * blocks

    def call(total=64, head=0, blocks_per_sm=blocks,
             threads=budget.INT_THREADS, grid=1, wide=0, x=a):
        return fn(ptr(x), ptr(a), ptr(lut), ptr(out), total, head, 16,
                  blocks_per_sm, threads, grid, wide, stream(cuda))

    assert call() == 0
    torch.cuda.synchronize()
    assert call(grid=wave) == 0
    for bad in (dict(blocks_per_sm=3), dict(threads=128), dict(grid=0),
                dict(grid=wave + 1), dict(head=1), dict(x=a[1:], total=63),
                dict(total=1 << 31)):
        assert call(**bad) != 0, bad
    assert call(x=a[1:], total=63, head=63) == 0  # single elements only
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_rapid_int_broadcast_empty_and_counts(cuda):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rapid_mul, rapid_mul_plain = _unit("mul")
    rapid_div, rapid_div_plain = _unit("div")
    reset_launch_counts()
    a = torch.arange(60, device=cuda).reshape(3, 20)
    b = torch.arange(20, device=cuda)
    _assert_same_uint32(rapid_mul(a, b), rapid_mul_plain(a, b))
    _assert_same_uint32(rapid_div(a, b[:1] + 3), rapid_div_plain(a, b[:1] + 3))
    empty = rapid_mul(a[:0], b)
    assert empty.shape == (0, 20) and empty.dtype == torch.uint32
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
    # the paths' shapes: a decode step's norms, a continuous prefill
    # tick's, prefill attention, the online-softmax combine of a 64-token
    # chunk and of the long prefill, and the ragged softmax edge
    (4, 2560, None), (64, 2560, None), (16384, 128, None), (2048, 80, None),
    (266240, 80, None), (33, 130, None),
    # starcoder2_7b's: the LN divides of a decode step, a continuous
    # prefill tick and the lockstep prefill, and a 64-token chunk's
    # combine (36 heads of 128)
    (4, 4608, None), (64, 4608, None), (512, 4608, None), (2304, 128, None),
    # where a warp a row meets four warps a row (past one wave of rows),
    # and a narrow row under four warps (few rows)
    (2000, 256, None), (2000, 512, None), (40, 256, None),
    # more than 8 slabs a block at every op: one-row slabs past eight waves
    (12000, 20, 1), (9000, 512, 1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["rapid9", None])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("rows,n,bm", _ROW_CASES)
def test_cuda_row_dividers_depths_bit_exact(cuda, depth, rows, n, bm,
                                            scheme):
    """K2 / K3 / K5 at every depth against their plain versions on the
    card, denominators included, with the LUT divide and (rms, softmax:
    K1's norm tail passes None on an exact divide) the IEEE one; special
    operands head every row set, the last of several softmax rows is all
    -0 and softmax runs at the default floor and at 0.0 (where the -0
    row's denominator is +0); at depth >= 2 each op also runs from a
    start 4 B past a 16 B boundary (4 B copies, no 16 B stores), and so
    does the row broadcast at depth 1 (K5: a head of single elements).
    The row broadcast is RAPID only."""
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    spec = KernelSpec(bm=bm, pipeline=PipelineSpec(depth=depth))
    rng = np.random.default_rng(rows + n + depth)
    x = T(randn(rng, rows, n, scale=2.0)).to(cuda)
    x.view(-1)[:18] = T(special_sample(rng, 18)).to(cuda)
    got, den = fused_rms_div(x, 1e-6, scheme, return_denom=True, spec=spec)
    ref, rden = rms_div_plain(x, 1e-6, scheme, return_denom=True)
    assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
    e = torch.exp(x.clamp(-30, 30))
    e.view(-1)[:18] = x.view(-1)[:18]
    if rows > 1:
        e[-1] = -0.0
    srefs = {}
    for floor in (1e-20, 0.0):
        got, den = fused_softmax_div(e, scheme, floor=floor,
                                     return_denom=True, spec=spec)
        sref, sden = softmax_div_plain(e, scheme, floor=floor,
                                       return_denom=True)
        assert_same_bits(den.cpu().numpy(), sden.cpu().numpy())
        assert_same_bits(got.cpu().numpy(), sref.cpu().numpy())
        srefs[floor] = sref
    if rows > 1 and n % 128 == 0:  # the -0 row at floor 0: -0 / +0
        assert bits(sden[-1].cpu().numpy())[0] == 0
    if scheme is not None:
        b = T(special_sample(rng, max(rows, 18))[:rows]).to(cuda)
        got = div_rowbcast(x, b, scheme, spec=spec)
        bref = div_rowbcast_plain(x, b, scheme)
        assert_same_bits(got.cpu().numpy(), bref.cpu().numpy())
        # and from a start 4 B past a 16 B boundary
        got = div_rowbcast(_misaligned(x), b, scheme, spec=spec)
        assert_same_bits(got.cpu().numpy(), bref.cpu().numpy())
    if depth > 1:  # and from a start 4 B past a 16 B boundary
        got = fused_rms_div(_misaligned(x), 1e-6, scheme, spec=spec)
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
        for floor, sref in srefs.items():
            got = fused_softmax_div(_misaligned(e), scheme, floor=floor,
                                    spec=spec)
            assert_same_bits(got.cpu().numpy(), sref.cpu().numpy())


@pytest.mark.gpu
def test_cuda_row_slabs_refuse_an_uncompiled_geometry(cuda):
    """K8 launches the grid ``row_geometry`` plans and refuses, before a
    launch, a warp count it did not compile for the op (rms / softmax 1
    or 4 a row, the row broadcast's flat walk 0), an empty slab, an
    empty grid, a grid past the slabs, and a grid past one wave the card
    holds at once (33 blocks an SM are past any instance's occupancy);
    a stage count outside 1-8 is refused before that, by the spec."""
    from repro_torch.kernels.fused_div import ops
    from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,
                                          RowGeometry, row_geometry)
    x = torch.ones(64, 2560, device=cuda)
    b = torch.ones(64, device=cuda)
    good = row_geometry("fused_rms", 64, 2560, 2)
    at = KernelSpec(bm=good.bm, pipeline=PipelineSpec(depth=2))
    # the good geometry launches, through the same private launchers
    ops._launch_rows(x, "rapid9", "rms_div", at, good, 0.0, 1.0)
    ops._launch_rowbcast(x, b, "rapid9", at,
                         row_geometry("fused_div_rowbcast", 64, 2560, 2))
    for warps, grid, bm in ((2, 1, 1), (0, 1, 1), (8, 1, 1), (4, 0, 1),
                            (4, 65, 1), (1, 33, 2), (4, 1, 0)):
        geom = RowGeometry(bm, warps, 1, grid, 0)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._launch_rows(x, "rapid9", "rms_div", at, geom, 0.0, 1.0)
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._launch_rows(x, "rapid9", "softmax_div", at, geom, 1e-20)
    for warps, grid in ((1, 1), (4, 1), (0, 0), (0, 65)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._launch_rowbcast(x, b, "rapid9", at,
                                 RowGeometry(1, warps, 1, grid, 0))
    many = torch.ones(132 * 33 + 1, 128, device=cuda)
    for warps in (1, 4):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops._launch_rows(many, "rapid9", "softmax_div", at,
                             RowGeometry(1, warps, 1, 132 * 33, 0), 1e-20)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops._launch_rowbcast(many, many[:, 0].contiguous(), "rapid9", at,
                             RowGeometry(1, 0, 1, 132 * 33, 0))
    with pytest.raises(ValueError, match="outside"):  # before any launch
        PipelineSpec(depth=9)


# K2 / K3 at depth 1 (each row read once onto the chip), at
# row_geometry's plan
_HOLD_CASES = [
    (1, 2560),      # one row, four warps
    (3, 31),        # n < 32: most threads hold only the padding
    (33, 130),      # n % 4 != 0, a ragged second round
    (512, 2560),    # the train path's norms: a block a row
    (9, 4100),      # four warps, one round past the 32 held: streamed
    (4, 40_000),    # the deferred depth's fallback: streamed
    (1000, 601),    # four warps past one wave: blocks walk, ragged pass
    (16384, 128),   # prefill attention: a warp a row, four rows a warp
    (20000, 30),    # a warp a row past one wave, n < 32, ragged pass
    (9001, 200),    # a warp holding two rows of two rounds; blocks walk
    (700, 300),     # a warp holding one row of four rounds (one padding)
]


@pytest.mark.gpu
@pytest.mark.parametrize("scheme", ["rapid9", None])
@pytest.mark.parametrize("rows,n", _HOLD_CASES)
def test_cuda_row_dividers_depth_one_bit_exact(cuda, rows, n, scheme):
    """K2 / K3 at depth 1 against their plain versions on the card,
    denominators included, on the LUT and the IEEE divide: special
    operands scattered over the first and the last row, a softmax row of
    -0 (softmax at the default floor and at 0.0, where that row's
    denominator is +0), from an aligned start and from one 4 B past a
    16 B boundary; both warp forms and the streamed one
    (``row_geometry``); one launch a call, filed under depth 1."""
    from repro_torch.kernels import launch_counts_by_depth, reset_launch_counts
    from repro_torch.kernels.spec import row_geometry
    rng = np.random.default_rng(7 * rows + n)
    x = randn(rng, rows, n, scale=2.0)
    for r in {0, rows - 1}:
        mask = rng.random(n) < 0.05
        mask[0] = True
        x[r, mask] = special_sample(rng, max(int(mask.sum()), 18))[
            :int(mask.sum())]
    xt = T(x).to(cuda)
    e = torch.exp(xt.clamp(-30, 30))
    e[0] = xt[0]
    if rows > 2:
        e[1] = -0.0
    spec = _depth(1)
    ref, rden = rms_div_plain(xt, 1e-6, scheme, return_denom=True)
    sref = {floor: softmax_div_plain(e, scheme, floor=floor,
                                     return_denom=True)
            for floor in (1e-20, 0.0)}
    if rows > 2 and n % 128 == 0:  # the -0 row at floor 0: -0 / +0
        assert bits(sref[0.0][1][1].cpu().numpy())[0] == 0
    reset_launch_counts()
    for t, u in ((xt, e), (_misaligned(xt), _misaligned(e))):
        got, den = fused_rms_div(t, 1e-6, scheme, return_denom=True,
                                 spec=spec)
        assert_same_bits(den.cpu().numpy(), rden.cpu().numpy())
        assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
        for floor, (sq, sden) in sref.items():
            got, den = fused_softmax_div(u, scheme, floor=floor,
                                         return_denom=True, spec=spec)
            assert_same_bits(den.cpu().numpy(), sden.cpu().numpy())
            assert_same_bits(got.cpu().numpy(), sq.cpu().numpy())
    counts = launch_counts_by_depth()
    assert counts["rms_div"] == {1: 2} and counts["softmax_div"] == {1: 4}
    assert row_geometry("fused_rms", rows, n, 1).streams == (n > 4096)


@pytest.mark.gpu
def test_cuda_row_dividers_depth_one_refuse_an_uncompiled_geometry(cuda):
    """At depth 1 K2 / K3 launch the grid ``row_geometry`` plans and
    refuse, before a launch, a warp count they did not compile (1 or 4
    a row), one warp on a row wider than it holds (512), an empty slab,
    an empty grid, a grid past the slabs, and one past the wave the
    card holds at once (33 blocks an SM)."""
    from repro_torch.kernels.fused_div import ops
    from repro_torch.kernels.spec import (KernelSpec, PipelineSpec,
                                          RowGeometry, row_geometry)
    at = KernelSpec(pipeline=PipelineSpec(depth=1))
    x = torch.ones(64, 2560, device=cuda)
    many = torch.ones(132 * 33 + 1, 128, device=cuda)
    for name, family, consts in (("rms_div", "fused_rms", (0.0, 1.0)),
                                 ("softmax_div", "fused_softmax", (1e-20,))):
        ops._launch_rows(x, "rapid9", name, at,
                         row_geometry(family, 64, 2560, 1), *consts)
        for warps, grid, bm in ((2, 1, 1), (0, 1, 1), (8, 1, 1), (1, 1, 1),
                                (4, 0, 1), (4, 65, 1), (1, 65, 1),
                                (1, 17, 4), (4, 1, 0)):
            with pytest.raises(RuntimeError, match="launch failed"):
                ops._launch_rows(x, "rapid9", name, at,
                                 RowGeometry(bm, warps, 1, grid, 0), *consts)
        for warps in (1, 4):
            with pytest.raises(RuntimeError, match="launch failed"):
                ops._launch_rows(many, "rapid9", name, at,
                                 RowGeometry(1, warps, 1, 132 * 33, 0),
                                 *consts)


@pytest.mark.gpu
def test_cuda_row_smem_is_the_kernels(cuda):
    """``row_smem`` counts what each row-divider instance allocates: its
    static shared memory as compiled plus the dynamic bytes it launches
    with (K8 at depths 2-8; at depth 1 K2 / K3's static fold buffers and
    LUT, and K5's LUT)."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.spec import row_geometry, row_smem
    fn = _build.function("fused_div", "rapid_row_slab_smem",
                         [ctypes.c_int] * 5
                         + [ctypes.POINTER(ctypes.c_longlong)])
    got = ctypes.c_longlong()
    for op, family in enumerate(("fused_rms", "fused_softmax",
                                 "fused_div_rowbcast")):
        for depth in range(1, 9):
            for rows, n in ((4, 2560), (16384, 128), (2048, 80), (33, 130),
                            (9001, 200), (4, 40_000)):
                if depth > 1 and n == 40_000:  # two slabs do not fit
                    continue
                g = row_geometry(family, rows, n, depth)
                assert fn(op, depth, g.warps, g.bm, n,
                          ctypes.byref(got)) == 0
                assert got.value == row_smem(g.bm, n, depth, g.warps) \
                    == g.smem
    assert fn(2, 2, 4, 1, 80, ctypes.byref(got)) != 0  # not compiled


@pytest.mark.gpu
def test_cuda_row_dividers_launch_once_a_call(cuda):
    """One launch a call at the paths' shapes, counted by depth: K2 / K3
    at depth 1, K8 at depths 2 and 3."""
    from repro_torch.kernels import (launch_counts_by_depth,
                                     reset_launch_counts)
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    reset_launch_counts()
    for depth in (1, 2, 3):
        spec = KernelSpec(pipeline=PipelineSpec(depth=depth))
        for rows in (1, 4, 64, 512):
            fused_rms_div(torch.ones(rows, 2560, device=cuda), 1e-6,
                          "rapid9", spec=spec)
        fused_softmax_div(torch.ones(16384, 128, device=cuda), "rapid9",
                          spec=spec)
        div_rowbcast(torch.ones(2048, 80, device=cuda),
                     torch.ones(2048, device=cuda), "rapid9", spec=spec)
    counts = launch_counts_by_depth()
    assert counts["rms_div"] == {1: 4, 2: 4, 3: 4}
    assert counts["softmax_div"] == {1: 1, 2: 1, 3: 1}
    assert counts["div_rowbcast"] == {1: 1, 2: 1, 3: 1}


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


# --------------------------------------------------------------------------
# K1's gelu epilogue (starcoder2_7b's w1)
# --------------------------------------------------------------------------

# the stated bound of K1's tanh gelu against the plain version on the card
GELU_ULP = 2


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 4608, 640),   # decode regime
                                   (4, 64, 8),       # block8
                                   (33, 300, 130),   # chunk
                                   (100, 129, 200),  # prefill
                                   (8, 1, 4096)])    # z over [-8, 8]
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_log_matmul_gelu_within_bound(cuda, m, k, n, depth, with_bias):
    """K1 with ``activation="gelu"`` (tanh form) at every regime and
    depths 1-3 against its plain version on the card (torch's CUDA
    ``F.gelu(approximate="tanh")`` on the same RAPID sums): within
    GELU_ULP; the K = 1 case sweeps z over [-8, 8], where 1 + tanh
    cancels."""
    from repro_torch.kernels.spec import KernelSpec, PipelineSpec
    rng = np.random.default_rng(m * k + n + depth)
    if k == 1:
        x = T(np.linspace(-1.0, 1.0, m, dtype=np.float32)[:, None])
        w = T(np.linspace(-8.0, 8.0, n, dtype=np.float32)[None])
    else:
        x, w = T(randn(rng, m, k)), T(randn(rng, k, n, scale=0.05))
    x, w = x.to(cuda), w.to(cuda)
    bias = T(randn(rng, n)).to(cuda) if with_bias else None
    spec = KernelSpec(pipeline=PipelineSpec(depth=depth))
    got = log_matmul(x, w, "rapid10", bias=bias, activation="gelu",
                     spec=spec)
    ref = log_matmul_plain(x, w, "rapid10", bias=bias, activation="gelu")
    assert ulp_diff(got.cpu().numpy(), ref.cpu().numpy()).max() <= GELU_ULP


# --------------------------------------------------------------------------
# the engines' compiled steps (CUDA graphs)
# --------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o_danube_1_8b", "starcoder2_7b"])
def test_cuda_graph_engines_equal_eager(cuda, arch):
    """Both engines on a reduced RAPID model, graph route against eager
    route: equal greedy tokens, equal launch counts by wrapper and depth
    (each replay counts what its capture recorded), one capture a phase;
    a second lockstep ``generate`` of one shape replays without a new
    capture and gives the same tokens."""
    from repro_torch.configs.base import RAPID, get_config
    from repro_torch.kernels import (launch_counts, launch_counts_by_depth,
                                     reset_launch_counts)
    from repro_torch.models.model import Model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.scheduler import ContinuousServeEngine

    cfg = get_config(arch).reduced().with_(approx=RAPID)
    model = Model(cfg)
    params = model.init(0, cuda)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in (5, 9, 3, 12)]
    runs = {}
    for graphs in (True, False):
        reset_launch_counts()
        lock = ServeEngine(model, params, cache_n=48, cuda_graphs=graphs)
        out = [lock.generate(prompts, max_new=6) for _ in range(2)]
        lock_counts = (launch_counts(), launch_counts_by_depth())
        reset_launch_counts()
        cont = ContinuousServeEngine(model, params, n_slots=2, max_len=48,
                                     page_size=8, prefill_chunk=4,
                                     cuda_graphs=graphs)
        out.append(cont.generate(prompts, max_new=6))
        runs[graphs] = (out, lock_counts,
                        (launch_counts(), launch_counts_by_depth()),
                        lock.trace_counts, cont.trace_counts)
    (g_out, g_lock, g_cont, g_lt, g_ct) = runs[True]
    (e_out, e_lock, e_cont, e_lt, e_ct) = runs[False]
    assert g_out == e_out
    assert g_out[0] == g_out[1]
    assert g_lock == e_lock and g_cont == e_cont
    for counts, _ in (g_lock, g_cont):
        assert counts["log_matmul"] > 0 and counts["flash_decode"] > 0
    assert g_lt == e_lt == {"decode": 1, "prefill": 1}
    assert g_ct == e_ct == {"decode": 1, "prefill": 1}


@pytest.mark.gpu
def test_cuda_graph_replay_survives_ticket_growth(cuda):
    """K4 captured at 4 rows, then launched eagerly with more rows than
    any capture used (its ticket tensor is replaced) and the freed sizes
    refilled with garbage: the replay gives the bits it gave before, and
    each replay counts one K4 launch."""
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.serve.compiled import CompiledStep

    q, kc, vc, sp = _on(cuda, torch.bfloat16, *_flash_rows(41, 2, 64))
    pos = 63
    counts = {"decode": 0}
    step = CompiledStep("decode", counts, cuda)

    def attend(qf):
        return flash_decode_attn(qf, kc, vc, sp, pos, 0, "rapid9")

    before = flash_decode_attn.launches
    first = step(attend, q).clone()  # warm-up, then capture
    again = step(attend, q).clone()  # replay
    assert flash_decode_attn.launches == before + 2
    rows = fops._TICKETS[q.device].numel() + 1
    big = _on(cuda, torch.bfloat16, *_flash_rows(42, -(-rows // 2), 64))
    flash_decode_attn(*big, pos, 0, "rapid9")
    assert fops._TICKETS[q.device].numel() >= rows
    junk = [torch.full((n,), 7, dtype=torch.int32, device=cuda)
            for n in (256, 512, 1024) for _ in range(16)]
    third = step(attend, q).clone()
    torch.cuda.synchronize()
    del junk
    assert counts == {"decode": 1}
    assert flash_decode_attn.launches == before + 4
    assert_same_bits(again.cpu().numpy(), first.cpu().numpy())
    assert_same_bits(third.cpu().numpy(), first.cpu().numpy())


@pytest.mark.gpu
def test_cuda_graph_capture_survives_dead_graphs_in_cycles(cuda):
    """A dead step whose captured graph sits in a reference cycle, and a
    collection inside the next capture (as the collector may run at any
    allocation): the capture succeeds and replays right, because the
    step collects before capturing.  A graph freed inside a capture
    would release its pool there and invalidate the capture."""
    import gc

    from repro_torch.serve.compiled import CompiledStep

    x = torch.arange(1024, dtype=torch.float32, device=cuda)
    gc_on = gc.isenabled()
    gc.disable()
    try:
        dead = CompiledStep("decode", {"decode": 0}, cuda)
        dead(lambda t: t + 1, x)
        cycle = {"step": dead}
        cycle["self"] = cycle
        del dead, cycle

        def step(t):
            if torch.cuda.is_current_stream_capturing():
                gc.collect()
            return t * 3

        counts = {"decode": 0}
        live = CompiledStep("decode", counts, cuda)
        first = live(step, x).clone()
        again = live(step, x + 1).clone()
    finally:
        if gc_on:
            gc.enable()
    assert counts == {"decode": 1}
    assert torch.equal(first, x * 3) and torch.equal(again, (x + 1) * 3)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["lockstep", "paged"])
@pytest.mark.parametrize("scheme", ["rapid9", None])
def test_cuda_flash_decode_starcoder2_shapes(cuda, shape, scheme):
    """K4 at starcoder2_7b's decode shapes: head_dim 128, 4 kv heads of 9
    queries (G = 9), bf16 caches; the lockstep step (144 slots, 136
    live) and the continuous tick's 256-slot views (kv_len 131 / 98 /
    201 / 0)."""
    qf, kc, vc, sp = _flash_rows(43, 4, 144 if shape == "lockstep" else 256,
                                 KV=4, G=9, hd=128)
    if shape == "lockstep":
        sp[:, 136:] = 2**31 - 1
        pos = 135
    else:
        kv_len = np.array([131, 98, 201, 0], np.int32)
        sp = np.where(sp < kv_len[:, None], sp, 2**31 - 1).astype(np.int32)
        pos = torch.tensor(np.maximum(kv_len - 1, 0), device=cuda)
    args = _on(cuda, torch.bfloat16, qf, kc, vc, sp)
    got = flash_decode_attn(*args, pos, 0, scheme)
    ref = flash_decode_plain(*args, pos, 0, scheme)
    assert_same_bits(got.cpu().numpy(), ref.cpu().numpy())
