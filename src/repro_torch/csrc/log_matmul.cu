// K1: RAPID log-domain matmul with a fused elementwise epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/log_matmul/log_matmul.py
// (log_matmul_pallas, _kernel, _accumulate_block; the depth >= 2
// log_matmul_pipelined form is the same contract with more stages).
//
// What bounds it on an H100: the products are int32 adds, compares and a
// 256-entry LUT gather, which tensor cores cannot run.  At prefill
// (M = 512) the kernel is bound by the CUDA cores' integer issue rate; at
// decode (M = 4) by reading the f32 weight once from device memory.
//
// Design (right and simple first; no TMA, wgmma or multi-stage ring):
//  * one CTA owns a BM x BN output tile and stages BK-deep x and w tiles
//    plus the LUT in shared memory;
//  * staging decodes each operand once -- biased magnitude, LUT row or
//    column, sign, saturate / dead / non-negative flags -- so the inner
//    loop does one LUT gather, two adds and a few selects per product;
//  * each thread accumulates its TM x TN outputs one k at a time in K
//    order, so every output is the same rounding sequence as the plain
//    version (repro_torch/kernels/log_matmul/ops.py::log_matmul_plain) and
//    the JAX reference log_matmul_scan(chunk=1): bit-equal;
//  * the epilogue act(z + bias) + residual runs in the kernel.  A norm
//    stage (rms / softmax over the whole row) is not fused: the wrapper
//    runs it as a K2/K3 launch on this kernel's pre-norm output;
//  * a batch of independent products [B, M, K] @ [B, K, N] runs in one
//    launch: the batch is folded into gridDim.x (gridDim.y and .z stop at
//    65 535; a 2048^2 JPEG frame has 65 536 blocks), and each operand has
//    a batch stride, 0 for an operand broadcast over the batch, which is
//    never materialised.  The 2-D call is the batch-1 case, compiled
//    with BATCHED = false so that its offsets fold away: the serve
//    paths run the same instructions as before the batch existed.
//
// The products follow float_approx.log_mul_f32 (the reference's jnp
// oracle), including its inf / NaN-operand and overflow-wrap rules.
#include "rapid.cuh"

namespace {

using rapid::F32_BIAS;
using rapid::F32_ABS;
using rapid::F32_SIGN;
using rapid::INF_BITS;
using rapid::MIN_NORMAL;

// operand info word: bits 0-7 LUT index part, then flags, bit 31 sign
constexpr uint32_t SAT = 1u << 8;      // |operand| >= inf (inf or NaN)
constexpr uint32_t DEAD = 1u << 9;     // |operand| < min normal
constexpr uint32_t NONNEG = 1u << 10;  // x side: |x|bits - BIAS >= 0

// The configs on the ported path use silu or no activation; the wrapper
// refuses the reference's other epilogue activations on the card until a
// config needs them (and a card test holds them against the plain
// version).
enum Act { ACT_NONE = 0, ACT_SILU = 1 };

__device__ __forceinline__ float activate(float z, int act) {
  return act == ACT_SILU ? z / (1.0f + expf(-z)) : z;
}

__device__ __forceinline__ float product(int32_t a1, uint32_t i1, int32_t m2,
                                         uint32_t i2, const int32_t* lut) {
  const uint32_t f = i1 | i2;
  const int32_t s = rapid::wrap_add(rapid::wrap_add(a1, m2), lut[f & 0xFFu]);
  const bool inf = (f & SAT) || ((i1 & NONNEG) && s < 0) || s >= INF_BITS;
  int32_t r = inf ? INF_BITS : (s < MIN_NORMAL ? 0 : s);
  r = (f & DEAD) ? 0 : r;
  return __uint_as_float(static_cast<uint32_t>(r) | ((i1 ^ i2) & F32_SIGN));
}

template <int BM, int BN, int BK, int TM, int TN, bool BATCHED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
log_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int32_t* __restrict__ lut,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int M, int N, int K, int act, int tiles_n, long long sx,
                  long long sw, long long sb, long long sr) {
  constexpr int TX = BN / TN;
  constexpr int NT = (BM / TM) * TX;
  __shared__ int32_t s_lut[256];
  __shared__ int32_t xa[BK][BM];
  __shared__ uint32_t xi[BK][BM];
  __shared__ int32_t wm[BK][BN];
  __shared__ uint32_t wi[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  int col0 = blockIdx.x * BN;
  if (BATCHED) {
    const long long bt = blockIdx.x / tiles_n;
    col0 = (blockIdx.x % tiles_n) * BN;
    x += bt * sx;
    w += bt * sw;
    if (bias) bias += bt * sb;
    if (residual) residual += bt * sr;
    out += bt * M * N;
  }
  for (int i = tid; i < 256; i += NT) s_lut[i] = lut[i];

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int kn = min(BK, K - k0);
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      const uint32_t b =
          (gr < M && gk < K) ? __float_as_uint(x[(size_t)gr * K + gk]) : 0u;
      const int32_t m = static_cast<int32_t>(b & F32_ABS);
      const int32_t a = m - F32_BIAS;
      xa[kk][r] = a;
      xi[kk][r] = (static_cast<uint32_t>((m >> 19) & 0xF) << 4) |
                  (m >= INF_BITS ? SAT : 0u) | (m < MIN_NORMAL ? DEAD : 0u) |
                  (a >= 0 ? NONNEG : 0u) | (b & F32_SIGN);
    }
#pragma unroll 4
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, c = e % BN;
      const int gk = k0 + kk, gc = col0 + c;
      const uint32_t b =
          (gk < K && gc < N) ? __float_as_uint(w[(size_t)gk * N + gc]) : 0u;
      const int32_t m = static_cast<int32_t>(b & F32_ABS);
      wm[kk][c] = m;
      wi[kk][c] = static_cast<uint32_t>((m >> 19) & 0xF) |
                  (m >= INF_BITS ? SAT : 0u) | (m < MIN_NORMAL ? DEAD : 0u) |
                  (b & F32_SIGN);
    }
    __syncthreads();
    // one k at a time, in K order: the accumulation order of the plain
    // version and of the reference's chunk=1 scan
    for (int kk = 0; kk < kn; ++kk) {
      int32_t a[TM], m[TN];
      uint32_t ia[TM], im[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = xa[kk][ty * TM + i];
        ia[i] = xi[kk][ty * TM + i];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        m[j] = wm[kk][tx + j * TX];
        im[j] = wi[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = acc[i][j] + product(a[i], ia[i], m[j], im[j], s_lut);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * TX;
      if (gc >= N) continue;
      float z = acc[i][j];
      if (bias) z = z + bias[gc];
      z = activate(z, act);
      if (residual) z = z + residual[(size_t)gr * N + gc];
      out[(size_t)gr * N + gc] = z;
    }
  }
}

struct Batch {
  int count;
  long long sx, sw, sb, sr;  // element strides; 0 = broadcast
};

template <int BM, int BN, int BK, int TM, int TN>
cudaError_t launch(const float* x, const float* w, const int32_t* lut,
                   const float* bias, const float* residual, float* out,
                   int M, int N, int K, int act, Batch b,
                   cudaStream_t stream) {
  const int tiles_n = (N + BN - 1) / BN;
  if (static_cast<long long>(tiles_n) * b.count > 0x7FFFFFFFll)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(tiles_n * b.count, (M + BM - 1) / BM);
  const int threads = (BM / TM) * (BN / TN);
  if (b.count > 1)
    log_matmul_kernel<BM, BN, BK, TM, TN, true><<<grid, threads, 0, stream>>>(
        x, w, lut, bias, residual, out, M, N, K, act, tiles_n, b.sx, b.sw,
        b.sb, b.sr);
  else
    log_matmul_kernel<BM, BN, BK, TM, TN, false><<<grid, threads, 0, stream>>>(
        x, w, lut, bias, residual, out, M, N, K, act, tiles_n, 0, 0, 0, 0);
  return cudaGetLastError();
}

}  // namespace

// Block geometry is a constant per regime (no autotuner yet):
//  * M <= 8 and N <= 8 (JPEG's batched 8 x 8 DCT products): one output
//    per thread, one 8 x 8 product per CTA;
//  * M <= 8 (decode): a whole 8-row stripe per thread, one output column
//    each, 64 columns per CTA -- the weight streams through once;
//  * otherwise (prefill): 64 x 64 tiles, 4 x 4 outputs per thread.
// out is [batch, M, N], contiguous; x, w, bias and residual advance by
// their batch strides.
extern "C" int rapid_log_matmul(const void* x, const void* w, const void* lut,
                                const void* bias, const void* residual,
                                void* out, int M, int N, int K, int act,
                                int batch, long long sx, long long sw,
                                long long sb, long long sr, void* stream) {
  const auto* xp = static_cast<const float*>(x);
  const auto* wp = static_cast<const float*>(w);
  const auto* lp = static_cast<const int32_t*>(lut);
  const auto* bp = static_cast<const float*>(bias);
  const auto* rp = static_cast<const float*>(residual);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const Batch b{batch, sx, sw, sb, sr};
  if (M <= 8 && N <= 8)
    return launch<8, 8, 8, 1, 1>(xp, wp, lp, bp, rp, op, M, N, K, act, b, st);
  if (M <= 8)
    return launch<8, 64, 32, 8, 1>(xp, wp, lp, bp, rp, op, M, N, K, act, b,
                                   st);
  return launch<64, 64, 16, 4, 4>(xp, wp, lp, bp, rp, op, M, N, K, act, b,
                                  st);
}
