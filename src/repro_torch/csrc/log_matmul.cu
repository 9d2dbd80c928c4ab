// K1: RAPID log-domain matmul with a fused elementwise epilogue; at
// DEPTH >= 2 stages it is K7.
//
// Replaces the Pallas TPU kernels src/repro/kernels/log_matmul/log_matmul.py
// log_matmul_pallas (K1: _kernel, _accumulate_block) and, as K1's stage
// count, log_matmul_pipelined (K7: _pipelined_kernel, depth K blocks in
// flight through manual DMAs).
//
// What bounds it on an H100: the products are int32 adds and a 256-entry
// LUT gather, which tensor cores cannot run.  At prefill (M = 512) the
// kernel is bound by the shared-memory LUT gather and the integer issue
// rate; at decode (M = 4) by the latency of each CTA's K walk: every
// output is a K-long chain of adds, and M x N outputs are few chains.
//
// Every output is summed one k at a time in K order, so every output is
// the same rounding sequence as the plain version
// (repro_torch/kernels/log_matmul/ops.py::log_matmul_plain) and the JAX
// reference log_matmul_scan(chunk=1): bit-equal, at every DEPTH.  No
// split over K, no regrouping: the speed comes from fewer instructions
// per product and from filling the card.
//
// Regimes (kernels/spec.py decides which; the entry point refuses a
// regime / geometry pair it did not compile):
//  * decode (M <= 8): decode_kernel, instances for 1, 2, 4 and 8 rows
//    (no padding rows past the next of those), 32 columns per CTA, so
//    N = 2560 gives 80 CTAs.  Each K block runs in two phases: 8 warps
//    compute the block's products into shared memory, then one thread
//    per output adds them in K order;
//  * chunk (8 < M <= 64): lean_kernel on 16 x 32 tiles, 4 rows per
//    thread, so a 64-row chunk of N = 2560 gives 320 CTAs;
//  * prefill: lean_kernel on 32 x 128 tiles, 8 x 4 outputs per thread;
//  * block8 (M <= 8 and N <= 8: JPEG's batched 8 x 8 DCT products): the
//    first formulation, one output per thread, one 8 x 8 product per CTA
//    (log_matmul_kernel below).
// In the first three a warp's 32 lanes take 32 columns of the same row,
// so each product's LUT gather (row part from x, column part from w)
// hits 32 distinct banks or broadcasts: no bank conflicts.
//
// The lean product.  Staging writes each operand as a pair: x as
// {a', row offset}, a' = bits(x) - BIAS (mod 2^32) -- the sign-folded
// (|x|bits - BIAS) + sign(x) -- and w as {m', column offset}, m' =
// bits(w) = |w|bits + sign(w); the offsets are the LUT index parts
// pre-scaled to bytes.  Wherever the true sum s = a + m + lut[idx]
// (a, m the unsigned parts) lies in [MIN_NORMAL, INF_BITS), the bits of
// log_mul_f32(x, w) are exactly a' + m' + lut[idx] (mod 2^32): the two
// sign bits add to their xor, and s never reaches bit 31.  The staging
// pass proves that per K block over the in-bounds operands (padding
// past M, N and K is never stored or summed): no operand is inf / NaN /
// zero / subnormal, min a + min m + lut_min >= MIN_NORMAL and max a +
// max m + lut_max < INF_BITS, in int64.  The proof is CTA-uniform
// (__syncthreads_and, then every thread reduces the same per-warp
// minima and maxima), so no warp diverges.  A proved block runs the
// lean loop: per product one IADD3 for the LDS address, the LDS, one
// IADD3 and the FADD (4.4 SASS instructions a product at prefill, with
// the operand loads).  Any other block (a zero, a subnormal, an inf or
// NaN, a pair whose sum would clamp) runs the full product(), which
// applies float_approx.log_mul_f32's inf / NaN-operand, overflow-wrap
// and flush rules.  decode_kernel computes the lean products while it
// proves, and recomputes a refused block with product() before the sum
// reads it.  Nothing but the proof chooses the path.
//
// Pipelining: DEPTH = 1 stages each K block synchronously (load, stage,
// sum); DEPTH >= 2 keeps a ring of DEPTH raw f32 x / w tiles in dynamic
// shared memory, filled by cp.async (16 B copies where the rows are
// 16 B aligned, 4 B copies otherwise, zero-filled past the ragged K / N
// / M edges), so the copies of blocks t+1 .. t+DEPTH-1 are in flight
// while block t is staged and summed.  Block t is waited for with
// cp.async.wait_group(DEPTH-2) and a barrier; block t+DEPTH-1 is issued
// after that barrier into the slot block t-1 left, which every thread
// has finished staging, so no copy overwrites a tile still read.  K
// smaller than DEPTH blocks (JPEG's 8 x 8 DCT) only issues the blocks
// that exist, as _pipelined_kernel's d < nk guard.
//
// The epilogue act(z + bias) + residual runs in the kernel.  A norm
// stage (rms / softmax over the whole row) is not fused: the wrapper
// runs it as a K2/K3 launch on this kernel's pre-norm output.  A batch
// of independent products [B, M, K] @ [B, K, N] runs in one launch: the
// batch is folded into gridDim.x (gridDim.y and .z stop at 65 535; a
// 2048^2 JPEG frame has 65 536 blocks), and each operand has a batch
// stride, 0 for an operand broadcast over the batch, which is never
// materialised.  The 2-D call is the batch-1 case, compiled with BATCHED
// = false so that its offsets fold away.
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

// regime codes of the entry point (kernels/spec.py MATMUL_REGIMES)
enum Regime { BLOCK8 = 0, DECODE = 1, CHUNK = 2, PREFILL = 3 };

// The activations of the ported configs: none, silu (the swiglu
// configs) and gelu in its tanh form (starcoder2_7b).  The wrapper
// refuses the reference's other epilogue activations on the card until a
// config needs them (and a card test holds them against the plain
// version); the entry point refuses any other code.
enum Act { ACT_NONE = 0, ACT_SILU = 1, ACT_GELU = 2 };

// torch's CUDA tanh gelu (ActivationGeluKernel.cu), step for step:
// x_cube = x * x * x, inner = kBeta * (x + kKappa * x_cube), then
// 0.5 * x * (1 + tanh(inner)), with kBeta = sqrt(2) * 2 / sqrt(pi) / 2
// rounded once to f32.  torch builds that file with FMA contraction, which
// turns x + kKappa * x_cube into one fma; this file builds with
// --fmad=false, so the fma is written out.  Where 1 + tanh(inner)
// cancels (z below about -3) a one-ulp change of tanh moves the result by
// thousands of ulps, so the plain version's bits need its exact steps.
// Out of line: inlined into every instance, it slowed the prefill
// regime's none / silu products by 3% at M = 512 (same registers), and
// out of line by under 1%; the gelu call is one per output.
__device__ __noinline__ float gelu_tanh(float z) {
  // M_SQRT2 * M_2_SQRTPI * 0.5 and 0.044715 in double, then rounded to
  // f32, as torch's constexpr opmath_t constants are
  constexpr float kBeta = static_cast<float>(
      1.41421356237309504880 * 1.12837916709551257390 * 0.5);
  constexpr float kKappa = static_cast<float>(0.044715);
  const float cube = z * z * z;
  const float inner = kBeta * __fmaf_rn(kKappa, cube, z);
  return 0.5f * z * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float activate(float z, int act) {
  return act == ACT_SILU   ? z / (1.0f + expf(-z))
         : act == ACT_GELU ? gelu_tanh(z)
                           : z;
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

// x-side operand: biased magnitude and its info word
__device__ __forceinline__ void decode_x(uint32_t b, int32_t& a,
                                         uint32_t& info) {
  const int32_t m = static_cast<int32_t>(b & F32_ABS);
  a = m - F32_BIAS;
  info = (static_cast<uint32_t>((m >> 19) & 0xF) << 4) |
         (m >= INF_BITS ? SAT : 0u) | (m < MIN_NORMAL ? DEAD : 0u) |
         (a >= 0 ? NONNEG : 0u) | (b & F32_SIGN);
}

// w-side operand: magnitude and its info word
__device__ __forceinline__ void decode_w(uint32_t b, int32_t& m,
                                         uint32_t& info) {
  m = static_cast<int32_t>(b & F32_ABS);
  info = static_cast<uint32_t>((m >> 19) & 0xF) |
         (m >= INF_BITS ? SAT : 0u) | (m < MIN_NORMAL ? DEAD : 0u) |
         (b & F32_SIGN);
}

// Issue the cp.async copies of K block k0 into one ring slot: x rows
// [row0, row0 + BM) x cols [k0, k0 + BK) as xr[BM][BK], w rows
// [k0, k0 + BK) x cols [col0, col0 + BN) as wr[BK][BN].  vx / vw: 16 B
// copies (rows 16 B aligned, K resp. N a multiple of 4, so a 4-wide
// chunk lies wholly inside or wholly outside the operand); else 4 B.
template <int BM, int BN, int BK, int NT>
__device__ __forceinline__ void issue_block(float* xr, float* wr,
                                            const float* x, const float* w,
                                            int row0, int col0, int k0,
                                            int M, int N, int K, int tid,
                                            bool vx, bool vw) {
  if (vx) {
    for (int c = tid; c < BM * BK / 4; c += NT) {
      const int r = c / (BK / 4), kk = (c % (BK / 4)) * 4;
      const int gr = row0 + r, gk = k0 + kk;
      const bool ok = gr < M && gk < K;
      rapid::cp_async16(xr + r * BK + kk, ok ? x + (size_t)gr * K + gk : x,
                        ok);
    }
  } else {
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      const bool ok = gr < M && gk < K;
      rapid::cp_async4(xr + e, ok ? x + (size_t)gr * K + gk : x, ok);
    }
  }
  if (vw) {
    for (int c = tid; c < BK * BN / 4; c += NT) {
      const int kk = c / (BN / 4), cc = (c % (BN / 4)) * 4;
      const int gk = k0 + kk, gc = col0 + cc;
      const bool ok = gk < K && gc < N;
      rapid::cp_async16(wr + kk * BN + cc, ok ? w + (size_t)gk * N + gc : w,
                        ok);
    }
  } else {
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e / BN, cc = e % BN;
      const int gk = k0 + kk, gc = col0 + cc;
      const bool ok = gk < K && gc < N;
      rapid::cp_async4(wr + e, ok ? w + (size_t)gk * N + gc : w, ok);
    }
  }
}

// The block8 regime's kernel: one output per thread (TM = TN = 1), the
// operands decoded once per K block into info words.
template <int BM, int BN, int BK, int TM, int TN, int DEPTH, bool BATCHED>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
log_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const int32_t* __restrict__ lut,
                  const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ out,
                  int M, int N, int K, int act, int tiles_n, long long sx,
                  long long sw, long long sb, long long sr, bool vx,
                  bool vw) {
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

  // one k at a time, in K order: the accumulation order of the plain
  // version and of the reference's chunk=1 scan
  auto sum_block = [&](int kn) {
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
  };

  if constexpr (DEPTH == 1) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int kn = min(BK, K - k0);
      __syncthreads();  // the previous tile is consumed
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        const uint32_t b =
            (gr < M && gk < K) ? __float_as_uint(x[(size_t)gr * K + gk]) : 0u;
        decode_x(b, xa[kk][r], xi[kk][r]);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        const uint32_t b =
            (gk < K && gc < N) ? __float_as_uint(w[(size_t)gk * N + gc]) : 0u;
        decode_w(b, wm[kk][c], wi[kk][c]);
      }
      __syncthreads();
      sum_block(kn);
    }
  } else {
    // the ring: DEPTH raw x tiles, then DEPTH raw w tiles
    extern __shared__ __align__(16) float ring[];
    float* xring = ring;
    float* wring = ring + DEPTH * BM * BK;
    const int nk = (K + BK - 1) / BK;
    // warm-up: blocks 0 .. DEPTH-2 in flight (one commit group each,
    // empty past the last block, so the group count stays uniform)
#pragma unroll
    for (int s = 0; s < DEPTH - 1; ++s) {
      if (s < nk)
        issue_block<BM, BN, BK, NT>(xring + s * BM * BK, wring + s * BK * BN,
                                    x, w, row0, col0, s * BK, M, N, K, tid,
                                    vx, vw);
      rapid::cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      rapid::cp_async_wait<DEPTH - 2>();  // block t has landed
      // every thread's copies of block t are visible, and every thread
      // is done with block t-1 (its raw slot and the decoded arrays)
      __syncthreads();
      const int nxt = t + DEPTH - 1;
      if (nxt < nk) {
        const int ns = nxt % DEPTH;  // the slot block t-1 left
        issue_block<BM, BN, BK, NT>(xring + ns * BM * BK,
                                    wring + ns * BK * BN, x, w, row0, col0,
                                    nxt * BK, M, N, K, tid, vx, vw);
      }
      rapid::cp_async_commit();
      const float* xr = xring + (t % DEPTH) * BM * BK;
      const float* wr = wring + (t % DEPTH) * BK * BN;
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        decode_x(__float_as_uint(xr[e]), xa[kk][r], xi[kk][r]);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, c = e % BN;
        decode_w(__float_as_uint(wr[e]), wm[kk][c], wi[kk][c]);
      }
      __syncthreads();
      sum_block(min(BK, K - t * BK));
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

// Per-warp slots of the lean proof's reduction: {min a, max a, min m,
// max m} over the warp's in-bounds staged operands.
constexpr int RED_SLOTS = 8;

// The proof's running bounds of one thread over the operands it stages.
struct Bounds {
  int32_t amin = 0x7FFFFFFF, amax = -0x7FFFFFFF - 1;
  int32_t mmin = 0x7FFFFFFF, mmax = -0x7FFFFFFF - 1;
  bool clean = true;  // no in-bounds operand is inf / NaN / 0 / subnormal
};

// Stage an x operand as {a', row offset}; an in-bounds one joins the proof.
__device__ __forceinline__ int2 stage_x(uint32_t b, bool in, Bounds& p) {
  const int32_t mag = static_cast<int32_t>(b & F32_ABS);
  if (in) {
    const int32_t a = mag - F32_BIAS;
    p.clean = p.clean && mag >= MIN_NORMAL && mag < INF_BITS;
    p.amin = min(p.amin, a);
    p.amax = max(p.amax, a);
  }
  return make_int2(static_cast<int32_t>(b - static_cast<uint32_t>(F32_BIAS)),
                   ((mag >> 19) & 0xF) << 6);
}

// Stage a w operand as {m', column offset}; an in-bounds one joins the proof.
__device__ __forceinline__ int2 stage_w(uint32_t b, bool in, Bounds& p) {
  const int32_t mag = static_cast<int32_t>(b & F32_ABS);
  if (in) {
    p.clean = p.clean && mag >= MIN_NORMAL && mag < INF_BITS;
    p.mmin = min(p.mmin, mag);
    p.mmax = max(p.mmax, mag);
  }
  return make_int2(static_cast<int32_t>(b), ((mag >> 19) & 0xF) << 2);
}

// The proof's verdict for one staged K block, after each thread has
// folded its staged operands into ``p``: every warp's bounds go to its
// slot of ``red``, the barrier (which also publishes the staged block),
// then every thread reduces the same NW slots, so the verdict is
// CTA-uniform.  True iff the block's products are all lean products.
template <int NW>
__device__ __forceinline__ bool prove(const Bounds& p, int4* red, int lane,
                                      int wy, int lut_min, int lut_max) {
  const int32_t amin = __reduce_min_sync(0xFFFFFFFFu, p.amin);
  const int32_t amax = __reduce_max_sync(0xFFFFFFFFu, p.amax);
  const int32_t mmin = __reduce_min_sync(0xFFFFFFFFu, p.mmin);
  const int32_t mmax = __reduce_max_sync(0xFFFFFFFFu, p.mmax);
  if (lane == 0) red[wy] = make_int4(amin, amax, mmin, mmax);
  const bool clean = __syncthreads_and(p.clean);
  int4 v = red[0];
#pragma unroll
  for (int s = 1; s < NW; ++s) {
    const int4 u = red[s];
    v = make_int4(min(v.x, u.x), max(v.y, u.y), min(v.z, u.z),
                  max(v.w, u.w));
  }
  return clean &&
         static_cast<long long>(v.x) + v.z + lut_min >= MIN_NORMAL &&
         static_cast<long long>(v.y) + v.w + lut_max < INF_BITS;
}

// The regimes' kernel: WM warps, one per TM rows; each lane takes TN
// columns, lane + 32 j, of those rows.  BM = WM * TM, BN = 32 * TN.
template <int WM, int TM, int TN, int BK, int DEPTH, bool BATCHED>
__global__ void __launch_bounds__(WM * 32)
lean_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const int32_t* __restrict__ lut, const float* __restrict__ bias,
            const float* __restrict__ residual, float* __restrict__ out,
            int M, int N, int K, int act, int tiles_n, long long sx,
            long long sw, long long sb, long long sr, bool vx, bool vw,
            int lut_min, int lut_max) {
  constexpr int BM = WM * TM, BN = 32 * TN, NT = WM * 32;
  static_assert(WM <= RED_SLOTS, "one reduction slot per warp");
  __shared__ int32_t s_lut[256];
  __shared__ int2 xs[BM][BK];  // {a', LUT row offset in bytes}
  __shared__ int2 ws[BK][BN];  // {m', LUT column offset in bytes}
  __shared__ int4 red[RED_SLOTS];

  const int tid = threadIdx.x;
  const int lane = tid % 32, wy = tid / 32;
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
  // a warp whose rows all lie past M only stages
  const bool live = row0 + wy * TM < M;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // one k at a time, in K order: the accumulation order of the plain
  // version and of the reference's chunk=1 scan
  auto sum_block = [&](int kn, bool lean) {
    if (!live) return;
    const char* lut_bytes = reinterpret_cast<const char*>(s_lut);
    if (lean) {
#pragma unroll 4
      for (int kk = 0; kk < kn; ++kk) {
        int2 wv[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) wv[j] = ws[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int2 xv = xs[wy * TM + i][kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const uint32_t c = *reinterpret_cast<const uint32_t*>(
                lut_bytes + (xv.y + wv[j].y));
            acc[i][j] = acc[i][j] +
                        __uint_as_float(static_cast<uint32_t>(xv.x) +
                                        static_cast<uint32_t>(wv[j].x) + c);
          }
        }
      }
    } else {
      for (int kk = 0; kk < kn; ++kk) {
        int32_t m[TN];
        uint32_t im[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j)
          decode_w(static_cast<uint32_t>(ws[kk][lane + 32 * j].x), m[j],
                   im[j]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          int32_t a;
          uint32_t ia;
          decode_x(static_cast<uint32_t>(xs[wy * TM + i][kk].x) +
                       static_cast<uint32_t>(F32_BIAS),
                   a, ia);
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = acc[i][j] + product(a, ia, m[j], im[j], s_lut);
        }
      }
    }
  };

  if constexpr (DEPTH == 1) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      const int kn = min(BK, K - k0);
      __syncthreads();  // the previous tile is consumed
      Bounds p;
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        const int gr = row0 + r, gk = k0 + kk;
        const bool in = gr < M && gk < K;
        xs[r][kk] = stage_x(
            in ? __float_as_uint(x[(size_t)gr * K + gk]) : 0u, in, p);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, c = e % BN;
        const int gk = k0 + kk, gc = col0 + c;
        const bool in = gk < K && gc < N;
        ws[kk][c] = stage_w(
            in ? __float_as_uint(w[(size_t)gk * N + gc]) : 0u, in, p);
      }
      sum_block(kn, prove<WM>(p, red, lane, wy, lut_min, lut_max));
    }
  } else {
    // the ring: DEPTH raw x tiles, then DEPTH raw w tiles
    extern __shared__ __align__(16) float ring[];
    float* xring = ring;
    float* wring = ring + DEPTH * BM * BK;
    const int nk = (K + BK - 1) / BK;
    // warm-up: blocks 0 .. DEPTH-2 in flight (one commit group each,
    // empty past the last block, so the group count stays uniform)
#pragma unroll
    for (int s = 0; s < DEPTH - 1; ++s) {
      if (s < nk)
        issue_block<BM, BN, BK, NT>(xring + s * BM * BK, wring + s * BK * BN,
                                    x, w, row0, col0, s * BK, M, N, K, tid,
                                    vx, vw);
      rapid::cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      rapid::cp_async_wait<DEPTH - 2>();  // block t has landed
      // every thread's copies of block t are visible, and every thread
      // is done with block t-1 (its raw slot and the staged arrays)
      __syncthreads();
      const int nxt = t + DEPTH - 1;
      if (nxt < nk) {
        const int ns = nxt % DEPTH;  // the slot block t-1 left
        issue_block<BM, BN, BK, NT>(xring + ns * BM * BK,
                                    wring + ns * BK * BN, x, w, row0, col0,
                                    nxt * BK, M, N, K, tid, vx, vw);
      }
      rapid::cp_async_commit();
      const float* xr = xring + (t % DEPTH) * BM * BK;
      const float* wr = wring + (t % DEPTH) * BK * BN;
      const int k0 = t * BK;
      Bounds p;
#pragma unroll 4
      for (int e = tid; e < BM * BK; e += NT) {
        const int r = e / BK, kk = e % BK;
        xs[r][kk] = stage_x(__float_as_uint(xr[e]),
                            row0 + r < M && k0 + kk < K, p);
      }
#pragma unroll 4
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, c = e % BN;
        ws[kk][c] = stage_w(__float_as_uint(wr[e]),
                            k0 + kk < K && col0 + c < N, p);
      }
      sum_block(min(BK, K - k0),
                prove<WM>(p, red, lane, wy, lut_min, lut_max));
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + wy * TM + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + lane + 32 * j;
      if (gc >= N) continue;
      float z = acc[i][j];
      if (bias) z = z + bias[gc];
      z = activate(z, act);
      if (residual) z = z + residual[(size_t)gr * N + gc];
      out[(size_t)gr * N + gc] = z;
    }
  }
}

// The decode regime's kernel: products and sums on different threads.
// With M <= 8 rows there are only M x 32 output chains per CTA, too few
// warps to hide a chain's latency, so each K block runs in two phases:
// all 8 warps compute the block's ROWS x BK x 32 products into shared
// memory (lane = column, so a warp's LUT gathers share one x operand;
// each w operand is read once per CTA), then one thread per output adds
// its BK products in K order.  The sum's order is the plain version's.
// The proof runs over the same block; a block it refuses recomputes its
// products with the full product() before the sum.
constexpr int DECODE_THREADS = 256;

template <int ROWS, int BK, int DEPTH, bool BATCHED>
__global__ void __launch_bounds__(DECODE_THREADS)
decode_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const int32_t* __restrict__ lut, const float* __restrict__ bias,
              const float* __restrict__ residual, float* __restrict__ out,
              int M, int N, int K, int act, int tiles_n, long long sx,
              long long sw, long long sb, long long sr, bool vx, bool vw,
              int lut_min, int lut_max) {
  constexpr int BN = 32, NT = DECODE_THREADS, NW = NT / 32;
  static_assert(NW <= RED_SLOTS, "one reduction slot per warp");
  __shared__ int32_t s_lut[256];
  __shared__ int2 xs[ROWS][BK];  // {a', LUT row offset in bytes}
  __shared__ int4 red[RED_SLOTS];
  // dynamic: the products [BK][ROWS][32], then at DEPTH >= 2 the ring
  extern __shared__ __align__(16) float dyn[];
  float* prod = dyn;

  const int tid = threadIdx.x;
  const int lane = tid % 32, wy = tid / 32;
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
  const int gc = col0 + lane;
  const char* lut_bytes = reinterpret_cast<const char*>(s_lut);
  float acc = 0.0f;

  // One K block: xr / wr its raw x [ROWS][BK] and w [BK][32] tiles in
  // the ring (DEPTH >= 2) or device memory (DEPTH = 1), kn its live k's.
  auto run_block = [&](const float* xr, const float* wr, int k0, int kn) {
    auto raw_w = [&](int kk) -> uint32_t {
      if constexpr (DEPTH > 1) return __float_as_uint(wr[kk * BN + lane]);
      return k0 + kk < K && gc < N
                 ? __float_as_uint(w[(size_t)(k0 + kk) * N + gc]) : 0u;
    };
    Bounds p;
    for (int e = tid; e < ROWS * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const bool in = r < M && kk < kn;
      uint32_t b;
      if constexpr (DEPTH > 1) b = __float_as_uint(xr[e]);
      else b = in ? __float_as_uint(x[(size_t)r * K + k0 + kk]) : 0u;
      xs[r][kk] = stage_x(b, in, p);
    }
    __syncthreads();  // the x pairs are staged
    // lean products, warp wy taking k = wy, wy + 8, ...; the proof's w
    // side on the way.  Every row's product is independent of the
    // others' (padding rows too: they are never summed), so the loads
    // of all ROWS issue together.
#pragma unroll 2
    for (int kk = wy; kk < kn; kk += NW) {
      const int2 wv = stage_w(raw_w(kk), gc < N, p);
      int2 xv[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) xv[r] = xs[r][kk];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const uint32_t c = *reinterpret_cast<const uint32_t*>(
            lut_bytes + (xv[r].y + wv.y));
        prod[(kk * ROWS + r) * BN + lane] = __uint_as_float(
            static_cast<uint32_t>(xv[r].x) + static_cast<uint32_t>(wv.x) +
            c);
      }
    }
    // CTA-uniform: a refused block is redone with product()
    if (!prove<NW>(p, red, lane, wy, lut_min, lut_max)) {
      for (int kk = wy; kk < kn; kk += NW) {
        int32_t m;
        uint32_t im;
        decode_w(raw_w(kk), m, im);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          int32_t a;
          uint32_t ia;
          decode_x(static_cast<uint32_t>(xs[r][kk].x) +
                       static_cast<uint32_t>(F32_BIAS),
                   a, ia);
          prod[(kk * ROWS + r) * BN + lane] = product(a, ia, m, im, s_lut);
        }
      }
      __syncthreads();
    }
    // one thread per output adds the block's products in K order
    if (wy < M) {
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk)
        acc = acc + prod[(kk * ROWS + wy) * BN + lane];
    }
  };

  if constexpr (DEPTH == 1) {
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // the previous block's products are summed
      run_block(nullptr, nullptr, k0, min(BK, K - k0));
    }
  } else {
    float* xring = dyn + BK * ROWS * BN;
    float* wring = xring + DEPTH * ROWS * BK;
    const int nk = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < DEPTH - 1; ++s) {
      if (s < nk)
        issue_block<ROWS, BN, BK, NT>(xring + s * ROWS * BK,
                                      wring + s * BK * BN, x, w, 0, col0,
                                      s * BK, M, N, K, tid, vx, vw);
      rapid::cp_async_commit();
    }
    for (int t = 0; t < nk; ++t) {
      rapid::cp_async_wait<DEPTH - 2>();  // block t has landed
      // every thread's copies of block t are visible, and block t-1's
      // products are summed and its raw slot staged
      __syncthreads();
      const int nxt = t + DEPTH - 1;
      if (nxt < nk) {
        const int ns = nxt % DEPTH;  // the slot block t-1 left
        issue_block<ROWS, BN, BK, NT>(xring + ns * ROWS * BK,
                                      wring + ns * BK * BN, x, w, 0, col0,
                                      nxt * BK, M, N, K, tid, vx, vw);
      }
      rapid::cp_async_commit();
      run_block(xring + (t % DEPTH) * ROWS * BK,
                wring + (t % DEPTH) * BK * BN, t * BK, min(BK, K - t * BK));
    }
  }

  if (wy < M && gc < N) {
    float z = acc;
    if (bias) z = z + bias[gc];
    z = activate(z, act);
    if (residual) z = z + residual[(size_t)wy * N + gc];
    out[(size_t)wy * N + gc] = z;
  }
}

struct Batch {
  int count;
  long long sx, sw, sb, sr;  // element strides; 0 = broadcast
};

// What one launch needs besides the kernel instance.
struct Call {
  const float *x, *w;
  const int32_t* lut;
  const float *bias, *residual;
  float* out;
  int M, N, K, act;
  Batch b;
  int lut_min, lut_max;
  cudaStream_t stream;
};

// 16 B copies need every row start 16 B aligned, batch entries too
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int BM, int BN, int BK, int TM, int TN, int DEPTH, bool BATCHED>
cudaError_t launch_block8(const Call& c, dim3 grid, int tiles_n, bool vx,
                          bool vw) {
  constexpr int threads = (BM / TM) * (BN / TN);
  constexpr int ring = DEPTH > 1 ? DEPTH * 4 * (BM * BK + BK * BN) : 0;
  auto kernel = log_matmul_kernel<BM, BN, BK, TM, TN, DEPTH, BATCHED>;
  static int granted = 0;
  if (ring > 0) {
    const cudaError_t err = rapid::allow_dynamic_smem(kernel, ring, granted);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, ring, c.stream>>>(
      c.x, c.w, c.lut, c.bias, c.residual, c.out, c.M, c.N, c.K, c.act,
      tiles_n, c.b.sx, c.b.sw, c.b.sb, c.b.sr, vx, vw);
  return cudaGetLastError();
}

template <int WM, int TM, int TN, int BK, int DEPTH, bool BATCHED>
cudaError_t launch_lean(const Call& c, dim3 grid, int tiles_n, bool vx,
                        bool vw) {
  constexpr int BM = WM * TM, BN = 32 * TN;
  constexpr int ring = DEPTH > 1 ? DEPTH * 4 * (BM * BK + BK * BN) : 0;
  auto kernel = lean_kernel<WM, TM, TN, BK, DEPTH, BATCHED>;
  static int granted = 0;
  if (ring > 0) {
    const cudaError_t err = rapid::allow_dynamic_smem(kernel, ring, granted);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, WM * 32, ring, c.stream>>>(
      c.x, c.w, c.lut, c.bias, c.residual, c.out, c.M, c.N, c.K, c.act,
      tiles_n, c.b.sx, c.b.sw, c.b.sb, c.b.sr, vx, vw, c.lut_min, c.lut_max);
  return cudaGetLastError();
}

template <int ROWS, int BK, int DEPTH, bool BATCHED>
cudaError_t launch_decode(const Call& c, dim3 grid, int tiles_n, bool vx,
                          bool vw) {
  constexpr int dyn = 4 * (BK * ROWS * 32 +
                           (DEPTH > 1 ? DEPTH * (ROWS * BK + BK * 32) : 0));
  auto kernel = decode_kernel<ROWS, BK, DEPTH, BATCHED>;
  static int granted = 0;
  const cudaError_t err = rapid::allow_dynamic_smem(kernel, dyn, granted);
  if (err != cudaSuccess) return err;
  kernel<<<grid, DECODE_THREADS, dyn, c.stream>>>(
      c.x, c.w, c.lut, c.bias, c.residual, c.out, c.M, c.N, c.K, c.act,
      tiles_n, c.b.sx, c.b.sw, c.b.sb, c.b.sr, vx, vw, c.lut_min, c.lut_max);
  return cudaGetLastError();
}

// The three kernels an instance may name.
enum Kind { TILE8, LEAN, SPLIT };

// One instance at one stage count: the grid, the copy widths, 2-D or
// batched.  TILE8: log_matmul_kernel<A, B, BK, C, C> (A = BM, B = BN,
// TM = TN = C); LEAN: lean_kernel<A, B, C, BK> (A = WM, B = TM, C = TN);
// SPLIT: decode_kernel<A, BK> (A = ROWS).
template <Kind KIND, int A, int B, int C, int BK, int DEPTH>
cudaError_t launch_depth(const Call& c) {
  constexpr int BM = KIND == LEAN ? A * B : A;
  constexpr int BN = KIND == LEAN ? 32 * C : KIND == SPLIT ? 32 : B;
  const int tiles_n = (c.N + BN - 1) / BN;
  if (static_cast<long long>(tiles_n) * c.b.count > 0x7FFFFFFFll)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(tiles_n * c.b.count, (c.M + BM - 1) / BM);
  const bool vx = aligned16(c.x) && c.K % 4 == 0 && c.b.sx % 4 == 0;
  const bool vw = aligned16(c.w) && c.N % 4 == 0 && c.b.sw % 4 == 0;
  const bool batched = c.b.count > 1;
  if constexpr (KIND == LEAN) {
    if (batched)
      return launch_lean<A, B, C, BK, DEPTH, true>(c, grid, tiles_n, vx, vw);
    return launch_lean<A, B, C, BK, DEPTH, false>(c, grid, tiles_n, vx, vw);
  } else if constexpr (KIND == SPLIT) {
    if (batched)
      return launch_decode<A, BK, DEPTH, true>(c, grid, tiles_n, vx, vw);
    return launch_decode<A, BK, DEPTH, false>(c, grid, tiles_n, vx, vw);
  } else {
    if (batched)
      return launch_block8<A, B, BK, C, C, DEPTH, true>(c, grid, tiles_n, vx,
                                                        vw);
    return launch_block8<A, B, BK, C, C, DEPTH, false>(c, grid, tiles_n, vx,
                                                       vw);
  }
}

// the stage counts this file compiles (kernels/spec.py MATMUL_DEPTHS)
template <Kind KIND, int A, int B, int C, int BK>
cudaError_t launch(const Call& c, int depth) {
  switch (depth) {
    case 1: return launch_depth<KIND, A, B, C, BK, 1>(c);
    case 2: return launch_depth<KIND, A, B, C, BK, 2>(c);
    case 3: return launch_depth<KIND, A, B, C, BK, 3>(c);
    case 4: return launch_depth<KIND, A, B, C, BK, 4>(c);
    case 8: return launch_depth<KIND, A, B, C, BK, 8>(c);
    default: return cudaErrorInvalidValue;
  }
}

// The compiled geometry (bm, bn, bk) of each regime, which
// kernels/spec.py's _MATMUL_GEOMETRY states for the shared-memory check.
// decode: K blocks of 128 up to 4 rows, 64 at 8 rows (its products and
// a depth-8 ring would not fit 227 KB at 128)
constexpr int DECODE_BN = 32;
constexpr int decode_bk(int rows) { return rows <= 4 ? 128 : 64; }
constexpr int CHUNK_WM = 4, CHUNK_TM = 4, CHUNK_TN = 1, CHUNK_BK = 64;
constexpr int PREFILL_WM = 4, PREFILL_TM = 8, PREFILL_TN = 4, PREFILL_BK = 16;

inline bool geometry_is(int bm, int bn, int bk, int gm, int gn, int gk) {
  return bm == gm && bn == gn && bk == gk;
}

}  // namespace

// out is [batch, M, N], contiguous; x, w, bias and residual advance by
// their batch strides.  depth: K blocks in flight (1, 2, 3, 4 or 8).
// regime, bm, bn, bk: the regime kernels/spec.py chose and the geometry
// it checked; a pair this file did not compile for the shape is refused
// with cudaErrorInvalidValue.  lut_min / lut_max: the scheme LUT's
// extremes, for the lean proof.
extern "C" int rapid_log_matmul(const void* x, const void* w, const void* lut,
                                const void* bias, const void* residual,
                                void* out, int M, int N, int K, int act,
                                int batch, long long sx, long long sw,
                                long long sb, long long sr, int depth,
                                int regime, int bm, int bn, int bk,
                                int lut_min, int lut_max, void* stream) {
  const Call c{static_cast<const float*>(x),
               static_cast<const float*>(w),
               static_cast<const int32_t*>(lut),
               static_cast<const float*>(bias),
               static_cast<const float*>(residual),
               static_cast<float*>(out),
               M, N, K, act,
               Batch{batch, sx, sw, sb, sr},
               lut_min, lut_max,
               static_cast<cudaStream_t>(stream)};
  if (act != ACT_NONE && act != ACT_SILU && act != ACT_GELU)
    return cudaErrorInvalidValue;
  switch (regime) {
    case BLOCK8:
      if (M > 8 || N > 8 || !geometry_is(bm, bn, bk, 8, 8, 8)) break;
      return launch<TILE8, 8, 8, 1, 8>(c, depth);
    case DECODE: {
      if (M > 8) break;
      const int rows = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
      if (!geometry_is(bm, bn, bk, rows, DECODE_BN, decode_bk(rows))) break;
      switch (rows) {
        case 1: return launch<SPLIT, 1, 0, 0, decode_bk(1)>(c, depth);
        case 2: return launch<SPLIT, 2, 0, 0, decode_bk(2)>(c, depth);
        case 4: return launch<SPLIT, 4, 0, 0, decode_bk(4)>(c, depth);
        default: return launch<SPLIT, 8, 0, 0, decode_bk(8)>(c, depth);
      }
    }
    case CHUNK:
      if (M > 64 || !geometry_is(bm, bn, bk, CHUNK_WM * CHUNK_TM,
                                 32 * CHUNK_TN, CHUNK_BK))
        break;
      return launch<LEAN, CHUNK_WM, CHUNK_TM, CHUNK_TN, CHUNK_BK>(c, depth);
    case PREFILL:
      if (!geometry_is(bm, bn, bk, PREFILL_WM * PREFILL_TM, 32 * PREFILL_TN,
                       PREFILL_BK))
        break;
      return launch<LEAN, PREFILL_WM, PREFILL_TM, PREFILL_TN, PREFILL_BK>(
          c, depth);
    default:
      break;
  }
  return cudaErrorInvalidValue;
}
