// K2 / K3: fused row divide -- rms normalize and softmax combine.
// K5 / K6: RAPID divide with a per-row denominator, and elementwise.
// K8: K2 / K3 / K5 over row slabs with DEPTH slabs in flight.
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_div/fused_div.py
// rms_div_pallas (K2), softmax_div_pallas (K3), div_rowbcast_pallas (K5)
// and div_pallas (K6), with their _rowwise_call plumbing, and, as the
// stage count of K2 / K3 / K5, _rowwise_pipelined_call /
// _rowwise_pipelined_kernel (K8; at the end of this file).
//
// What bounds it on an H100: device memory.  Each row is read twice (once
// for the denominator, once for the divide; the second read mostly hits
// L1/L2) and written once, with a few int32 ops per element.
//
// Design: one CTA of LANE (128) threads per row.  Thread t sums elements
// t, t + 128, ... in order, then the 128 partial sums fold by halving in
// shared memory: exactly the grouping of the plain version
// (repro_torch/kernels/fused_div/ref.py::lane_sum), so the denominator,
// and with it every quotient, is bit-equal to the plain version.  The
// rms denominator keeps the reference's canonical form
// sqrt((ss + n*eps) * (1/n)) with both constants folded to f32 by the
// caller; every op is an explicit round-to-nearest intrinsic.  The divide
// is rapid::log_div_f32 (or an IEEE divide when no LUT is given).  An
// optional output receives each row's denominator, so a check can hold
// the quotients against the plain divide fed the kernel's own
// denominator.
#include "rapid.cuh"

namespace {

constexpr int LANE = rapid::LANE;

template <bool RMS>
__global__ void __launch_bounds__(LANE)
row_div_kernel(const float* __restrict__ x, float* __restrict__ out,
               float* __restrict__ denom_out, const int32_t* __restrict__ lut,
               int n, float c_add, float c_mul, float floor) {
  __shared__ int32_t s_lut[256];
  __shared__ float red[LANE];
  const int t = threadIdx.x;
  const size_t row = blockIdx.x;
  if (lut)
    for (int i = t; i < 256; i += LANE) s_lut[i] = lut[i];
  const float* xr = x + row * n;

  float acc = 0.0f;
  for (int j = t; j < n; j += LANE) {
    const float v = xr[j];
    acc = __fadd_rn(acc, RMS ? __fmul_rn(v, v) : v);
  }
  red[t] = acc;
  __syncthreads();
#pragma unroll
  for (int h = LANE / 2; h > 0; h >>= 1) {
    if (t < h) red[t] = __fadd_rn(red[t], red[t + h]);
    __syncthreads();
  }
  const float s = red[0];
  // softmax: max(sum, floor) with NaN propagating, as torch.maximum
  const float d = RMS ? __fsqrt_rn(__fmul_rn(__fadd_rn(s, c_add), c_mul))
                      : (s < floor ? floor : s);
  if (denom_out && t == 0) denom_out[row] = d;

  float* orow = out + row * n;
  for (int j = t; j < n; j += LANE)
    orow[j] = lut ? rapid::log_div_f32(xr[j], d, s_lut) : __fdiv_rn(xr[j], d);
}

}  // namespace

namespace {
int launch_slabs(int op, int depth, const float* x, const float* b,
                 float* out, float* denom_out, const int32_t* lut, int rows,
                 int n, int bm, float c_add, float c_mul, float floor,
                 cudaStream_t stream);
}  // namespace

// depth 1: one block per row; depth >= 2: K8, slabs of bm rows
extern "C" int rapid_rms_div(const void* x, void* out, void* denom_out,
                             const void* lut, int rows, int n, int depth,
                             int bm, float c_add, float c_mul, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (depth > 1)
    return launch_slabs(0, depth, static_cast<const float*>(x), nullptr,
                        static_cast<float*>(out),
                        static_cast<float*>(denom_out),
                        static_cast<const int32_t*>(lut), rows, n, bm, c_add,
                        c_mul, 0.0f, st);
  row_div_kernel<true><<<rows, LANE, 0, st>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(denom_out), static_cast<const int32_t*>(lut), n,
      c_add, c_mul, 0.0f);
  return cudaGetLastError();
}

extern "C" int rapid_softmax_div(const void* e, void* out, void* denom_out,
                                 const void* lut, int rows, int n, int depth,
                                 int bm, float floor, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (depth > 1)
    return launch_slabs(1, depth, static_cast<const float*>(e), nullptr,
                        static_cast<float*>(out),
                        static_cast<float*>(denom_out),
                        static_cast<const int32_t*>(lut), rows, n, bm, 0.0f,
                        0.0f, floor, st);
  row_div_kernel<false><<<rows, LANE, 0, st>>>(
      static_cast<const float*>(e), static_cast<float*>(out),
      static_cast<float*>(denom_out), static_cast<const int32_t*>(lut), n,
      0.0f, 0.0f, floor);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K5 / K6: out = log_div_f32(a, b) elementwise.
//
// What bounds them on an H100: device memory.  Each element is read once
// and written once (K6 also reads its own denominator), with ~20 int32
// ops per element against ~3.35 TB/s of HBM.
//
// Design: one thread per output element over the flat operand, in a
// grid-stride loop sized to fill the card (8 CTAs of 256 threads per SM),
// the 256-entry LUT staged in shared memory as in row_div_kernel.  K5
// finds its row as i / n and reads the [rows] denominator vector, which
// neighbouring threads share, so it is served from L1; the lane
// broadcast that the TPU kernel did in VMEM costs nothing here.  K6 reads
// a second full-size operand instead.  The divide is rapid::log_div_f32,
// the function K2-K4 share, so every quotient is bit-equal to
// float_approx.log_div_f32 on the same operands.
namespace {

constexpr int DIV_THREADS = 256;

template <bool ROWBCAST>
__global__ void __launch_bounds__(DIV_THREADS)
elementwise_div_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       const int32_t* __restrict__ lut, unsigned total,
                       unsigned n) {
  __shared__ int32_t s_lut[256];
  for (int i = threadIdx.x; i < 256; i += DIV_THREADS) s_lut[i] = lut[i];
  __syncthreads();
  const unsigned stride = gridDim.x * DIV_THREADS;
  for (unsigned i = blockIdx.x * DIV_THREADS + threadIdx.x; i < total;
       i += stride)
    out[i] = rapid::log_div_f32(a[i], ROWBCAST ? __ldg(b + i / n) : b[i],
                                s_lut);
}

int div_grid(unsigned total) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned want = (total + DIV_THREADS - 1) / DIV_THREADS;
  const unsigned cap = 8u * static_cast<unsigned>(sms);
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

// a [rows, n] / b [rows] (one denominator per row); rows * n < 2^31.
// depth 1: one thread per element; depth >= 2: K8, slabs of bm rows.
extern "C" int rapid_div_rowbcast(const void* a, const void* b, void* out,
                                  const void* lut, int rows, int n, int depth,
                                  int bm, void* stream) {
  if (depth > 1)
    return launch_slabs(2, depth, static_cast<const float*>(a),
                        static_cast<const float*>(b), static_cast<float*>(out),
                        nullptr, static_cast<const int32_t*>(lut), rows, n,
                        bm, 0.0f, 0.0f, 0.0f,
                        static_cast<cudaStream_t>(stream));
  const unsigned total = static_cast<unsigned>(rows) * static_cast<unsigned>(n);
  elementwise_div_kernel<true>
      <<<div_grid(total), DIV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), static_cast<const int32_t*>(lut), total,
          static_cast<unsigned>(n));
  return cudaGetLastError();
}

// a [total] / b [total]; total < 2^31.
extern "C" int rapid_div(const void* a, const void* b, void* out,
                         const void* lut, int total, void* stream) {
  const unsigned t = static_cast<unsigned>(total);
  elementwise_div_kernel<false>
      <<<div_grid(t), DIV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), static_cast<const int32_t*>(lut), t, 1u);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K8: K2 / K3 / K5 with DEPTH row slabs in flight.
//
// Replaces _rowwise_pipelined_call / _rowwise_pipelined_kernel of
// src/repro/kernels/fused_div/fused_div.py (the depth >= 2 form of
// rms_div_pallas, softmax_div_pallas and div_rowbcast_pallas).
//
// What bounds it on an H100: device memory, as K2 / K3 / K5 -- each row
// read once (into shared memory) and written once.
//
// Design: a grid of at most (#SMs x the blocks that fit on an SM)
// blocks of ROW_WARPS warps; block g walks slabs g, g + gridDim.x, ...
// of bm rows, with the next DEPTH-1 slabs of its own in flight by
// cp.async into a ring of DEPTH slabs in dynamic shared memory (16 B
// copies where bm * n is a multiple of 4 and x is 16 B aligned, so
// every slab starts aligned; 4 B copies for the rest).  Slab i is
// waited for with cp.async.wait_group(DEPTH-2) and a barrier; slab
// i+DEPTH-1 is then issued into the slot slab i-1 left.  Each warp takes
// one row of the slab at a time: lane l sums elements l, l+32, l+64 and
// l+96 of the 128-lane grouping as four separate partial sums (each one
// lane's sum of row_div_kernel, in the same order), folds them as the
// halving steps h = 64 and h = 32 do, and the steps h = 16 .. 1 by
// shuffles: the denominator is bit-equal to K2 / K3's, and so is every
// quotient.  The stores of slab i are plain global stores: they drain
// while slab i+DEPTH-1 loads, which is what the reference's out-DMA ring
// arranges by hand.  K5 reads its [rows] denominator per row from
// global memory (the reference keeps the [M, 1] column resident in
// VMEM).
namespace {

constexpr int ROW_WARPS = 4;
constexpr int ROW_THREADS = ROW_WARPS * 32;

template <int OP, int DEPTH>  // OP 0: rms, 1: softmax, 2: row broadcast
__global__ void __launch_bounds__(ROW_THREADS)
row_slab_kernel(const float* __restrict__ x, const float* __restrict__ b,
                float* __restrict__ out, float* __restrict__ denom_out,
                const int32_t* __restrict__ lut, int rows, int n, int bm,
                float c_add, float c_mul, float floor, bool vec) {
  __shared__ int32_t s_lut[256];
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (lut)
    for (int i = tid; i < 256; i += ROW_THREADS) s_lut[i] = lut[i];
  const int nslabs = (rows + bm - 1) / bm;
  const int mine = (nslabs - 1 - static_cast<int>(blockIdx.x)) /
                       static_cast<int>(gridDim.x) + 1;
  const size_t slab = static_cast<size_t>(bm) * n;

  // rows of this block's i-th slab: [first, first + count)
  auto slab_rows = [&](int i, long long& first) {
    first = (static_cast<long long>(blockIdx.x) +
             static_cast<long long>(i) * gridDim.x) * bm;
    const long long left = rows - first;
    return static_cast<int>(left < bm ? left : bm);
  };
  // the i-th slab of this block into ring slot i % DEPTH
  auto issue = [&](int i) {
    long long r0;
    const long long len = static_cast<long long>(slab_rows(i, r0)) * n;
    const float* src = x + r0 * n;
    float* dst = ring + static_cast<size_t>(i % DEPTH) * slab;
    long long done = 0;
    if (vec) {
      done = len / 4 * 4;
      for (long long c = tid; c < len / 4; c += ROW_THREADS)
        rapid::cp_async16(dst + 4 * c, src + 4 * c, true);
    }
    for (long long e = done + tid; e < len; e += ROW_THREADS)
      rapid::cp_async4(dst + e, src + e, true);
  };

  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < mine) issue(i);
    rapid::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    rapid::cp_async_wait<DEPTH - 2>();  // slab i has landed
    // slab i is visible to every warp, and every warp is done with
    // slab i-1, whose slot the next issue reuses
    __syncthreads();
    if (i + DEPTH - 1 < mine) issue(i + DEPTH - 1);
    rapid::cp_async_commit();
    long long r0;
    const int nr = slab_rows(i, r0);
    const float* sl = ring + static_cast<size_t>(i % DEPTH) * slab;
    for (int r = warp; r < nr; r += ROW_WARPS) {
      const float* xr = sl + static_cast<size_t>(r) * n;
      const long long row = r0 + r;
      float d;
      if constexpr (OP == 2) {
        d = __ldg(b + row);
      } else {
        float p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p[q] = 0.0f;
          for (int j = lane + 32 * q; j < n; j += LANE) {
            const float v = xr[j];
            p[q] = __fadd_rn(p[q], OP == 0 ? __fmul_rn(v, v) : v);
          }
        }
        // row_div_kernel's halving steps: h = 64, then h = 32
        float s = __fadd_rn(__fadd_rn(p[0], p[2]), __fadd_rn(p[1], p[3]));
#pragma unroll
        for (int h = 16; h > 0; h >>= 1)
          s = __fadd_rn(s, __shfl_down_sync(0xFFFFFFFFu, s, h));
        s = __shfl_sync(0xFFFFFFFFu, s, 0);
        d = OP == 0 ? __fsqrt_rn(__fmul_rn(__fadd_rn(s, c_add), c_mul))
                    : (s < floor ? floor : s);
        if (denom_out && lane == 0) denom_out[row] = d;
      }
      float* orow = out + row * n;
      for (int j = lane; j < n; j += 32)
        orow[j] = lut ? rapid::log_div_f32(xr[j], d, s_lut)
                      : __fdiv_rn(xr[j], d);
    }
  }
}

template <int OP, int DEPTH>
cudaError_t launch_slabs_depth(const float* x, const float* b, float* out,
                               float* denom_out, const int32_t* lut, int rows,
                               int n, int bm, float c_add, float c_mul,
                               float floor, cudaStream_t stream) {
  auto kernel = row_slab_kernel<OP, DEPTH>;
  const long long ring = static_cast<long long>(DEPTH) * bm * n * 4;
  if (bm < 1 || ring > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  static int granted = 0, occ_ring = -1, occ_blocks = 0;
  cudaError_t err =
      rapid::allow_dynamic_smem(kernel, static_cast<int>(ring), granted);
  if (err != cudaSuccess) return err;
  if (occ_ring != ring) {  // blocks of this size that fit on one SM
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks, kernel, ROW_THREADS, static_cast<size_t>(ring));
    if (err != cudaSuccess) return err;
    occ_ring = static_cast<int>(ring);
  }
  if (occ_blocks < 1) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long nslabs = (static_cast<long long>(rows) + bm - 1) / bm;
  const long long cap = static_cast<long long>(sms) * occ_blocks;
  const int grid = static_cast<int>(nslabs < cap ? nslabs : cap);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (static_cast<long long>(bm) * n) % 4 == 0;
  kernel<<<grid, ROW_THREADS, static_cast<size_t>(ring), stream>>>(
      x, b, out, denom_out, lut, rows, n, bm, c_add, c_mul, floor, vec);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_slabs_op(int depth, const float* x, const float* b,
                            float* out, float* denom_out, const int32_t* lut,
                            int rows, int n, int bm, float c_add, float c_mul,
                            float floor, cudaStream_t st) {
  switch (depth) {
#define RAPID_SLAB_DEPTH(D)                                                   \
  case D:                                                                     \
    return launch_slabs_depth<OP, D>(x, b, out, denom_out, lut, rows, n, bm, \
                                     c_add, c_mul, floor, st);
    RAPID_SLAB_DEPTH(2)
    RAPID_SLAB_DEPTH(3)
    RAPID_SLAB_DEPTH(4)
    RAPID_SLAB_DEPTH(5)
    RAPID_SLAB_DEPTH(6)
    RAPID_SLAB_DEPTH(7)
    RAPID_SLAB_DEPTH(8)
#undef RAPID_SLAB_DEPTH
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_slabs(int op, int depth, const float* x, const float* b,
                 float* out, float* denom_out, const int32_t* lut, int rows,
                 int n, int bm, float c_add, float c_mul, float floor,
                 cudaStream_t stream) {
  if (rows < 1 || n < 1) return cudaErrorInvalidValue;
  switch (op) {
    case 0:
      return launch_slabs_op<0>(depth, x, b, out, denom_out, lut, rows, n,
                                bm, c_add, c_mul, floor, stream);
    case 1:
      return launch_slabs_op<1>(depth, x, b, out, denom_out, lut, rows, n,
                                bm, c_add, c_mul, floor, stream);
    default:
      return launch_slabs_op<2>(depth, x, b, out, denom_out, lut, rows, n,
                                bm, c_add, c_mul, floor, stream);
  }
}

}  // namespace
