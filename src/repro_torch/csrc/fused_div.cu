// K2 / K3: fused row divide -- rms normalize and softmax combine.
// K5 / K6: RAPID divide with a per-row denominator, and elementwise.
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_div/fused_div.py
// rms_div_pallas (K2), softmax_div_pallas (K3), div_rowbcast_pallas (K5)
// and div_pallas (K6), with their _rowwise_call /
// _rowwise_pipelined_call plumbing.
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

extern "C" int rapid_rms_div(const void* x, void* out, void* denom_out,
                             const void* lut, int rows, int n, float c_add,
                             float c_mul, void* stream) {
  row_div_kernel<true><<<rows, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<float*>(denom_out), static_cast<const int32_t*>(lut), n,
      c_add, c_mul, 0.0f);
  return cudaGetLastError();
}

extern "C" int rapid_softmax_div(const void* e, void* out, void* denom_out,
                                 const void* lut, int rows, int n, float floor,
                                 void* stream) {
  row_div_kernel<false><<<rows, LANE, 0, static_cast<cudaStream_t>(stream)>>>(
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
extern "C" int rapid_div_rowbcast(const void* a, const void* b, void* out,
                                  const void* lut, int rows, int n,
                                  void* stream) {
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
