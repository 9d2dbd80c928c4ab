// K9 / K10: the paper's integer RAPID multiplier and 2N-by-N divider.
//
// Replaces the Pallas TPU kernels src/repro/kernels/rapid_mul/rapid_mul.py
// (rapid_mul_pallas, _kernel) and src/repro/kernels/rapid_div/rapid_div.py
// (rapid_div_pallas, _kernel).
//
// What bounds them on an H100: device memory.  Each element reads two
// int32 operands and writes one int64 result (16 bytes) for ~30 integer
// ops; at 3.35 TB/s that is ~0.2 ns an element against ~0.03 ns of
// int32 issue across the card.
//
// Design: one thread per element in a grid-stride loop sized to fill the
// card (8 CTAs of 256 threads per SM), the 256-entry int32 LUT staged in
// shared memory, as K5/K6 in fused_div.cu.  No padding: the loop masks
// the ragged end.  The arithmetic is the reference's int32 / uint32
// sequence step by step (repro_torch/core/mitchell.py mul_terms /
// div_terms is its plain version): the leading-one detector is
// 31 - __clz(v), which equals the reference's smear + popcount ilog2 for
// every v >= 1.  Every shift stays in range for operands inside the
// contract (a, b < 2^n for the multiplier, a < 2^(2n), b < 2^n for the
// divider): the multiplier's left shift is at most n <= 16 and its right
// shift at most n - 1; the divider's left shift is 0 and its right shift
// is capped at 31, as in the reference.  The fraction of a zero operand,
// (0 - 1) << F, is formed in uint32 so that no negative value is shifted
// left.  The wrapper hands over int32 operands and receives int64 results
// holding the reference's uint32 values.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int32_t ilog2(int32_t v) {  // v >= 1
  return 31 - __clz(v);
}

// Leading one k of max(v, 1), the fraction below it aligned to F bits
// (negative for v == 0, as in the reference) and its 4 MSBs.  Below 4
// fraction bits the reference's shift by F - 4 < 0 is XLA's sign fill:
// a shift by 31.
__device__ __forceinline__ int align(int32_t v, int F, int32_t& k,
                                     int32_t& f) {
  k = ilog2(v > 1 ? v : 1);
  f = static_cast<int32_t>(static_cast<uint32_t>(v - (1 << k)) << (F - k));
  return (f >> (F >= 4 ? F - 4 : 31)) & 0xF;
}

__global__ void __launch_bounds__(THREADS)
rapid_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 const int32_t* __restrict__ lut, long long* __restrict__ out,
                 long long total, int n_bits) {
  __shared__ int32_t s_lut[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) s_lut[i] = lut[i];
  __syncthreads();
  const int F = n_bits - 1;
  const int32_t one = 1 << F;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < total; i += stride) {
    const int32_t x = a[i], y = b[i];
    int32_t k1, f1, k2, f2;
    const int i1 = align(x, F, k1, f1);
    const int i2 = align(y, F, k2, f2);
    const int32_t s = f1 + f2 + s_lut[i1 * 16 + i2];
    const int carry = s >= one ? 1 : 0;
    int32_t mant = carry ? s : s + one;
    mant = mant > 0 ? mant : 0;
    const int shift = k1 + k2 + carry - F;  // in [-F, n_bits]
    const uint32_t pos = shift > 0 ? shift : 0;
    const uint32_t neg = shift < 0 ? -shift : 0;
    uint32_t res = (static_cast<uint32_t>(mant) << pos) >> neg;
    // saturate where the left shift overflowed 32 bits
    const int hi = ilog2(mant > 1 ? mant : 1) + shift;
    res = hi >= 32 ? 0xFFFFFFFFu : res;
    out[i] = (x == 0 || y == 0) ? 0ll : static_cast<long long>(res);
  }
}

__global__ void __launch_bounds__(THREADS)
rapid_div_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 const int32_t* __restrict__ lut, long long* __restrict__ out,
                 long long total, int n_bits) {
  __shared__ int32_t s_lut[256];
  for (int i = threadIdx.x; i < 256; i += THREADS) s_lut[i] = lut[i];
  __syncthreads();
  const int F = 2 * n_bits - 1;
  const int32_t one = 1 << F;
  const long long sat = (1ll << (2 * n_bits)) - 1;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       i < total; i += stride) {
    const int32_t x = a[i], y = b[i];
    int32_t k1, f1, k2, f2;
    const int i1 = align(x, F, k1, f1);
    const int i2 = align(y, F, k2, f2);
    const int32_t s = f1 - f2 + s_lut[i1 * 16 + i2];
    const int borrow = s < 0 ? 1 : 0;
    int32_t mant = borrow ? s + 2 * one : s + one;
    mant = mant > 0 ? mant : 0;
    const int shift = k1 - k2 - borrow - F;  // <= 0
    const uint32_t pos = shift > 0 ? shift : 0;
    const uint32_t neg = shift < -31 ? 31 : (shift < 0 ? -shift : 0);
    uint32_t res = (static_cast<uint32_t>(mant) << pos) >> neg;
    res = x == 0 ? 0u : res;
    out[i] = y == 0 ? sat : static_cast<long long>(res);
  }
}

int grid_for(long long total) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (total + THREADS - 1) / THREADS;
  const long long cap = 8ll * sms;
  return static_cast<int>(want < cap ? want : cap);
}

}  // namespace

// a, b: int32 [total] (a, b < 2^n_bits, n_bits <= 16); out: int64 [total].
extern "C" int rapid_mul_int(const void* a, const void* b, const void* lut,
                             void* out, long long total, int n_bits,
                             void* stream) {
  rapid_mul_kernel<<<grid_for(total), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(lut), static_cast<long long*>(out), total,
      n_bits);
  return cudaGetLastError();
}

// a < 2^(2 n_bits), b < 2^n_bits, int32 [total] (2 n_bits <= 31);
// out: int64 [total].
extern "C" int rapid_div_int(const void* a, const void* b, const void* lut,
                             void* out, long long total, int n_bits,
                             void* stream) {
  rapid_div_kernel<<<grid_for(total), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const int32_t*>(lut), static_cast<long long*>(out), total,
      n_bits);
  return cudaGetLastError();
}
