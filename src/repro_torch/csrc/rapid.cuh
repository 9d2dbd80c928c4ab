// RAPID log-domain float32 arithmetic for the port's CUDA kernels.
//
// Device-side mirror of repro_torch/core/float_approx.py (itself bit-equal
// to the JAX reference).  The reference detects exponent overflow through
// int32 two's-complement wrap; signed overflow is undefined in C++, so the
// adds below run in uint32 and are reinterpreted, which keeps the compiler
// from deleting the `(half >= 0) && (s < 0)` test.
//
// Every source of the port is compiled with --fmad=false (kernels/_build.py):
// no a*b+c is contracted to an FMA, so the rms denominator's `ss += x*x`
// and the flash kernel's online-softmax updates round after every op, as
// the plain PyTorch versions do.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace rapid {

constexpr int32_t F32_BIAS = 127 << 23;
constexpr uint32_t F32_ABS = 0x7FFFFFFFu;
constexpr uint32_t F32_SIGN = 0x80000000u;
constexpr int32_t MIN_NORMAL = 0x00800000;
constexpr int32_t INF_BITS = 0x7F800000;
// row-sum grouping shared with kernels/fused_div/ref.py::lane_sum
constexpr int LANE = 128;

// cp.async (sm_80+): global -> shared copies that bypass the registers.
// With ``pred`` false the source is not read and the destination is
// zero-filled (src-size 0).  cp16 needs both addresses 16 B aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Let ``kernel`` take ``bytes`` of dynamic shared memory (needed above
// 48 KB per block).  ``granted`` is the caller's record for this kernel
// instance (a static in the launching template), so the attribute is
// set once per instance and size.
template <typename Kernel>
inline cudaError_t allow_dynamic_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int lut_index(int32_t m1, int32_t m2) {
  return ((m1 >> 19) & 0xF) * 16 + ((m2 >> 19) & 0xF);
}

// Clamp under/overflow, apply the sign, zero the dead lanes.
__device__ __forceinline__ float finish(int32_t s, uint32_t sign, bool dead) {
  s = s >= INF_BITS ? INF_BITS : s;
  s = s < MIN_NORMAL ? 0 : s;
  s = dead ? 0 : s;
  return __uint_as_float(static_cast<uint32_t>(s) | sign);
}

// RAPID approximate a / b (b == 0 -> +-inf, 0 / b == 0).
__device__ __forceinline__ float log_div_f32(float a, float b,
                                             const int32_t* lut) {
  const uint32_t ba = __float_as_uint(a), bb = __float_as_uint(b);
  const uint32_t sign = (ba ^ bb) & F32_SIGN;
  const int32_t m1 = static_cast<int32_t>(ba & F32_ABS);
  const int32_t m2 = static_cast<int32_t>(bb & F32_ABS);
  const int32_t diff = m1 - m2;  // both in [0, 2^31): cannot overflow
  int32_t s = wrap_add(wrap_add(diff, F32_BIAS), lut[lut_index(m1, m2)]);
  const bool wrapped = diff >= 0 && s < 0;  // huge / tiny past inf
  s = (wrapped || m1 >= INF_BITS) ? INF_BITS : s;
  s = m2 < MIN_NORMAL ? INF_BITS : s;  // x / 0
  return finish(s, sign, m1 < MIN_NORMAL);
}

// RAPID approximate a * b (0 * x == 0, inf propagates, overflow -> inf).
__device__ __forceinline__ float log_mul_f32(float a, float b,
                                             const int32_t* lut) {
  const uint32_t ba = __float_as_uint(a), bb = __float_as_uint(b);
  const uint32_t sign = (ba ^ bb) & F32_SIGN;
  const int32_t m1 = static_cast<int32_t>(ba & F32_ABS);
  const int32_t m2 = static_cast<int32_t>(bb & F32_ABS);
  const int32_t half = m1 - F32_BIAS;
  int32_t s = wrap_add(wrap_add(half, m2), lut[lut_index(m1, m2)]);
  const bool wrapped = half >= 0 && s < 0;
  s = (wrapped || m1 >= INF_BITS || m2 >= INF_BITS) ? INF_BITS : s;
  return finish(s, sign, m1 < MIN_NORMAL || m2 < MIN_NORMAL);
}

// the current device's SMs into *sms, read once per device (a failed read
// is returned, and read again at the next call)
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int count = dev < kDevices ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (count == 0) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < kDevices) cached[dev].store(count, std::memory_order_relaxed);
  }
  *sms = count;
  return cudaSuccess;
}

}  // namespace rapid
