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

}  // namespace rapid
