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
#include <initializer_list>
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

// The walk of the elementwise streaming kernels (K5 / K6 in
// fused_div.cu, K9 / K10 in rapid_int.cu), over `total` elements of which
// the first `head` come before the 16 B vector body (kernels/spec.py
// int_split): thread t of the grid's S threads takes vectors t, t + S,
// t + 2 S, ..., so the grid streams one window of memory at a time and
// every thread walks the same count to within one vector.  Each round a
// thread loads its next round's vector before it computes this round's,
// and the first round's loads are issued before the block stages its
// shared memory (op.stage(), then a barrier).  The head and the tail (the
// fewer than 4 elements past the body) follow, one element a thread.
// Op supplies Vec (what one vector's loads bring), Vec load(v), void
// stage(), void store(v, const Vec&) (compute and store vector v) and
// void scalar(e) (compute and store element e); Index is uint32_t below
// 2^31 elements, unsigned long long past them.
template <int THREADS, typename Index, typename Op>
__device__ __forceinline__ void stream_walk(Index total, Index head, Op& op) {
  const Index vectors = (total - head) / 4;
  const Index stride = static_cast<Index>(gridDim.x) * THREADS;

  // the first round's loads in flight before the shared memory is staged
  Index v = static_cast<Index>(blockIdx.x) * THREADS + threadIdx.x;
  typename Op::Vec cur, next;
  if (v < vectors) cur = op.load(v);
  op.stage();
  __syncthreads();

  for (; v < vectors; v += stride) {
    const Index nv = v + stride;
    if (nv < vectors) next = op.load(nv);
    op.store(v, cur);
    cur = next;
  }

  // the head and the tail, one element a thread
  const Index tail = head + 4 * vectors;
  const Index scalars = head + (total - tail);
  for (Index i = static_cast<Index>(blockIdx.x) * THREADS + threadIdx.x;
       i < scalars; i += stride)
    op.scalar(i < head ? i : tail + (i - head));
}

// A launch of a streaming kernel the entry point may make: `head` (from
// kernels/spec.py int_split) leaves the vector body 16 B aligned for each
// of `ptrs` (or is the whole call), the block and thread counts are the
// compiled ones, and the grid is at least one block and at most one wave
// of `blocks_per_sm` an SM.  cudaSuccess, or the error to return.
inline cudaError_t stream_launch_ok(long long total, long long head,
                                    int blocks_per_sm, int threads, int grid,
                                    int compiled_blocks, int compiled_threads,
                                    std::initializer_list<const void*> ptrs) {
  if (total < 1 || head < 0 || head > total || threads != compiled_threads ||
      blocks_per_sm != compiled_blocks)
    return cudaErrorInvalidValue;
  if (head < total) {  // a vector body: 16 B aligned from `head` on
    const uintptr_t at = 4 * static_cast<uintptr_t>(head);
    uintptr_t bits = 0;
    for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p) + at;
    if (head > 3 || (bits & 15u)) return cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > sms * compiled_blocks)
    return cudaErrorInvalidConfiguration;
  return cudaSuccess;
}

}  // namespace rapid
