// K4: fused flash-decode attention with the RAPID combine divide.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/flash_attn.py
// (flash_decode_pallas, body _flash_kernel).
//
// What bounds it on an H100: device memory -- the bf16 K and V caches are
// read once per decode step; the exact f32 dots are a few flops per byte.
//
// Design: one CTA per (batch, kv-head) row holds the G queries of that
// row in shared memory and walks the cache in BC-slot chunks: stage the
// chunk's K and V (read straight from the bf16 or f32 cache; bf16 -> f32
// is exact, so the reference's f32 copy is not needed), mask by slot
// position (slot <= pos, the sliding window when set, INT32_MAX for empty
// or pad slots), take exact f32 q.k dots (no TF32, no FMA: --fmad=false),
// and fold the chunk into the online (m, l, acc) state.  The finish is
// acc / max(l, floor) through rapid::log_div_f32, or an IEEE divide for
// the exact arm.  Fully masked rows give 0, not NaN.  The plain version
// (repro_torch/kernels/flash_attn/ops.py::flash_decode_plain) takes the
// same steps in the same order -- BC-slot chunks, dots and sums in index
// order, one rounding per op -- so the two are bit-equal on the card;
// against the reference's one-max oracle they agree to tight allclose.
#include <cuda_bf16.h>

#include "rapid.cuh"

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int BC = 32;   // cache slots per chunk

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }
__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & 0x7F800000u) != 0x7F800000u;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int32_t* __restrict__ sp,
                    const int32_t* __restrict__ pos,
                    const int32_t* __restrict__ lut, float* __restrict__ out,
                    int C, int KV, int G, int hd, int window, float floor) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [G][hd]
  float* ks = qs + G * hd;          // [BC][hd]
  float* vs = ks + BC * hd;         // [BC][hd]
  float* ps = vs + BC * hd;         // [G][BC] scores, then weights
  float* acc = ps + G * BC;         // [G][hd]
  float* m = acc + G * hd;          // [G]
  float* l = m + G;                 // [G]
  float* corr = l + G;              // [G]
  int32_t* valid = reinterpret_cast<int32_t*>(corr + G);  // [BC]
  int32_t* s_lut = valid + BC;      // [256]

  const int t = threadIdx.x;
  const int row = blockIdx.x;  // = b * KV + h
  const int b = row / KV, h = row % KV;
  const int p = pos[b];

  for (int i = t; i < G * hd; i += NT) {
    qs[i] = q[(size_t)row * G * hd + i];
    acc[i] = 0.0f;
  }
  for (int g = t; g < G; g += NT) {
    m[g] = neg_inf();
    l[g] = 0.0f;
  }
  if (lut)
    for (int i = t; i < 256; i += NT) s_lut[i] = lut[i];

  for (int c0 = 0; c0 < C; c0 += BC) {
    __syncthreads();  // the previous chunk is consumed
    for (int e = t; e < BC * hd; e += NT) {
      const int s = e / hd, d = e % hd, gs = c0 + s;
      const size_t off = (((size_t)b * C + gs) * KV + h) * hd + d;
      ks[e] = gs < C ? to_f32(kc[off]) : 0.0f;
      vs[e] = gs < C ? to_f32(vc[off]) : 0.0f;
    }
    for (int s = t; s < BC; s += NT) {
      const int gs = c0 + s;
      bool ok = false;
      if (gs < C) {
        const int32_t slot = sp[(size_t)b * C + gs];
        ok = slot <= p;
        if (window) ok = ok && slot > p - window;
      }
      valid[s] = ok;
    }
    __syncthreads();
    for (int e = t; e < G * BC; e += NT) {
      const int g = e / BC, s = e % BC;
      float dot = neg_inf();
      if (valid[s]) {
        dot = 0.0f;
        for (int d = 0; d < hd; ++d) dot += qs[g * hd + d] * ks[s * hd + d];
      }
      ps[e] = dot;
    }
    __syncthreads();
    for (int g = t; g < G; g += NT) {
      float cmax = neg_inf();
      for (int s = 0; s < BC; ++s) cmax = fmaxf(cmax, ps[g * BC + s]);
      const float m_old = m[g];
      const float m_new = fmaxf(m_old, cmax);
      const bool live = is_finite(m_new);
      float sum = 0.0f;
      for (int s = 0; s < BC; ++s) {
        const float pv = live ? expf(ps[g * BC + s] - m_new) : 0.0f;
        ps[g * BC + s] = pv;
        sum += pv;
      }
      const float cr = is_finite(m_old) ? expf(m_old - m_new) : 0.0f;
      l[g] = l[g] * cr + sum;
      m[g] = m_new;
      corr[g] = cr;
    }
    __syncthreads();
    for (int e = t; e < G * hd; e += NT) {
      const int g = e / hd, d = e % hd;
      float pv = 0.0f;
      for (int s = 0; s < BC; ++s) pv += ps[g * BC + s] * vs[s * hd + d];
      acc[e] = acc[e] * corr[g] + pv;
    }
  }
  __syncthreads();
  for (int e = t; e < G * hd; e += NT) {
    const float lg = l[e / hd];
    const float den = lg < floor ? floor : lg;
    out[(size_t)row * G * hd + e] =
        lut ? rapid::log_div_f32(acc[e], den, s_lut) : __fdiv_rn(acc[e], den);
  }
}

size_t smem_bytes(int G, int hd) {
  return sizeof(float) * (2 * G * hd + 2 * BC * hd + G * BC + 3 * G) +
         sizeof(int32_t) * (BC + 256);
}

template <typename T>
cudaError_t launch(const float* q, const void* kc, const void* vc,
                   const int32_t* sp, const int32_t* pos, const int32_t* lut,
                   float* out, int rows, int C, int KV, int G, int hd,
                   int window, float floor, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  flash_decode_kernel<T><<<rows, NT, smem, stream>>>(
      q, static_cast<const T*>(kc), static_cast<const T*>(vc), sp, pos, lut,
      out, C, KV, G, hd, window, floor);
  return cudaGetLastError();
}

}  // namespace

// cache_bf16: 1 for bf16 caches, 0 for f32.  rows = B * KV.
// BC, for the plain version's CHUNK (flash_attn/ops.py), which must equal
// it for the two to be bit-equal; the wrapper checks at its first launch.
extern "C" int rapid_flash_decode_chunk() { return BC; }

extern "C" int rapid_flash_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const void* slot_pos,
                                  const void* pos, const void* lut, void* out,
                                  int rows, int C, int KV, int G, int hd,
                                  int window, float floor, int cache_bf16,
                                  void* stream) {
  const auto* qp = static_cast<const float*>(q);
  const auto* spp = static_cast<const int32_t*>(slot_pos);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* lp = static_cast<const int32_t*>(lut);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (cache_bf16)
    return launch<__nv_bfloat16>(qp, k_cache, v_cache, spp, pp, lp, op, rows,
                                 C, KV, G, hd, window, floor, st);
  return launch<float>(qp, k_cache, v_cache, spp, pp, lp, op, rows, C, KV, G,
                       hd, window, floor, st);
}
