// K4: fused flash-decode attention with the RAPID combine divide.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/flash_attn.py
// (flash_decode_pallas, body _flash_kernel).
//
// What bounds it on an H100: device memory -- the bf16 K and V caches are
// read once per decode step; the exact f32 dots are a few flops per byte.
// At decode sizes (a few hundred live slots a row) the bytes take well
// under a microsecond, so what the design fights is latency: too few
// blocks, serial phases and dead work.
//
// Design.  The grid is (segments, rows), a row being one (batch, kv-head)
// pair and a segment a run of whole BC-slot chunks (geometry from
// kernels/spec.py, which the wrapper passes in and this file refuses if it
// did not compile it), so rows x segments blocks fill the SMs even at 32
// rows.  A block runs one warp per query g of its row:
//
//   * it reads its segment's slot positions once: one ballot per chunk
//     gives the chunk's live-slot mask (slot <= pos, inside the window,
//     INT32_MAX never), and a chunk with no live slot is skipped -- it
//     would leave (m, l, acc) as they were;
//   * live chunks are staged raw (bf16 or f32) with 16 B cp.async copies,
//     lane = slot, warps over the row's 16 B pieces, into a two-stage
//     ring: chunk c + 1 is in flight while chunk c is folded, and the
//     segment's chunk 0 while the slot positions are read.  Rows are
//     padded to an odd number of 16 B units, so the 8 lanes of each
//     quarter-warp hit 8 distinct 16 B bank groups;
//   * the fold of a chunk, warp g, lane s: the exact f32 dot q_g . k_s
//     summed over d in index order (--fmad=false and explicit _rn ops);
//     the chunk max by a butterfly of shuffles (order-free); p_s =
//     exp(s - m_new); the chunk's sum of p by the same butterfly (the
//     plain version sums by the same halving); acc[d] += p_s v_s[d] in
//     slot order, a pair of d a lane, p_s broadcast by shuffle;
//   * each block writes its (m, l, acc) to a workspace; the last block of
//     a row to finish (an atomic ticket after a __threadfence) combines
//     the row's segments in segment order, never in arrival order, as the
//     reference's sequence-sharded decode does (models/layers.py
//     shmap_body): m_g = max m_i, corr_i = isfinite(m_i) ? exp(m_i - m_g)
//     : 0, l_g = sum l_i corr_i, acc_g = sum acc_i corr_i; then
//     acc_g / max(l_g, floor) through rapid::log_div_f32, or an IEEE
//     divide for the exact arm.  It resets the ticket for the next launch.
//
// Fully masked rows give 0, not NaN.  The plain version
// (repro_torch/kernels/flash_attn/ops.py::flash_decode_plain) takes the
// same steps in the same order, so the two are bit-equal on the card; the
// combine reads the partials in index order, so the output is the same
// from run to run.
#include <cuda_bf16.h>
#include <stdint.h>

#include "rapid.cuh"

namespace {

constexpr int BC = 32;              // cache slots per chunk: one per lane
constexpr int MAX_SEG_CHUNKS = 32;  // chunks a segment: one bit each
constexpr int MAX_G = 16;           // queries per kv head: one warp each
constexpr int MAX_HD = 128;
constexpr int KP = MAX_HD / 64;     // head-dim pairs a lane owns at most
constexpr int PART = 4;             // m, l and two pad words before acc
constexpr int CU = 16;              // segments a combine round loads
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xFF800000u); }
__device__ __forceinline__ bool is_finite(float v) {
  return (__float_as_uint(v) & 0x7F800000u) != 0x7F800000u;
}
// torch.maximum / amax: NaN wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// elements d and d + 1 (d even) of a staged row, as f32
__device__ __forceinline__ void load2(const float* row, int d, float& a,
                                      float& b) {
  const float2 v = *reinterpret_cast<const float2*>(row + d);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* row, int d,
                                      float& a, float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + d);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}

// the elements of one 16 B piece as f32 (bf16 -> f32 is exact)
__device__ __forceinline__ void unpack(uint4 r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack(uint4 r, float* f, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

// Shared memory: the two-stage ring [stage][K, V][BC][stride16] of 16 B
// units (in the combine: [G][n_seg][2] weights), the row's queries
// [G][hd], the LUT, the live-slot masks.
__host__ __device__ size_t ring_bytes(int G, int hd, int esize, int n_seg) {
  const size_t ring = 16 * 4 * (size_t)BC * ((hd * esize / 16) | 1);
  const size_t weights =
      (sizeof(float) * 2 * (size_t)G * n_seg + 15) / 16 * 16;
  return ring > weights ? ring : weights;
}
__host__ __device__ size_t smem_bytes(int G, int hd, int esize,
                                      int n_seg) {
  return ring_bytes(G, hd, esize, n_seg) + sizeof(float) * (size_t)G * hd +
         sizeof(int32_t) * 256 + sizeof(uint32_t) * MAX_SEG_CHUNKS;
}

template <typename T>
__global__ void __launch_bounds__(MAX_G * 32)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int32_t* __restrict__ sp,
                    const int32_t* __restrict__ pos,
                    const int32_t* __restrict__ lut, float* __restrict__ work,
                    unsigned* __restrict__ tickets, float* __restrict__ out,
                    int C, int KV, int G, int hd, int window, int seg_chunks,
                    float floor) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16 B
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  const int n16 = hd / EPV;     // 16 B pieces of a cache row
  const int stride16 = n16 | 1;  // odd: conflict-free 16 B lane reads
  const int buf16 = BC * stride16;
  const int seg = blockIdx.x, n_seg = gridDim.x, row = blockIdx.y;
  uint4* ring = reinterpret_cast<uint4*>(smem);  // [2][K, V][BC][stride16]
  float* qs = reinterpret_cast<float*>(
      smem + ring_bytes(G, hd, sizeof(T), n_seg));           // [G][hd]
  int32_t* s_lut = reinterpret_cast<int32_t*>(qs + G * hd);  // [256]
  uint32_t* masks = reinterpret_cast<uint32_t*>(s_lut + 256);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;  // == G
  const int b = row / KV, h = row - b * KV;
  const int p = pos[b];
  const int lo = static_cast<int>(static_cast<uint32_t>(p) -
                                  static_cast<uint32_t>(window));
  const int ci0 = seg * seg_chunks;
  const int nch = min(seg_chunks, (C + BC - 1) / BC - ci0);

  // chunk ci of the segment into ring stage st: lane = slot, the warps
  // take the row's 16 B pieces in turn; slots past C are zero-filled
  auto stage = [&](int ci, int st) {
    const int slot = (ci0 + ci) * BC + lane;
    const bool in = slot < C;
    const size_t off = (((size_t)b * C + (in ? slot : 0)) * KV + h) * hd;
    const uint4* ksrc = reinterpret_cast<const uint4*>(kc + off);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vc + off);
    uint4* kd = ring + 2 * st * buf16 + lane * stride16;
    uint4* vd = kd + buf16;
    for (int j = warp; j < n16; j += nw) {
      rapid::cp_async16(kd + j, ksrc + j, in);
      rapid::cp_async16(vd + j, vsrc + j, in);
    }
  };

  // the segment's first chunk is staged before its mask is known: its
  // copies overlap the read of the slot positions
  stage(0, 0);
  rapid::cp_async_commit();

  // the segment's live slots, one mask a chunk (bit s = slot s)
  for (int ci = warp; ci < nch; ci += nw) {
    const int slot = (ci0 + ci) * BC + lane;
    bool ok = false;
    if (slot < C) {
      const int32_t v = sp[(size_t)b * C + slot];
      ok = v <= p && (!window || v > lo);
    }
    const unsigned m = __ballot_sync(FULL, ok);
    if (lane == 0) masks[ci] = m;
  }
  for (int i = t; i < G * hd; i += blockDim.x)
    qs[i] = q[(size_t)row * G * hd + i];
  __syncthreads();
  unsigned todo = __ballot_sync(FULL, lane < nch && masks[lane] != 0u);

  const int g = warp;
  const float* qg = qs + g * hd;
  float m = neg_inf(), l = 0.0f;
  float acc[KP][2];  // d = 2 (lane + 32 k) + e
#pragma unroll
  for (int k = 0; k < KP; ++k) acc[k][0] = acc[k][1] = 0.0f;

  int st = 0;
  if (todo && !(todo & 1u)) {
    // chunk 0 holds no live slot: the first live one goes to stage 1,
    // and stage 0 is refilled only after chunk 0's copies have landed
    stage(__ffs(todo) - 1, 1);
    st = 1;
  }
  rapid::cp_async_commit();
  if (st) rapid::cp_async_wait<1>();
  while (todo) {
    const int ci = __ffs(todo) - 1;
    todo &= todo - 1;
    if (todo) stage(__ffs(todo) - 1, st ^ 1);
    rapid::cp_async_commit();
    rapid::cp_async_wait<1>();  // chunk ci has landed
    __syncthreads();

    // scores: lane s, exact f32 dot over d in index order
    const uint4* krow = ring + 2 * st * buf16 + lane * stride16;
    float s = neg_inf();
    if ((masks[ci] >> lane) & 1u) {
      s = 0.0f;
      for (int j = 0; j < n16; ++j) {
        float kf[EPV];
        unpack(krow[j], kf, T());
        const float4* q4 = reinterpret_cast<const float4*>(qg + j * EPV);
#pragma unroll
        for (int e = 0; e < EPV / 4; ++e) {
          const float4 qv = q4[e];
          s = __fadd_rn(s, __fmul_rn(qv.x, kf[4 * e]));
          s = __fadd_rn(s, __fmul_rn(qv.y, kf[4 * e + 1]));
          s = __fadd_rn(s, __fmul_rn(qv.z, kf[4 * e + 2]));
          s = __fadd_rn(s, __fmul_rn(qv.w, kf[4 * e + 3]));
        }
      }
    }
    // online softmax step, every lane of the warp holding the same m, l
    float cmax = s;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      cmax = nan_max(cmax, __shfl_xor_sync(FULL, cmax, o));
    const float m_new = nan_max(m, cmax);
    const float pw = is_finite(m_new) ? expf(__fsub_rn(s, m_new)) : 0.0f;
    float sum = pw;
#pragma unroll
    for (int o = 16; o; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(FULL, sum, o));
    const float corr = is_finite(m) ? expf(__fsub_rn(m, m_new)) : 0.0f;
    l = __fadd_rn(__fmul_rn(l, corr), sum);
    m = m_new;

    // acc[d] = acc[d] * corr + sum_s p_s v_s[d], a pair of d a lane, s
    // in order
    const T* vbuf = reinterpret_cast<const T*>(ring + (2 * st + 1) * buf16);
    float pv[KP][2];
#pragma unroll
    for (int k = 0; k < KP; ++k) pv[k][0] = pv[k][1] = 0.0f;
    for (int j = 0; j < BC; ++j) {
      const float pj = __shfl_sync(FULL, pw, j);
      const T* vrow = vbuf + j * stride16 * EPV;
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        const int d = 2 * (lane + 32 * k);
        if (d < hd) {
          float v0, v1;
          load2(vrow, d, v0, v1);
          pv[k][0] = __fadd_rn(pv[k][0], __fmul_rn(pj, v0));
          pv[k][1] = __fadd_rn(pv[k][1], __fmul_rn(pj, v1));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[k][e] = __fadd_rn(__fmul_rn(acc[k][e], corr), pv[k][e]);
    __syncthreads();  // chunk ci consumed before its stage is refilled
    st ^= 1;
  }
  rapid::cp_async_wait<0>();  // a dead segment's staged chunk 0 included

  // this segment's partial, [row][seg][g][m, l, -, -, acc[hd]]
  const size_t part = (size_t)G * (hd + PART);
  float* mine = work + ((size_t)row * n_seg + seg) * part + g * (hd + PART);
  if (lane == 0) {
    mine[0] = m;
    mine[1] = l;
  }
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int d = 2 * (lane + 32 * k);
    if (d < hd) {
      mine[PART + d] = acc[k][0];
      mine[PART + d + 1] = acc[k][1];
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0) s_last = atomicAdd(&tickets[row], 1u) == (unsigned)(n_seg - 1);
  __syncthreads();
  if (!s_last) return;

  // the row's last block: combine the segments in index order.  Lanes
  // read the segments' (m, l) in parallel; corr_i and l_i corr_i go to
  // shared memory (the ring's room); lane d4 then folds acc_i[4 d4 ..]
  // over the segments, CU segments' loads in flight at a time
  __threadfence();
  if (lut)
    for (int i = t; i < 256; i += blockDim.x) s_lut[i] = lut[i];
  const float* rp = work + (size_t)row * n_seg * part + g * (hd + PART);
  float* ws = reinterpret_cast<float*>(smem) + 2 * g * n_seg;
  float m_g = neg_inf();
  for (int i = lane; i < n_seg; i += 32) {
    const float mi = __ldcg(rp + i * part);
    ws[2 * i] = mi;
    ws[2 * i + 1] = __ldcg(rp + i * part + 1);
    m_g = nan_max(m_g, mi);
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m_g = nan_max(m_g, __shfl_xor_sync(FULL, m_g, o));
  for (int i = lane; i < n_seg; i += 32) {
    const float mi = ws[2 * i];
    const float c = is_finite(mi) ? expf(__fsub_rn(mi, m_g)) : 0.0f;
    ws[2 * i + 1] = __fmul_rn(ws[2 * i + 1], c);
    ws[2 * i] = c;
  }
  __syncthreads();
  float l_g = 0.0f;
  for (int i = 0; i < n_seg; ++i) l_g = __fadd_rn(l_g, ws[2 * i + 1]);
  const bool mine4 = 4 * lane < hd;
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i0 = 0; i0 < n_seg; i0 += CU) {
    float4 v[CU];
#pragma unroll
    for (int u = 0; u < CU; ++u)
      if (mine4 && i0 + u < n_seg)
        v[u] = __ldcg(reinterpret_cast<const float4*>(
                          rp + (size_t)(i0 + u) * part + PART) + lane);
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      if (i0 + u < n_seg) {
        const float c = ws[2 * (i0 + u)];
        a.x = __fadd_rn(a.x, __fmul_rn(v[u].x, c));
        a.y = __fadd_rn(a.y, __fmul_rn(v[u].y, c));
        a.z = __fadd_rn(a.z, __fmul_rn(v[u].z, c));
        a.w = __fadd_rn(a.w, __fmul_rn(v[u].w, c));
      }
    }
  }
  const float den = l_g < floor ? floor : l_g;
  if (mine4) {
    const float av[4] = {a.x, a.y, a.z, a.w};
    float* o = out + ((size_t)row * G + g) * hd + 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = lut ? rapid::log_div_f32(av[e], den, s_lut)
                 : __fdiv_rn(av[e], den);
  }
  if (t == 0) tickets[row] = 0u;
}

template <typename T>
cudaError_t launch(const float* q, const void* kc, const void* vc,
                   const int32_t* sp, const int32_t* pos, const int32_t* lut,
                   float* work, unsigned* tickets, float* out, int rows, int C,
                   int KV, int G, int hd, int window, int seg_chunks,
                   float floor, cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int n_seg = ((C + BC - 1) / BC + seg_chunks - 1) / seg_chunks;
  const int smem = static_cast<int>(smem_bytes(G, hd, sizeof(T), n_seg));
  const cudaError_t err =
      rapid::allow_dynamic_smem(flash_decode_kernel<T>, smem, granted);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T><<<dim3(n_seg, rows), 32 * G, smem, stream>>>(
      q, static_cast<const T*>(kc), static_cast<const T*>(vc), sp, pos, lut,
      work, tickets, out, C, KV, G, hd, window, seg_chunks, floor);
  return cudaGetLastError();
}

}  // namespace

// The geometry this file compiles, for kernels/spec.py's FLASH_CHUNK and
// FLASH_MAX_SEGMENT_CHUNKS, which the wrapper checks at its first launch.
extern "C" int rapid_flash_decode_geometry(int* chunk, int* max_seg_chunks) {
  *chunk = BC;
  *max_seg_chunks = MAX_SEG_CHUNKS;
  return 0;
}

// rows = B * KV; bk: the chunk (must be BC); bn: the segment in slots (a
// multiple of BC, at most MAX_SEG_CHUNKS chunks).  work: rows x segments x
// G x (hd + 4) f32, 16 B aligned; tickets: rows zeroed uint32, left
// zeroed.  cache_bf16: 1 for bf16 caches, 0 for f32.  Anything else is
// refused with cudaErrorInvalidValue before a launch.
extern "C" int rapid_flash_decode(const void* q, const void* k_cache,
                                  const void* v_cache, const void* slot_pos,
                                  const void* pos, const void* lut, void* work,
                                  void* tickets, void* out, int rows, int C,
                                  int KV, int G, int hd, int window, int bk,
                                  int bn, float floor, int cache_bf16,
                                  void* stream) {
  const int esize = cache_bf16 ? 2 : 4;
  if (bk != BC || bn < BC || bn % BC || bn / BC > MAX_SEG_CHUNKS || rows < 1 ||
      C < 1 || KV < 1 || G < 1 || G > MAX_G || hd < 1 || hd > MAX_HD ||
      (hd * esize) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qp = static_cast<const float*>(q);
  const auto* spp = static_cast<const int32_t*>(slot_pos);
  const auto* pp = static_cast<const int32_t*>(pos);
  const auto* lp = static_cast<const int32_t*>(lut);
  auto* wp = static_cast<float*>(work);
  auto* tp = static_cast<unsigned*>(tickets);
  auto* op = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (cache_bf16)
    return launch<__nv_bfloat16>(qp, k_cache, v_cache, spp, pp, lp, wp, tp, op,
                                 rows, C, KV, G, hd, window, bn / BC, floor,
                                 st);
  return launch<float>(qp, k_cache, v_cache, spp, pp, lp, wp, tp, op, rows, C,
                       KV, G, hd, window, bn / BC, floor, st);
}
