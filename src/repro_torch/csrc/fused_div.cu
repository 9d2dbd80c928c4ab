// K2 / K3: fused row divide -- rms normalize and softmax combine.
// K5 / K6: RAPID divide with a per-row denominator, and elementwise.
// K8: K2 / K3 / K5 over row slabs with DEPTH slabs in flight.
//
// Replaces the Pallas TPU kernels src/repro/kernels/fused_div/fused_div.py
// rms_div_pallas (K2), softmax_div_pallas (K3), div_rowbcast_pallas (K5)
// and div_pallas (K6), with their _rowwise_call plumbing, and, as the
// stage count of K2 / K3 / K5, _rowwise_pipelined_call /
// _rowwise_pipelined_kernel (K8).  K8 comes first below, K2 / K3 (depth
// 1) after it: they share its device helpers.
//
// Every row sum takes the grouping of the plain version
// (repro_torch/kernels/fused_div/ref.py::lane_sum): grouping lane t sums
// elements t, t + 128, ... in order, its chain starting at +0 (as the
// reference's sum starts: a row of -0 sums to +0), then the 128 partial
// sums fold by halving.  So each denominator, and with it every
// quotient, is bit-equal to the plain version.  The rms denominator keeps the
// reference's canonical form sqrt((ss + n*eps) * (1/n)) with both
// constants folded to f32 by the caller; every op is an explicit
// round-to-nearest intrinsic.  The divide is rapid::log_div_f32 (or an
// IEEE divide when no LUT is given).  An optional output receives each
// row's denominator, so a check can hold the quotients against the plain
// divide fed the kernel's own denominator.
#include "rapid.cuh"

namespace {

constexpr int LANE = rapid::LANE;

cudaError_t launch_slabs(int op, int depth, int warps, int grid,
                         const float* x, const float* b, float* out,
                         float* denom_out, const int32_t* lut, int rows,
                         int n, int bm, float c_add, float c_mul, float floor,
                         cudaStream_t stream);
cudaError_t launch_rows(int op, int warps, int grid, const float* x,
                        float* out, float* denom_out, const int32_t* lut,
                        int rows, int n, int bm, float c_add, float c_mul,
                        float floor, cudaStream_t stream);

}  // namespace

// depth 1: K2 / K3, rows held in registers; depth >= 2: K8, slabs of bm
// rows.  Either way rows a slab, warps a row and the grid come from
// kernels/spec.py::row_geometry.
extern "C" int rapid_rms_div(const void* x, void* out, void* denom_out,
                             const void* lut, int rows, int n, int depth,
                             int bm, int warps, int grid,
                             float c_add, float c_mul, void* stream) {
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  auto* dp = static_cast<float*>(denom_out);
  const auto* lp = static_cast<const int32_t*>(lut);
  const auto st = static_cast<cudaStream_t>(stream);
  return depth > 1 ? launch_slabs(0, depth, warps, grid, xp, nullptr, op, dp,
                                  lp, rows, n, bm, c_add, c_mul, 0.0f, st)
                   : launch_rows(0, warps, grid, xp, op, dp, lp, rows, n, bm,
                                 c_add, c_mul, 0.0f, st);
}

extern "C" int rapid_softmax_div(const void* e, void* out, void* denom_out,
                                 const void* lut, int rows, int n, int depth,
                                 int bm, int warps, int grid,
                                 float floor, void* stream) {
  const auto* ep = static_cast<const float*>(e);
  auto* op = static_cast<float*>(out);
  auto* dp = static_cast<float*>(denom_out);
  const auto* lp = static_cast<const int32_t*>(lut);
  const auto st = static_cast<cudaStream_t>(stream);
  return depth > 1 ? launch_slabs(1, depth, warps, grid, ep, nullptr, op, dp,
                                  lp, rows, n, bm, 0.0f, 0.0f, floor, st)
                   : launch_rows(1, warps, grid, ep, op, dp, lp, rows, n, bm,
                                 0.0f, 0.0f, floor, st);
}

// ---------------------------------------------------------------------------
// K5 / K6: out = log_div_f32(a, b) elementwise, as a 16 B stream.
//
// Replaces div_pallas (K6: a / b on operands of one shape) and, at its
// depth 1, div_rowbcast_pallas (K5: a [rows, n] / b [rows], the
// online-softmax combine acc / l) of src/repro/kernels/fused_div/fused_div.py.
//
// What bounds them on an H100: device memory.  K6 reads two f32 operands
// and writes one f32 result, 12 B an element (2048 x 2048: 50.3 MB, 15.0 us
// at 3.35 TB/s); K5 reads a and writes out, 8 B an element, and 4 B a row
// of b (266240 x 80: 171 MB, 51.2 us).  A divide is ~20 int32 ops, under
// the bytes across the card, but only while the loads stay in flight as
// the divides run.
//
// Design: K9 / K10's stream (csrc/rapid_int.cu; PERF.md, PR 20), through
// the walk the four share (rapid::stream_walk):
// * float4 loads of a (and K6's b), float4 stores; a grid-stride walk, the
//   next round's vectors loaded before this round's divides, the first
//   round's issued before the LUT is staged;
// * geometry from kernels/spec.py (int_split, int_geometry; K5's through
//   row_geometry at depth 1): DIV_THREADS a block, a grid of one wave at
//   the blocks an SM the launch bounds promise (or fewer, a vector a
//   thread), a head and a tail of single elements where a, out (and K6's
//   b) share their offset mod 16 B, one element a thread for the whole
//   call where they do not.  The entry points refuse a block or thread
//   count they did not compile, a grid past one wave and a head that
//   leaves the vector body misaligned;
// * K5's row: element i lies in row i / n, found with no hardware divide
//   as umulhi(2 i, magic) >> shift, the wrapper's pair for n
//   (kernels/fused_div/ops.py::row_magic: exact for every i < 2^31 and
//   every n; the entry point checks it at n - 1, n and the last element).
//   Where n % 4 == 0 and the vector body starts at element 0 a vector lies
//   in one row, found once a vector (every n the paths use is 80);
//   otherwise once an element.  b[row] is read through the read-only
//   path: neighbouring threads share it.
// The divide is rapid::log_div_f32, the function K2-K4 share, so every
// quotient is bit-equal to float_approx.log_div_f32 on the same operands.
namespace {

constexpr int DIV_THREADS = 256;
static_assert(DIV_THREADS == 256, "the LUT is staged one cell a thread");
// the resident blocks an SM the launch bounds promise (64 registers a
// thread; kernels/budget.py INT_BLOCKS_PER_SM, as K9 / K10)
constexpr int DIV_BLOCKS_PER_SM = 4;

// where a quotient's denominator comes from: K6 reads b elementwise; K5
// reads b[row], the row found once a vector or once an element
enum DivOperand { ELEMENTWISE = 0, ROW_A_VECTOR = 1, ROW_AN_ELEMENT = 2 };

// i / n for i < 2^31: umulhi(2 i, magic) >> shift
struct RowMagic {
  uint32_t magic, shift;
};

__host__ __device__ __forceinline__ uint32_t row_of(uint32_t i, RowMagic m) {
#ifdef __CUDA_ARCH__
  return __umulhi(i << 1, m.magic) >> m.shift;
#else
  return static_cast<uint32_t>(
             (static_cast<unsigned long long>(i << 1) * m.magic) >> 32) >>
         m.shift;
#endif
}

// One vector of four elements, for rapid::stream_walk: a, out (and K6's
// b) from `head` on, 16 B aligned; the LUT staged one cell a thread.
template <int B>
struct DivStream {
  struct Vec {
    float4 a, b;  // K5, a row a vector: b.x alone
  };
  const float* a;
  const float* b;
  float* out;
  const int32_t* lut;
  uint32_t head;
  RowMagic m;
  int32_t* s_lut;

  __device__ __forceinline__ float den(uint32_t e) const {
    return __ldg(b + row_of(e, m));
  }
  __device__ __forceinline__ Vec load(uint32_t v) const {
    Vec x;
    x.a = reinterpret_cast<const float4*>(a + head)[v];
    if constexpr (B == ELEMENTWISE) {
      x.b = reinterpret_cast<const float4*>(b + head)[v];
    } else if constexpr (B == ROW_A_VECTOR) {  // head 0, n % 4 == 0
      x.b.x = den(4 * v);
    } else {
      const uint32_t e = head + 4 * v;
      x.b = make_float4(den(e), den(e + 1), den(e + 2), den(e + 3));
    }
    return x;
  }
  __device__ __forceinline__ void stage() const {
    s_lut[threadIdx.x] = lut[threadIdx.x];
  }
  __device__ __forceinline__ void store(uint32_t v, const Vec& x) const {
    const float4 d = B == ROW_A_VECTOR
                         ? make_float4(x.b.x, x.b.x, x.b.x, x.b.x)
                         : x.b;
    reinterpret_cast<float4*>(out + head)[v] = make_float4(
        rapid::log_div_f32(x.a.x, d.x, s_lut),
        rapid::log_div_f32(x.a.y, d.y, s_lut),
        rapid::log_div_f32(x.a.z, d.z, s_lut),
        rapid::log_div_f32(x.a.w, d.w, s_lut));
  }
  __device__ __forceinline__ void scalar(uint32_t e) const {
    out[e] = rapid::log_div_f32(a[e], B == ELEMENTWISE ? b[e] : den(e),
                                s_lut);
  }
};

template <int B>
__global__ void __launch_bounds__(DIV_THREADS, DIV_BLOCKS_PER_SM)
elementwise_div_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       const int32_t* __restrict__ lut, uint32_t total,
                       uint32_t head, RowMagic m) {
  __shared__ int32_t s_lut[256];
  DivStream<B> op{a, b, out, lut, head, m, s_lut};
  rapid::stream_walk<DIV_THREADS>(total, head, op);
}

cudaError_t launch_div(int operand, const void* a, const void* b, void* out,
                       const void* lut, long long total, long long head,
                       RowMagic m, int blocks_per_sm, int threads, int grid,
                       void* stream) {
  if (total >= (1ll << 31)) return cudaErrorInvalidValue;
  const cudaError_t err = rapid::stream_launch_ok(
      total, head, blocks_per_sm, threads, grid, DIV_BLOCKS_PER_SM,
      DIV_THREADS, {a, operand == ELEMENTWISE ? b : a, out});  // K5: no b
  if (err != cudaSuccess) return err;
  const auto* pa = static_cast<const float*>(a);
  const auto* pb = static_cast<const float*>(b);
  auto* po = static_cast<float*>(out);
  const auto* pl = static_cast<const int32_t*>(lut);
  const auto t = static_cast<uint32_t>(total), h = static_cast<uint32_t>(head);
  const auto s = static_cast<cudaStream_t>(stream);
  if (operand == ELEMENTWISE)
    elementwise_div_kernel<ELEMENTWISE>
        <<<grid, DIV_THREADS, 0, s>>>(pa, pb, po, pl, t, h, m);
  else if (operand == ROW_A_VECTOR)
    elementwise_div_kernel<ROW_A_VECTOR>
        <<<grid, DIV_THREADS, 0, s>>>(pa, pb, po, pl, t, h, m);
  else
    elementwise_div_kernel<ROW_AN_ELEMENT>
        <<<grid, DIV_THREADS, 0, s>>>(pa, pb, po, pl, t, h, m);
  return cudaGetLastError();
}

}  // namespace

// K8: a [rows, n] / b [rows] (one denominator per row) at depth >= 2,
// slabs of bm rows walked flat (warps 0); rows * n < 2^31.
extern "C" int rapid_div_rowbcast(const void* a, const void* b, void* out,
                                  const void* lut, int rows, int n, int depth,
                                  int bm, int warps, int grid,
                                  void* stream) {
  return launch_slabs(2, depth, warps, grid, static_cast<const float*>(a),
                      static_cast<const float*>(b), static_cast<float*>(out),
                      nullptr, static_cast<const int32_t*>(lut), rows, n, bm,
                      0.0f, 0.0f, 0.0f, static_cast<cudaStream_t>(stream));
}

// K5: a [rows, n] / b [rows] at depth 1, rows * n < 2^31; head,
// blocks_per_sm, threads and grid from kernels/spec.py::row_geometry,
// (magic, shift) = kernels/fused_div/ops.py::row_magic(n).
extern "C" int rapid_div_rowbcast_stream(const void* a, const void* b,
                                         void* out, const void* lut,
                                         int rows, int n, long long head,
                                         unsigned magic, unsigned shift,
                                         int blocks_per_sm, int threads,
                                         int grid, void* stream) {
  const long long total = static_cast<long long>(rows) * n;
  const RowMagic m{magic, shift};
  if (rows < 1 || n < 1 || total >= (1ll << 31) || shift > 31 ||
      row_of(static_cast<uint32_t>(n - 1), m) != 0 ||
      row_of(static_cast<uint32_t>(n), m) != 1 ||
      row_of(static_cast<uint32_t>(total - 1), m) !=
          static_cast<uint32_t>(rows - 1))
    return cudaErrorInvalidValue;
  const int operand = n % 4 == 0 && head == 0 ? ROW_A_VECTOR : ROW_AN_ELEMENT;
  return launch_div(operand, a, b, out, lut, total, head, m, blocks_per_sm,
                    threads, grid, stream);
}

// K6: a [total] / b [total], total < 2^31; head, blocks_per_sm, threads
// and grid from kernels/spec.py (int_split, int_geometry).
extern "C" int rapid_div(const void* a, const void* b, void* out,
                         const void* lut, long long total, long long head,
                         int blocks_per_sm, int threads, int grid,
                         void* stream) {
  return launch_div(ELEMENTWISE, a, b, out, lut, total, head, RowMagic{0, 0},
                    blocks_per_sm, threads, grid, stream);
}

// ---------------------------------------------------------------------------
// K8: K2 / K3 / K5 with DEPTH row slabs in flight.
//
// Replaces _rowwise_pipelined_call / _rowwise_pipelined_kernel of
// src/repro/kernels/fused_div/fused_div.py (the depth >= 2 form of
// rms_div_pallas, softmax_div_pallas and div_rowbcast_pallas).
//
// What bounds it on an H100: device memory, as K2 / K3 / K5 -- each row
// read once (into shared memory) and written once.  At the few rows of a
// decode step it is latency: one row's loads, its sum and its divides in
// a chain, so what counts there is how many threads share a row and how
// many SMs the rows land on.
//
// Design: blocks of ROW_WARPS warps; the geometry, grid included, comes
// from kernels/spec.py::row_geometry, and a warp count this file did not
// compile for the op, an empty slab, or a grid past the slabs or past
// one wave the card holds at once, is refused before the launch.
//
// * The grid: one block a slab of bm rows, up to one wave (the SMs x
//   the blocks an SM holds).  Where the slabs outnumber the wave, block
//   g walks slabs g, g + gridDim.x, ... with the next DEPTH-1 of its own
//   in flight by cp.async into a ring of DEPTH slabs in dynamic shared
//   memory (16 B copies where x and out are 16 B aligned and n % 4 == 0,
//   so every slab starts aligned; 4 B copies for the rest).  Slab i is
//   waited for with cp.async.wait_group(DEPTH-2) and a barrier; slab
//   i+DEPTH-1 is then issued into the slot slab i-1 left.  A block with
//   a single slab issues all of its loads at once and waits once; the
//   LUT rides in slab 0's group, so it costs no round trip of its own,
//   and the divide (LUT or IEEE) is a template parameter, not a branch.
// * Wide rows (WARPS = ROW_WARPS: rms / softmax rows from ROW_WIDE_N
//   elements, and narrower ones where the rows, a block each, fit one
//   wave): the block's 128 threads share a row, thread t as grouping
//   lane t, summing elements t, t+128, ... in order; the steps h = 64
//   and h = 32 cross warps through one of two fold buffers in shared
//   memory (the rows alternate, so one barrier a row), h = 16 .. 1 are
//   shuffles, every warp folding the same partials.  The divides then take the row 16 B a thread.
// * Narrow rows (WARPS = 1, where they outnumber a wave of blocks; fewer
//   take the wide form): a warp a row; lane l holds grouping lanes
//   l, l+32, l+64 and l+96, their four chains advanced side by side one
//   round of 128 at a time, folded as the steps h = 64 and h = 32 do,
//   then h = 16 .. 1 by shuffles.
// * The row broadcast (OP 2, WARPS = 0) has no sum: its threads walk the
//   slab flat, 16 B each, and find the row as index / n; the slab's
//   denominators ride in the same cp.async group, so no load of b waits
//   behind the slab.
//
// Either way each denominator is bit-equal to the plain version's
// lane_sum, and so is every quotient.  The stores are plain global
// stores: they drain while the next slab loads, which is what the
// reference's out-DMA ring arranges by hand.
namespace {

constexpr int ROW_WARPS = 4;
constexpr int ROW_THREADS = ROW_WARPS * 32;
// blocks an SM must hold at once (kernels/budget.py ROW_BLOCKS_PER_SM):
// the launch bounds keep a thread within 64 registers
constexpr int ROW_BLOCKS_PER_SM = 8;

template <bool RAPID>
__device__ __forceinline__ float row_quotient(float v, float d,
                                              const int32_t* s_lut) {
  if constexpr (RAPID) return rapid::log_div_f32(v, d, s_lut);
  return __fdiv_rn(v, d);
}

template <bool RAPID>
__device__ __forceinline__ float4 row_quotient4(float4 v, float d,
                                                const int32_t* s_lut) {
  return make_float4(row_quotient<RAPID>(v.x, d, s_lut),
                     row_quotient<RAPID>(v.y, d, s_lut),
                     row_quotient<RAPID>(v.z, d, s_lut),
                     row_quotient<RAPID>(v.w, d, s_lut));
}

// the steps h = 16 .. 1 of the fold; every lane gets lane 0's sum
__device__ __forceinline__ float warp_fold(float s) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
    s = __fadd_rn(s, __shfl_down_sync(0xFFFFFFFFu, s, h));
  return __shfl_sync(0xFFFFFFFFu, s, 0);
}

template <int OP>
__device__ __forceinline__ float row_denom(float s, float c_add,
                                           float c_mul, float floor) {
  // softmax: max(sum, floor) with NaN propagating, as torch.maximum
  return OP == 0 ? __fsqrt_rn(__fmul_rn(__fadd_rn(s, c_add), c_mul))
                 : (s < floor ? floor : s);
}

template <int OP>
__device__ __forceinline__ float row_term(float v) {
  return OP == 0 ? __fmul_rn(v, v) : v;
}

// the 256-entry LUT into shared memory by cp.async, 16 B a copy where
// it is 16 B aligned; the caller commits the group
__device__ __forceinline__ void stage_lut(int32_t* s_lut, const int32_t* lut,
                                          int tid) {
  if ((reinterpret_cast<uintptr_t>(lut) & 15u) == 0) {
    if (tid < 64) rapid::cp_async16(s_lut + 4 * tid, lut + 4 * tid, true);
  } else {
    for (int i = tid; i < 256; i += ROW_THREADS)
      rapid::cp_async4(s_lut + i, lut + i, true);
  }
}

// OP 0: rms, 1: softmax, 2: row broadcast; RAPID: the LUT divide (else
// an IEEE one)
template <int OP, int DEPTH, int WARPS, bool RAPID>
__global__ void __launch_bounds__(ROW_THREADS, ROW_BLOCKS_PER_SM)
row_slab_kernel(const float* __restrict__ x, const float* __restrict__ b,
                float* __restrict__ out, float* __restrict__ denom_out,
                const int32_t* __restrict__ lut, int rows, int n, int bm,
                float c_add, float c_mul, float floor, bool vec) {
  static_assert(OP == 2 ? WARPS == 0 : (WARPS == 1 || WARPS == ROW_WARPS),
                "rms / softmax rows take 1 or ROW_WARPS warps, the row "
                "broadcast none");
  __shared__ __align__(16) int32_t s_lut[256];
  // [two fold buffers of LANE partials where the warps share a row]
  // [ring of DEPTH slabs][the row broadcast's DEPTH x bm denominators]
  extern __shared__ __align__(16) float smem[];
  constexpr int FOLD = WARPS == ROW_WARPS ? 2 * LANE : 0;
  float* ring = smem + FOLD;
  const int tid = threadIdx.x, lane = tid & 31;
  const int nslabs = (rows + bm - 1) / bm;
  const int mine = (nslabs - 1 - static_cast<int>(blockIdx.x)) /
                       static_cast<int>(gridDim.x) + 1;
  const int slab = bm * n;
  float* denoms = ring + DEPTH * slab;

  // rows of this block's i-th slab: [first, first + count)
  auto slab_rows = [&](int i, long long& first) {
    first = (static_cast<long long>(blockIdx.x) +
             static_cast<long long>(i) * gridDim.x) * bm;
    const long long left = rows - first;
    return static_cast<int>(left < bm ? left : bm);
  };
  // the i-th slab of this block into ring slot i % DEPTH (with its
  // denominators, for the row broadcast)
  auto issue = [&](int i) {
    long long r0;
    const int nr = slab_rows(i, r0), len = nr * n;
    if constexpr (OP == 2)
      for (int r = tid; r < nr; r += ROW_THREADS)
        rapid::cp_async4(denoms + (i % DEPTH) * bm + r, b + r0 + r, true);
    const float* src = x + r0 * n;
    float* dst = ring + (i % DEPTH) * slab;
    if (vec) {  // n % 4 == 0, so len is whole 16 B copies
      for (int c = tid; c < len / 4; c += ROW_THREADS)
        rapid::cp_async16(dst + 4 * c, src + 4 * c, true);
    } else {
      for (int e = tid; e < len; e += ROW_THREADS)
        rapid::cp_async4(dst + e, src + e, true);
    }
  };

  // the LUT lands with slab 0, in its group
  if constexpr (RAPID) stage_lut(s_lut, lut, tid);
  for (int i = 0; i < DEPTH - 1; ++i) {
    if (i < mine) issue(i);
    rapid::cp_async_commit();
  }
  for (int i = 0; i < mine; ++i) {
    rapid::cp_async_wait<DEPTH - 2>();  // slab i has landed
    // slab i (and the LUT) is visible to every warp, and every warp is
    // done with slab i-1, whose slot the next issue reuses
    __syncthreads();
    if (i + DEPTH - 1 < mine) issue(i + DEPTH - 1);
    rapid::cp_async_commit();
    long long r0;
    const int nr = slab_rows(i, r0);
    const float* sl = ring + (i % DEPTH) * slab;
    if constexpr (WARPS == 0) {  // the flat walk: 16 B a thread
      const int len = nr * n;
      const float* bs = denoms + (i % DEPTH) * bm;
      float* o = out + r0 * n;
      if (vec) {  // a 16 B chunk lies in one row
        for (int c = tid; c < len / 4; c += ROW_THREADS) {
          const float4 v = reinterpret_cast<const float4*>(sl)[c];
          reinterpret_cast<float4*>(o)[c] =
              row_quotient4<RAPID>(v, bs[4 * c / n], s_lut);
        }
      } else {
        for (int e = tid; e < len; e += ROW_THREADS)
          o[e] = row_quotient<RAPID>(sl[e], bs[e / n], s_lut);
      }
    } else if constexpr (WARPS == 1) {  // a warp a row
      for (int r = tid >> 5; r < nr; r += ROW_WARPS) {
        const float* xr = sl + r * n;
        float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, p3 = 0.0f;
        for (int j = lane; j < n; j += LANE) {  // one round of 128
          p0 = __fadd_rn(p0, row_term<OP>(xr[j]));
          if (j + 32 < n) p1 = __fadd_rn(p1, row_term<OP>(xr[j + 32]));
          if (j + 64 < n) p2 = __fadd_rn(p2, row_term<OP>(xr[j + 64]));
          if (j + 96 < n) p3 = __fadd_rn(p3, row_term<OP>(xr[j + 96]));
        }
        // h = 64 (l += l + 64, l + 32 += l + 96), then h = 32
        const float s = warp_fold(__fadd_rn(__fadd_rn(p0, p2),
                                            __fadd_rn(p1, p3)));
        const float d = row_denom<OP>(s, c_add, c_mul, floor);
        const long long row = r0 + r;
        if (denom_out && lane == 0) denom_out[row] = d;
        float* orow = out + row * n;
        if (vec) {
          for (int c = lane; c < n / 4; c += 32)
            reinterpret_cast<float4*>(orow)[c] = row_quotient4<RAPID>(
                reinterpret_cast<const float4*>(xr)[c], d, s_lut);
        } else {
          for (int j = lane; j < n; j += 32)
            orow[j] = row_quotient<RAPID>(xr[j], d, s_lut);
        }
      }
    } else {  // the block's four warps on one row
      for (int r = 0; r < nr; ++r) {
        const float* xr = sl + r * n;
        float p = 0.0f;
        for (int j = tid; j < n; j += LANE)
          p = __fadd_rn(p, row_term<OP>(xr[j]));
        float* fold = smem + (r & 1) * LANE;
        fold[tid] = p;
        __syncthreads();
        // h = 64, then h = 32: every warp folds the same partials, and
        // the next row writes the other buffer, so no second barrier
        const float s = warp_fold(
            __fadd_rn(__fadd_rn(fold[lane], fold[lane + 64]),
                      __fadd_rn(fold[lane + 32], fold[lane + 96])));
        const float d = row_denom<OP>(s, c_add, c_mul, floor);
        const long long row = r0 + r;
        if (denom_out && tid == 0) denom_out[row] = d;
        float* orow = out + row * n;
        if (vec) {
          for (int c = tid; c < n / 4; c += ROW_THREADS)
            reinterpret_cast<float4*>(orow)[c] = row_quotient4<RAPID>(
                reinterpret_cast<const float4*>(xr)[c], d, s_lut);
        } else {
          for (int j = tid; j < n; j += ROW_THREADS)
            orow[j] = row_quotient<RAPID>(xr[j], d, s_lut);
        }
      }
    }
  }
}

using SlabKernel = void (*)(const float*, const float*, float*, float*,
                            const int32_t*, int, int, int, float, float,
                            float, bool);

template <int OP, int WARPS, bool RAPID>
SlabKernel slab_kernel_at(int depth) {
  switch (depth) {
    case 2: return row_slab_kernel<OP, 2, WARPS, RAPID>;
    case 3: return row_slab_kernel<OP, 3, WARPS, RAPID>;
    case 4: return row_slab_kernel<OP, 4, WARPS, RAPID>;
    case 5: return row_slab_kernel<OP, 5, WARPS, RAPID>;
    case 6: return row_slab_kernel<OP, 6, WARPS, RAPID>;
    case 7: return row_slab_kernel<OP, 7, WARPS, RAPID>;
    case 8: return row_slab_kernel<OP, 8, WARPS, RAPID>;
    default: return nullptr;
  }
}

template <int OP, int WARPS>
SlabKernel slab_kernel_at(int depth, bool rapid) {
  return rapid ? slab_kernel_at<OP, WARPS, true>(depth)
               : slab_kernel_at<OP, WARPS, false>(depth);
}

// the instance of (op, depth, warps, divide), or null where this file
// compiles none: rms and softmax rows take 1 or ROW_WARPS warps a row,
// the row broadcast's flat walk 0 (and only the LUT divide)
SlabKernel slab_kernel(int op, int depth, int warps, bool rapid) {
  if (op == 2)
    return warps == 0 && rapid ? slab_kernel_at<2, 0, true>(depth) : nullptr;
  if (op == 0 && warps == 1) return slab_kernel_at<0, 1>(depth, rapid);
  if (op == 0 && warps == ROW_WARPS)
    return slab_kernel_at<0, ROW_WARPS>(depth, rapid);
  if (op == 1 && warps == 1) return slab_kernel_at<1, 1>(depth, rapid);
  if (op == 1 && warps == ROW_WARPS)
    return slab_kernel_at<1, ROW_WARPS>(depth, rapid);
  return nullptr;
}

// dynamic shared memory of one block (kernels/spec.py::row_smem less
// the static LUT): the fold buffers, the ring, the row broadcast's
// denominators
long long slab_dynamic_bytes(int depth, int warps, int bm, int n) {
  return (warps == ROW_WARPS ? 2ll * LANE * 4 : 0) +
         static_cast<long long>(depth) * bm * n * 4 +
         (warps == 0 ? static_cast<long long>(depth) * bm * 4 : 0);
}

// per instance: the dynamic shared memory granted, and the blocks of
// occ_bytes dynamic bytes that one SM holds
struct SlabInstance {
  int granted = 0;
  long long occ_bytes = -1;
  int occ_blocks = 0;
};

SlabInstance& slab_instance(int op, int depth, int warps, bool rapid) {
  static SlabInstance table[3][9][ROW_WARPS + 1][2];
  return table[op][depth][warps][rapid];
}

cudaError_t launch_slabs(int op, int depth, int warps, int grid,
                         const float* x, const float* b, float* out,
                         float* denom_out, const int32_t* lut, int rows,
                         int n, int bm, float c_add, float c_mul, float floor,
                         cudaStream_t stream) {
  const bool rapid = lut != nullptr;
  const SlabKernel kernel = slab_kernel(op, depth, warps, rapid);
  if (!kernel || rows < 1 || n < 1 || bm < 1) return cudaErrorInvalidValue;
  const long long dyn = slab_dynamic_bytes(depth, warps, bm, n);
  if (dyn > 0x7FFFFFFFll) return cudaErrorInvalidValue;
  SlabInstance& inst = slab_instance(op, depth, warps, rapid);
  if (inst.occ_bytes < 0) {  // first use: the largest shared carveout
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err =
      rapid::allow_dynamic_smem(kernel, static_cast<int>(dyn), inst.granted);
  if (err != cudaSuccess) return err;
  if (inst.occ_bytes != dyn) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &inst.occ_blocks, kernel, ROW_THREADS, static_cast<size_t>(dyn));
    if (err != cudaSuccess) return err;
    inst.occ_bytes = dyn;
  }
  // the grid kernels/spec.py planned: at most a block a slab, and one
  // wave that the card holds at once
  int sms = 0;
  err = rapid::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long nslabs = (static_cast<long long>(rows) + bm - 1) / bm;
  if (grid < 1 || grid > nslabs ||
      grid > static_cast<long long>(sms) * inst.occ_blocks)
    return cudaErrorInvalidConfiguration;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0 &&
                   n % 4 == 0;
  kernel<<<grid, ROW_THREADS, static_cast<size_t>(dyn), stream>>>(
      x, b, out, denom_out, lut, rows, n, bm, c_add, c_mul, floor, vec);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// K2 / K3 at depth 1: the rms normalize and the softmax combine, each row
// read once onto the chip.
//
// Replaces rms_div_pallas (K2) and softmax_div_pallas (K3) of
// src/repro/kernels/fused_div/fused_div.py at their own default, depth 1
// (_rowwise_call: whole rows in VMEM, each read once).
//
// What bounds it on an H100: device memory where the rows are many (each
// row read once and written once); at the few rows of a decode step,
// latency: a row's loads, its chain of adds, the fold and the divides.
//
// Design: blocks of ROW_WARPS warps; the geometry, grid included, comes
// from kernels/spec.py::row_geometry (depth 1), and a warp count this
// file did not compile, an empty slab, or a grid past the slabs or past
// one wave the card holds at once, is refused before the launch.  Block
// g walks slabs of bm rows g, g + gridDim.x, ... with none in flight
// ahead (that is depth 1), so the LUT is staged once a block, by
// cp.async issued before the first row's loads and waited for with
// them: it costs no round trip of its own.  Each row is read once onto
// the chip, every load of it in flight before its first add, and both
// the sum and the divides read that copy.  The fold and the divide are
// K8's (row_term, warp_fold, row_denom, row_quotient), the divide (LUT
// or IEEE) a template parameter.
// * Four warps a row (rows from ROW_WIDE_N elements, and narrower ones
//   where the rows, a block each, fit one wave): the row's first
//   ROUNDS x LANE elements are copied into shared memory by cp.async,
//   16 B a copy where rows are 16 B aligned and n % 4 == 0, the padding
//   to the next LANE zero-filled; thread t, as grouping lane t, sums
//   elements t, t+128, ... there; the steps h = 64 and h = 32 cross
//   warps through one of two fold buffers (the rows alternate, and so
//   do two row buffers: two barriers a row), h = 16 .. 1 are shuffles;
//   the divides take the row 16 B a thread where it was copied so.
// * One warp a row (narrow rows past that wave): the row goes straight
//   into registers; lane l holds grouping lanes l, l+32, l+64 and l+96
//   of each of ROUNDS rounds, and a warp holds WARP_HOLD / (4 x ROUNDS)
//   rows at once (four rows of 128), so a block keeps a slab of up to
//   16 rows in flight; h = 64 and h = 32 are adds in registers,
//   h = 16 .. 1 shuffles.  Its one barrier is the LUT's.
// * Rounds past the held ones (rows wider than kernels/spec.py's
//   ROW_HOLD_N, under four warps): streamed, read for the sum and again,
//   mostly from L2, for the divides.
// The 16 B path and the streamed one are template parameters too, so a
// launch fetches only the instructions its rows run: with a block an SM
// running one row, every instruction fetched is on the critical path.
// Each chain starts at +0, as lane_sum's and K8's do, and adds the row's
// zero padding, as lane_sum does on the padded row, so every
// denominator, the +0 of a row of -0 and NaN included, is lane_sum's.
namespace {

// rounds of LANE the four-warp form holds in shared memory
// (kernels/budget.py ROW_HOLD_ROUNDS), and the blocks an SM must hold at
// once (ROW_HOLD_BLOCKS_PER_SM: its two row buffers take 32 KB)
constexpr int ROW_HOLD_ROUNDS = 32;
constexpr int ROW_HOLD_BLOCKS_PER_SM = 4;
// values a lane of the one-warp form holds: its rows x rounds x 4
// (kernels/budget.py WARP_HOLD)
constexpr int WARP_HOLD = 16;

// *p = v where pred, as one predicated store: v is computed whether pred
// holds or not, so a group's divides stay side by side and do not wait
// behind one branch each
__device__ __forceinline__ void store_if(float* p, float v, bool pred) {
  asm volatile(
      "{\n .reg .pred q;\n setp.ne.b32 q, %2, 0;\n @q st.global.f32 [%0], "
      "%1;\n}\n" ::"l"(p), "f"(v), "r"(static_cast<int>(pred))
      : "memory");
}

// ROUNDS: the rounds of LANE held a row (four warps: in shared memory;
// one warp: four values a lane a round, in registers, the whole row).
// VEC and STREAM (four warps): the row is copied and divided 16 B a
// thread; the row has rounds past the held ones.
template <int OP, int WARPS, int ROUNDS, bool VEC, bool STREAM, bool RAPID>
__global__ void __launch_bounds__(ROW_THREADS, WARPS == ROW_WARPS
                                                   ? ROW_HOLD_BLOCKS_PER_SM
                                                   : ROW_BLOCKS_PER_SM)
row_hold_kernel(const float* __restrict__ x, float* __restrict__ out,
                float* __restrict__ denom_out,
                const int32_t* __restrict__ lut, int rows, int n, int bm,
                float c_add, float c_mul, float floor) {
  static_assert(OP == 0 || OP == 1, "rms or softmax");
  static_assert(WARPS == 1 || WARPS == ROW_WARPS, "1 or ROW_WARPS warps");
  constexpr bool WIDE = WARPS == ROW_WARPS;
  static_assert(WIDE || !(VEC || STREAM), "one warp: 4 B loads, all held");
  // the LUT, then (four warps a row) two fold buffers of LANE partials
  // and two buffers of a row's first HELD elements (the rows alternate)
  constexpr int HELD = ROUNDS * LANE;
  __shared__ __align__(16)
      int32_t smem[256 + (WIDE ? 2 * LANE + 2 * HELD : 0)];
  const int tid = threadIdx.x, lane = tid & 31;
  const int rounds = (n + LANE - 1) / LANE;  // of the lane-padded row
  const int nslabs = (rows + bm - 1) / bm;
  const int mine = (nslabs - 1 - static_cast<int>(blockIdx.x)) /
                       static_cast<int>(gridDim.x) + 1;
  if constexpr (RAPID) {
    stage_lut(smem, lut, tid);
    rapid::cp_async_commit();
  }
  int turn = 0;  // rows this block has folded (four warps: the buffer)
  for (int i = 0; i < mine; ++i) {
    const long long r0 = (static_cast<long long>(blockIdx.x) +
                          static_cast<long long>(i) * gridDim.x) * bm;
    const int nr = static_cast<int>(rows - r0 < bm ? rows - r0 : bm);
    if constexpr (WIDE) {
      // the row's first held rounds are copied once into shared memory,
      // the padding past n zero-filled (all copies in flight, then one
      // wait), and both the sum and the divides read them there; the
      // rounds past them are streamed
      const int hr = rounds < ROUNDS ? rounds : ROUNDS;  // held rounds
      const int hn = n < hr * LANE ? n : hr * LANE;      // held elements
      for (int r = 0; r < nr; ++r, ++turn) {
        const long long row = r0 + r;
        const float* xr = x + row * n;
        float* held = reinterpret_cast<float*>(smem + 256 + 2 * LANE) +
                      (turn & 1) * HELD;
        if constexpr (VEC) {  // n % 4 == 0, so hn is whole 16 B copies
          for (int c = tid; c < hr * LANE / 4; c += ROW_THREADS)
            rapid::cp_async16(held + 4 * c, xr + (4 * c < hn ? 4 * c : 0),
                              4 * c < hn);
        } else {
          for (int e = tid; e < hr * LANE; e += ROW_THREADS)
            rapid::cp_async4(held + e, xr + (e < hn ? e : 0), e < hn);
        }
        rapid::cp_async_commit();
        rapid::cp_async_wait<0>();  // this row (and, first, the LUT)
        __syncthreads();
        float p = 0.0f;
#pragma unroll 4
        for (int k = 0; k < hr; ++k)  // the padding adds +0, as lane_sum's
          p = __fadd_rn(p, row_term<OP>(held[tid + k * LANE]));
        if constexpr (STREAM) {
          for (int k = hr; k < rounds; k += 16) {  // 16 loads in flight
            float w[16];
#pragma unroll
            for (int c = 0; c < 16; ++c) {
              const int j = tid + (k + c) * LANE;
              w[c] = j < n ? xr[j] : 0.0f;
            }
#pragma unroll
            for (int c = 0; c < 16; ++c)
              if (k + c < rounds) p = __fadd_rn(p, row_term<OP>(w[c]));
          }
        }
        float* fold = reinterpret_cast<float*>(smem + 256) + (turn & 1) * LANE;
        fold[tid] = p;
        // h = 64, then h = 32: every warp folds the same partials, and
        // the next row writes the other buffers, so no third barrier
        __syncthreads();
        const float s = warp_fold(
            __fadd_rn(__fadd_rn(fold[lane], fold[lane + 64]),
                      __fadd_rn(fold[lane + 32], fold[lane + 96])));
        const float d = row_denom<OP>(s, c_add, c_mul, floor);
        if (denom_out && tid == 0) denom_out[row] = d;
        float* orow = out + row * n;
        if constexpr (VEC) {  // held chunks from shared memory, the
                              // streamed ones from L2
          auto* o4 = reinterpret_cast<float4*>(orow);
          for (int c = tid; c < hn / 4; c += ROW_THREADS)
            o4[c] = row_quotient4<RAPID>(
                reinterpret_cast<const float4*>(held)[c], d, smem);
          if constexpr (STREAM) {
#pragma unroll 4
            for (int c = hn / 4 + tid; c < n / 4; c += ROW_THREADS)
              o4[c] = row_quotient4<RAPID>(
                  reinterpret_cast<const float4*>(xr)[c], d, smem);
          }
        } else {
          for (int j = tid; j < hn; j += ROW_THREADS)
            orow[j] = row_quotient<RAPID>(held[j], d, smem);
          if constexpr (STREAM) {
#pragma unroll 4
            for (int j = hn + tid; j < n; j += ROW_THREADS)
              orow[j] = row_quotient<RAPID>(xr[j], d, smem);
          }
        }
      }
    } else {
      constexpr int RW = WARP_HOLD / (4 * ROUNDS);  // rows a warp holds
      static_assert(RW >= 1, "a warp holds at least one row");
      // the slab in groups of RW rows, group w + ROW_WARPS * g to warp
      // w; every warp takes the same turns, so all reach the LUT's
      // barrier
      const int turns = ((bm + RW - 1) / RW + ROW_WARPS - 1) / ROW_WARPS;
      for (int g = 0; g < turns; ++g, ++turn) {
        const int first = ((tid >> 5) + g * ROW_WARPS) * RW;
        bool live[RW];
        const float* xr[RW];
        float v[RW][ROUNDS][4];
#pragma unroll
        for (int q = 0; q < RW; ++q) {  // all in flight, then the adds
          live[q] = first + q < nr;
          xr[q] = x + (r0 + (live[q] ? first + q : 0)) * n;
#pragma unroll
          for (int k = 0; k < ROUNDS; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = k * LANE + c * 32 + lane;
              v[q][k][c] = live[q] && j < n ? xr[q][j] : 0.0f;
            }
        }
        float d[RW];
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k = 0; k < ROUNDS; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (k < rounds) p[c] = __fadd_rn(p[c], row_term<OP>(v[q][k][c]));
          // h = 64 (l += l + 64, l + 32 += l + 96), then h = 32
          d[q] = row_denom<OP>(warp_fold(__fadd_rn(__fadd_rn(p[0], p[2]),
                                                   __fadd_rn(p[1], p[3]))),
                               c_add, c_mul, floor);
        }
        if constexpr (RAPID)
          if (turn == 0) {  // the LUT, for every warp
            rapid::cp_async_wait<0>();
            __syncthreads();
          }
        float qv[RW][ROUNDS][4];
#pragma unroll
        for (int q = 0; q < RW; ++q)
#pragma unroll
          for (int k = 0; k < ROUNDS; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              qv[q][k][c] = row_quotient<RAPID>(v[q][k][c], d[q], smem);
#pragma unroll
        for (int q = 0; q < RW; ++q) {
          const long long row = r0 + first + q;
          if (live[q] && denom_out && lane == 0) denom_out[row] = d[q];
          float* orow = out + (live[q] ? row : r0) * n;
#pragma unroll
          for (int k = 0; k < ROUNDS; ++k)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int j = k * LANE + c * 32 + lane;
              store_if(orow + j, qv[q][k][c], live[q] && j < n);
            }
        }
      }
    }
  }
}

using HoldKernel = void (*)(const float*, float*, float*, const int32_t*,
                            int, int, int, float, float, float);

// an instance and the blocks of it one SM holds at once (0 until its
// first launch reads the figure)
struct HoldInstance {
  HoldKernel kernel;
  int* blocks;
};

template <int OP, int WARPS, int ROUNDS, bool VEC, bool STREAM, bool RAPID>
HoldInstance hold_at() {
  static int blocks = 0;
  return {row_hold_kernel<OP, WARPS, ROUNDS, VEC, STREAM, RAPID>, &blocks};
}

template <int OP, int WARPS, int ROUNDS, bool VEC, bool STREAM>
HoldInstance hold_at(bool rapid) {
  return rapid ? hold_at<OP, WARPS, ROUNDS, VEC, STREAM, true>()
               : hold_at<OP, WARPS, ROUNDS, VEC, STREAM, false>();
}

// rounds of LANE the one-warp form holds for rows of n: 1, 2 or 4
// (kernels/spec.py::warp_rounds)
int warp_rounds(int n) {
  const int r = (n + LANE - 1) / LANE;
  return r <= 1 ? 1 : r <= 2 ? 2 : 4;
}

template <int OP>
HoldInstance hold_of(int warps, int n, bool vec, bool rapid) {
  if (warps == ROW_WARPS) {
    constexpr int H = ROW_HOLD_ROUNDS;
    const bool stream = n > H * LANE;
    if (vec)
      return stream ? hold_at<OP, ROW_WARPS, H, true, true>(rapid)
                    : hold_at<OP, ROW_WARPS, H, true, false>(rapid);
    return stream ? hold_at<OP, ROW_WARPS, H, false, true>(rapid)
                  : hold_at<OP, ROW_WARPS, H, false, false>(rapid);
  }
  if (warps != 1 || n > 4 * LANE) return {nullptr, nullptr};
  switch (warp_rounds(n)) {
    case 1: return hold_at<OP, 1, 1, false, false>(rapid);
    case 2: return hold_at<OP, 1, 2, false, false>(rapid);
    default: return hold_at<OP, 1, 4, false, false>(rapid);
  }
}

// the instance for rows of n (vec: 16 B aligned rows, n % 4 == 0), or
// none where this file compiles none: rms (0) and softmax (1), ROW_WARPS
// warps a row, or one warp a row of at most 4 x LANE (row_geometry
// gives one warp only to rows under ROW_WIDE_N)
HoldInstance hold_instance(int op, int warps, int n, bool vec, bool rapid) {
  if (op == 0) return hold_of<0>(warps, n, vec, rapid);
  if (op == 1) return hold_of<1>(warps, n, vec, rapid);
  return {nullptr, nullptr};
}

cudaError_t launch_rows(int op, int warps, int grid, const float* x,
                        float* out, float* denom_out, const int32_t* lut,
                        int rows, int n, int bm, float c_add, float c_mul,
                        float floor, cudaStream_t stream) {
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15u) == 0 &&
                   n % 4 == 0;
  const HoldInstance inst = hold_instance(op, warps, n, vec, lut != nullptr);
  if (!inst.kernel || rows < 1 || n < 1 || bm < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (*inst.blocks == 0) {  // first use: the largest shared carveout
    int blocks = 0;
    err = cudaFuncSetAttribute(inst.kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, inst.kernel, ROW_THREADS, 0);
    if (err != cudaSuccess) return err;
    *inst.blocks = blocks;
  }
  // the grid kernels/spec.py planned: at most a block a slab, and one
  // wave that the card holds at once
  int sms = 0;
  err = rapid::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long nslabs = (static_cast<long long>(rows) + bm - 1) / bm;
  if (grid < 1 || grid > nslabs ||
      grid > static_cast<long long>(sms) * *inst.blocks)
    return cudaErrorInvalidConfiguration;
  inst.kernel<<<grid, ROW_THREADS, 0, stream>>>(x, out, denom_out, lut, rows,
                                                n, bm, c_add, c_mul, floor);
  return cudaGetLastError();
}

}  // namespace

// The shared memory one row-divider block allocates -- static (as
// compiled) plus dynamic -- into *bytes, for the check that
// kernels/spec.py::row_smem counts it: at depth >= 2 K8's block of (op,
// depth, warps) over slabs of bm rows of n; at depth 1 K2 / K3's of (op,
// warps) for rows of n, and K5's (op 2, warps 0).
extern "C" int rapid_row_slab_smem(int op, int depth, int warps, int bm,
                                   int n, long long* bytes) {
  if (bm < 1 || n < 1) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaErrorInvalidValue;
  long long dynamic = 0;
  if (depth == 1 && op == 2) {
    const auto k5 = elementwise_div_kernel<ROW_A_VECTOR>;
    if (warps == 0) err = cudaFuncGetAttributes(&attr, k5);
  } else if (depth == 1) {
    const HoldInstance inst = hold_instance(op, warps, n, true, true);
    if (inst.kernel) err = cudaFuncGetAttributes(&attr, inst.kernel);
  } else {
    const SlabKernel kernel = slab_kernel(op, depth, warps, true);
    if (kernel) err = cudaFuncGetAttributes(&attr, kernel);
    dynamic = slab_dynamic_bytes(depth, warps, bm, n);
  }
  if (err != cudaSuccess) return err;
  *bytes = static_cast<long long>(attr.sharedSizeBytes) + dynamic;
  return cudaSuccess;
}
