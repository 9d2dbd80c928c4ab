// K9 / K10: the paper's integer RAPID multiplier and 2N-by-N divider.
//
// Replaces the Pallas TPU kernels src/repro/kernels/rapid_mul/rapid_mul.py
// (rapid_mul_pallas, _kernel) and src/repro/kernels/rapid_div/rapid_div.py
// (rapid_div_pallas, _kernel).
//
// What bounds them on an H100: device memory.  A pair reads two int32
// operands and writes one uint32 result, 12 bytes, as the reference's
// kernels do: 2^24 pairs move 201 MB, 60.1 us at 3.35 TB/s.  A pair's
// arithmetic is ~30 SASS instructions (35 / 30 a pair in K9's / K10's
// loop, vector loads and stores included), ~25 us of integer issue across
// the card at 2^24 pairs: under the bytes, but only if the loads stay in
// flight while the units compute.
//
// Design, a streaming elementwise kernel:
// * 16 B accesses: int4 loads of each operand, uint4 stores of results.
// * A grid-stride walk (rapid::stream_walk, which K5 / K6 in fused_div.cu
//   share): thread t of the grid's S threads takes vectors t, t + S,
//   t + 2 S, ..., so the grid streams one window of memory at a time and
//   every thread walks the same count to within one vector.
//   Each round a thread loads its next round's vectors before it
//   computes this round's (two vectors of each operand in flight at the
//   top of a round), and the first round's loads are issued before the
//   LUT is staged.  (Measured on an H100, PERF.md: block-contiguous
//   ranges cost ~6% and no prefetch ~4%; more vectors a thread, 2 or 4,
//   did not help.)
// * Geometry from kernels/spec.py::int_geometry: THREADS a block, a grid
//   of one wave of resident blocks (the launch bounds promise 4 an SM;
//   53-56 registers a thread) or fewer, a vector a thread, where the pairs
//   are few.  The entry points refuse a block or thread
//   count they did not compile and a grid past the wave
//   (rapid::stream_launch_ok).
// * Head and tail (kernels/spec.py::int_split): `head` elements come
//   before the first index at which a, b and out are all 16 B aligned,
//   the vector body follows, then a tail of fewer than 4.  Both run one
//   element a thread in the same launch.  Where the three pointers are not
//   congruent mod 16 the head is the whole call, with no vector body; the
//   entry points check the pointers and refuse a head that leaves the body
//   misaligned.
// * 32-bit indices below 2^31 pairs, 64-bit past them (a template
//   parameter, `wide`).
// * The LUT: 1 KB of shared memory a block, staged once.  Below 4
//   fraction bits every cell of the reference reads entry 0 (its index is
//   a sign fill, 0 for an operand >= 1), so there the block fills all 256
//   cells with entry 0 and the cell index needs no case of its own.
//
// Arithmetic: the reference's int32 / uint32 sequence (the plain version
// is repro_torch/core/mitchell.py mul_terms / div_terms), rewritten with
// these identities, each holding over the operand contract (a, b < 2^n,
// n <= 16, F = n - 1 for K9; a < 2^(2n), b < 2^n, 2n <= 31, F = 2n - 1
// for K10) and for every LUT whose coefficients are all > -2^F (the
// wrapper checks the LUT; the registered schemes' lie in (-2^F/2, 2^F/2)).
// For an operand v >= 1 with leading one k <= F, c = clz(v) = 31 - k and
// nv = v << c (bit 31 set):
// * f + 2^F = v << (F - k) = nv >> (31 - F) =: X, since nv's bits below
//   31 - k >= 31 - F are 0;
// * for F >= 4 the cell index (f >> (F - 4)) & 15 is bits 30..27 of nv;
// * K9: s = f1 + f2 + lut = X1 + X2 + lut - 2^(F+1); carry <=> X1 + X2 +
//   lut >= 3 * 2^F; mant = X1 + X2 + lut - (carry ? 2 : 1) * 2^F, which is
//   > 0 (>= 2^F + min lut), so the reference's clamp at 0 never binds.
//   With e = k1 + k2 + carry = 62 - c1 - c2 + carry in [0, 2F + 1] and
//   P = mant * 2^e (< 2^48): the reference's uint32 (mant << pos) >> neg,
//   saturated where ilog2(mant) + shift >= 32, is the low word of P >> F,
//   saturated where P >> F >= 2^32, that is where P's high word is
//   >= 2^F.  This replaces the reference's third leading-one detection
//   by a comparison;
// * K10: s = X1 - X2 + lut; mant = s + (s < 0 ? 2 : 1) * 2^F, in
//   (0, 2.5 * 2^F) (< 2^31); shift = c2 - c1 - borrow - F <= 0, and the
//   reference's right shift capped at 31 equals a shift clamped at 32,
//   since mant >> 31 == 0.
// Where an operand is 0 the result is the reference's constant (0, or
// K10's saturation for b == 0) and nothing computed from it is used; every
// variable shift is a clamped funnel shift (shf.*.clamp), so a zero
// operand, whose clz is 32, takes no undefined shift, and its cell index
// stays inside the LUT.  tests/test_torch_int.py holds a numpy model of
// these steps to the plain units at every width and scheme.
#include "rapid.cuh"

namespace {

constexpr int THREADS = 256;
static_assert(THREADS == 256, "the LUT is staged one cell a thread");

// the resident blocks an SM is promised (the launch bounds: 64 registers
// a thread).  Of 2, 3, 4, 6 and 8 blocks, 3 and 4 were the fastest at 2^24
// pairs on an H100 (PERF.md).
constexpr int BLOCKS_PER_SM = 4;

struct Unit {
  int F;           // fraction bits
  unsigned rs;     // 31 - F: nv >> rs is f + 2^F
  int32_t one;     // 2^F
  uint32_t sat;    // K10: 2^(2n) - 1, the result of b == 0
};

__device__ __forceinline__ uint32_t shl(uint32_t v, unsigned s) {
  return __funnelshift_lc(0u, v, s);  // v << min(s, 32)
}

__device__ __forceinline__ uint32_t shr(uint32_t v, unsigned s) {
  return __funnelshift_rc(v, 0u, s);  // v >> min(s, 32)
}

// leading-one position as clz, the normalised operand and f + 2^F
struct Operand {
  int c;
  uint32_t nv;
  int32_t x;
};

__device__ __forceinline__ Operand operand(uint32_t v, const Unit& u) {
  Operand o;
  o.c = __clz(v);
  o.nv = shl(v, o.c);
  o.x = static_cast<int32_t>(o.nv >> u.rs);
  return o;
}

// the LUT cell of (i1, i2): bits 30..27 of each normalised operand
__device__ __forceinline__ int32_t cell(const int32_t* s_lut, uint32_t n1,
                                        uint32_t n2) {
  return s_lut[((n1 >> 23) & 0xF0u) | ((n2 >> 27) & 0xFu)];
}

__device__ __forceinline__ uint32_t mul_one(uint32_t a, uint32_t b,
                                            const Unit& u,
                                            const int32_t* s_lut) {
  const Operand p = operand(a, u), q = operand(b, u);
  const int32_t sum = p.x + q.x + cell(s_lut, p.nv, q.nv);
  const bool carry = sum >= 3 * u.one;
  const uint32_t mant = static_cast<uint32_t>(sum - (carry ? 2 * u.one
                                                           : u.one));
  const unsigned e = static_cast<unsigned>(62 - p.c - q.c + (carry ? 1 : 0));
  const uint32_t lo = shl(mant, e);
  const uint32_t hi = __funnelshift_lc(mant, 0u, e);  // P >> 32
  uint32_t res = __funnelshift_rc(lo, hi, u.F);       // low word of P >> F
  res = hi >= static_cast<uint32_t>(u.one) ? 0xFFFFFFFFu : res;
  return (a == 0u || b == 0u) ? 0u : res;
}

__device__ __forceinline__ uint32_t div_one(uint32_t a, uint32_t b,
                                            const Unit& u,
                                            const int32_t* s_lut) {
  const Operand p = operand(a, u), q = operand(b, u);
  const int32_t s = p.x - q.x + cell(s_lut, p.nv, q.nv);
  const bool borrow = s < 0;
  const uint32_t mant = static_cast<uint32_t>(s + (borrow ? 2 * u.one
                                                          : u.one));
  const unsigned neg = static_cast<unsigned>(u.F + p.c - q.c
                                             + (borrow ? 1 : 0));
  const uint32_t res = a == 0u ? 0u : shr(mant, neg);
  return b == 0u ? u.sat : res;
}

template <bool MUL>
__device__ __forceinline__ uint32_t unit(int32_t a, int32_t b, const Unit& u,
                                         const int32_t* s_lut) {
  const uint32_t x = static_cast<uint32_t>(a), y = static_cast<uint32_t>(b);
  return MUL ? mul_one(x, y, u, s_lut) : div_one(x, y, u, s_lut);
}

template <bool MUL>
__device__ __forceinline__ uint4 unit4(const int4& a, const int4& b,
                                       const Unit& u, const int32_t* s_lut) {
  return make_uint4(unit<MUL>(a.x, b.x, u, s_lut),
                    unit<MUL>(a.y, b.y, u, s_lut),
                    unit<MUL>(a.z, b.z, u, s_lut),
                    unit<MUL>(a.w, b.w, u, s_lut));
}

// One vector of four pairs, for rapid::stream_walk: a and b from `head`
// on, 16 B aligned; the LUT staged one cell a thread.
template <bool MUL, typename Index>
struct IntStream {
  struct Vec {
    int4 a, b;
  };
  const int32_t* a;
  const int32_t* b;
  const int32_t* lut;
  uint32_t* out;
  const int4* a4;
  const int4* b4;
  uint4* o4;
  const Unit& u;
  int32_t* s_lut;

  __device__ __forceinline__ Vec load(Index v) const { return {a4[v], b4[v]}; }
  __device__ __forceinline__ void stage() const {
    s_lut[threadIdx.x] = lut[u.F >= 4 ? threadIdx.x : 0];
  }
  __device__ __forceinline__ void store(Index v, const Vec& x) const {
    o4[v] = unit4<MUL>(x.a, x.b, u, s_lut);
  }
  __device__ __forceinline__ void scalar(Index e) const {
    out[e] = unit<MUL>(a[e], b[e], u, s_lut);
  }
};

// Index: uint32_t below 2^31 pairs, unsigned long long past them.  The
// walk is rapid::stream_walk, K5 / K6's.
template <bool MUL, typename Index>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
int_unit_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                const int32_t* __restrict__ lut, uint32_t* __restrict__ out,
                Index total, Index head, Unit u) {
  __shared__ int32_t s_lut[256];
  IntStream<MUL, Index> op{a, b, lut, out,
                           reinterpret_cast<const int4*>(a + head),
                           reinterpret_cast<const int4*>(b + head),
                           reinterpret_cast<uint4*>(out + head), u, s_lut};
  rapid::stream_walk<THREADS>(total, head, op);
}

template <bool MUL>
cudaError_t launch(const void* a, const void* b, const void* lut, void* out,
                   long long total, long long head, const Unit& u,
                   int blocks_per_sm, int threads, int grid, int wide,
                   void* stream) {
  if (!wide && total >= (1ll << 31)) return cudaErrorInvalidValue;
  const cudaError_t err = rapid::stream_launch_ok(
      total, head, blocks_per_sm, threads, grid, BLOCKS_PER_SM, THREADS,
      {a, b, out});
  if (err != cudaSuccess) return err;
  const auto* pa = static_cast<const int32_t*>(a);
  const auto* pb = static_cast<const int32_t*>(b);
  const auto* pl = static_cast<const int32_t*>(lut);
  auto* po = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (wide)
    int_unit_kernel<MUL, unsigned long long><<<grid, THREADS, 0, s>>>(
        pa, pb, pl, po, static_cast<unsigned long long>(total),
        static_cast<unsigned long long>(head), u);
  else
    int_unit_kernel<MUL, uint32_t><<<grid, THREADS, 0, s>>>(
        pa, pb, pl, po, static_cast<uint32_t>(total),
        static_cast<uint32_t>(head), u);
  return cudaGetLastError();
}

}  // namespace

// a, b: int32 [total], a, b < 2^n_bits (1 <= n_bits <= 16); out: uint32
// [total]; head, blocks_per_sm, threads, grid, wide from kernels/spec.py.
extern "C" int rapid_mul_int(const void* a, const void* b, const void* lut,
                             void* out, long long total, long long head,
                             int n_bits, int blocks_per_sm, int threads,
                             int grid, int wide, void* stream) {
  if (n_bits < 1 || n_bits > 16) return cudaErrorInvalidValue;
  const Unit u{n_bits - 1, static_cast<unsigned>(32 - n_bits),
               1 << (n_bits - 1), 0u};
  return launch<true>(a, b, lut, out, total, head, u, blocks_per_sm, threads,
                      grid, wide, stream);
}

// a < 2^(2 n_bits), b < 2^n_bits, int32 [total] (1 <= n_bits, 2 n_bits <=
// 31); out: uint32 [total]; head, blocks_per_sm, threads, grid, wide as
// above.
extern "C" int rapid_div_int(const void* a, const void* b, const void* lut,
                             void* out, long long total, long long head,
                             int n_bits, int blocks_per_sm, int threads,
                             int grid, int wide, void* stream) {
  if (n_bits < 1 || 2 * n_bits > 31) return cudaErrorInvalidValue;
  const int F = 2 * n_bits - 1;
  const Unit u{F, static_cast<unsigned>(31 - F), 1 << F,
               static_cast<uint32_t>((1ull << (2 * n_bits)) - 1)};
  return launch<false>(a, b, lut, out, total, head, u, blocks_per_sm,
                       threads, grid, wide, stream);
}
