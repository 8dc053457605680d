// The deterministic d_value pass of the two deformable-attention backward
// kernels, K1-bwd (ms_deform_attn_bwd.cu) and K3-bwd (ms_deform_attn_sep_bwd.cu):
// every d_value element is written once, as the sum of its terms, and that sum
// does not depend on the order in which the card runs the blocks.
//
// A tap whose corners touch its level is keyed by its top-left corner
// (x0, y0), x0 in [-1, w - 1] and y0 in [-1, h - 1], on the level's extended
// grid of (h + 1) x (w + 1) positions (y0 + 1, x0 + 1); a key is
// ((b * S_ext + ext_start[l] + (y0 + 1) * (w + 1) + x0 + 1) * M + m), so that
// the keys of one pixel's heads lie side by side. Value row (y, x) of the
// level takes corner e = (e & 1, e >> 1) of the taps keyed at
// (y - (e >> 1) + 1, x - (e & 1) + 1): four keys, and no other tap reaches it.
//
// 1. The backward kernel writes each tap's key (-1 for a tap with no corner in
//    its level) and its four corners' factors, counts the taps of each key,
//    and takes the largest |g| of the call (integer atomic adds and maxima: a
//    count and a maximum are the same in every order).
// 2. An exclusive scan of the counts gives each key its segment of a list
//    (dvalue_scan_*_kernel: integer sums, in any order the same).
// 3. dvalue_place_kernel writes each keyed tap's id into its key's segment
//    at a slot from an integer atomic on the key's cursor, and takes the
//    largest factor bound of the call. Which slot a tap takes depends on the
//    order the threads run, so a segment holds its taps in no fixed order;
//    step 4 makes the sum independent of that order.
// 4. The gather (a kernel of each source, over dv_gather_warp) sums each value
//    row (b, s, m) with one warp, coarsest level first and a pixel's heads in
//    turn (their g rows side by side): eight lanes find eight rows'
//    segments, then for each row with an entry the warp decodes 32 entries at
//    once (corner e of the taps of the four segments), and four lane groups
//    take them in turn, eight lanes of four channels each. Each term is added
//    in fixed point: times 2^k, rounded to the nearest integer, into a 64-bit
//    integer; the groups' integers are added at the end. An integer sum is
//    exact, so it is the same in every order; it is rounded once to float32
//    and once to the output's type. The shift k (dv_shift) comes from the row's count n and
//    the call's bound max|g| * the largest factor bound (Term::bound), at
//    least every term's magnitude less a few roundings: the sum stays below
//    2^63 in every order, and every term is kept to 2^(c - 61) of the bound
//    (c = ceil(log2 n)), 31 bits below a float32 rounding of the bound. Where
//    the bound is not finite (a g or a factor is not: a step that diverged),
//    every element of a row with an entry is NaN.
//
// No float atomic is left: d_value is written once, in the value's dtype, so
// the callers need no zeroed f32 scratch and no cast.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "msda_common.cuh"

namespace msda {

constexpr int kScanThreads = 256;
constexpr int kScanItems = 8;                               // consecutive counts a thread
constexpr int kScanChunk = kScanThreads * kScanItems;        // counts a block: 2,048
constexpr int kGatherThreads = 256;
constexpr int kGatherBlocks = 4;  // gather blocks an SM at least: 64 registers a thread
constexpr int kRowsPerWarp = 8;                              // value rows a gather warp

// The extended grid of every level: (h + 1) x (w + 1) positions, by level.
struct ExtLevels {
  long long start[kMaxLevels];
  long long total;  // S_ext
};

inline ExtLevels make_ext(const Levels& lv) {
  ExtLevels ex;
  long long s = 0;
  for (int l = 0; l < lv.n; ++l) {
    ex.start[l] = s;
    s += static_cast<long long>(lv.h[l] + 1) * (lv.w[l] + 1);
  }
  ex.total = s;
  return ex;
}

// The 4-byte workspace of one call, carved in this order: each tap's four
// corner factors (float4 [n_taps]), keys [n_taps], offsets [n_keys + 1] (the
// counts, scanned in place) and the call's largest |g| and factor bound as
// bits [2] (these two zeroed together), cursors [n_keys], list [n_taps],
// block sums [n_blocks].
struct DvPlan {
  long long n_taps, n_keys, n_blocks;
  float4* factors;
  int* keys;
  int* offsets;
  unsigned* maxima;  // [0] max |g|, [1] the largest factor bound, as float bits
  int* cursors;
  int* list;
  int* sums;
};

inline long long dv_words(long long n_taps, long long n_keys) {
  const long long n_blocks = (n_keys + 1 + kScanChunk - 1) / kScanChunk;
  return 6 * n_taps + 2 * n_keys + 3 + n_blocks;
}

// false where an id or a key would not fit an int32
inline bool make_plan(DvPlan& p, void* ws, long long n_taps, long long n_keys) {
  if (n_taps >= (1LL << 31) || n_keys + 1 >= (1LL << 31)) return false;
  p.n_taps = n_taps;
  p.n_keys = n_keys;
  p.n_blocks = (n_keys + 1 + kScanChunk - 1) / kScanChunk;
  p.factors = static_cast<float4*>(ws);
  p.keys = reinterpret_cast<int*>(p.factors + n_taps);
  p.offsets = p.keys + n_taps;
  p.maxima = reinterpret_cast<unsigned*>(p.offsets + n_keys + 1);
  p.cursors = reinterpret_cast<int*>(p.maxima + 2);
  p.list = p.cursors + n_keys;
  p.sums = p.list + n_taps;
  return true;
}

// A tap's key from its top-left corner; the caller has checked inside().
__device__ __forceinline__ int dv_key(long long b, int m, int M, int l, int x0, int y0,
                                      const Levels& lv, const ExtLevels& ex) {
  const long long pos = ex.start[l] + static_cast<long long>(y0 + 1) * (lv.w[l] + 1) + x0 + 1;
  return static_cast<int>((b * ex.total + pos) * M + m);
}

// |x| as bits: as unsigned integers, every finite |x| below +inf below NaN.
__device__ __forceinline__ unsigned abs_bits(float x) { return __float_as_uint(x) & 0x7fffffffu; }

// The block's largest of each thread's `bits` (|x| as bits) into *word, one
// atomic maximum: the same in every order. Every thread of the block calls
// it, once.
template <int kThreads>
__device__ __forceinline__ void dv_block_max(unsigned bits, unsigned* word) {
  __shared__ unsigned part[kThreads / 32];
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = bits;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) bits = max(bits, part[w]);
    atomicMax(word, bits);
  }
}

// The same for a warp of a kernel whose warps may leave early.
__device__ __forceinline__ void dv_warp_max(unsigned bits, unsigned* word) {
  bits = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) atomicMax(word, bits);
}

__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kScanThreads / 32; ++w) {
    if (w < warp) before += warp_tot[w];
    total += warp_tot[w];
  }
  __syncthreads();
  return before + inc - v;
}

// Step 2a: each block's sum of its 2,048 counts.
__global__ void __launch_bounds__(kScanThreads)
dvalue_scan_reduce_kernel(const int* __restrict__ counts, long long n, int* __restrict__ sums) {
  __shared__ int warp_tot[kScanThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kScanChunk +
                         static_cast<long long>(threadIdx.x) * kScanItems;
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (base + i < n) v += counts[base + i];
  int total;
  block_exclusive_sum(v, warp_tot, total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Step 2b: one block scans the block sums (exclusive), 256 at a time.
__global__ void __launch_bounds__(kScanThreads)
dvalue_scan_sums_kernel(int* __restrict__ sums, long long n_blocks) {
  __shared__ int warp_tot[kScanThreads / 32];
  int carry = 0;
  for (long long base = 0; base < n_blocks; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const int v = i < n_blocks ? sums[i] : 0;
    int total;
    const int ex = block_exclusive_sum(v, warp_tot, total);
    if (i < n_blocks) sums[i] = carry + ex;
    carry += total;
  }
}

// Step 2c: the counts scanned in place into offsets (offsets[n_keys] is the
// number of keyed taps), and the cursors set to them.
__global__ void __launch_bounds__(kScanThreads)
dvalue_scan_write_kernel(int* __restrict__ offsets, int* __restrict__ cursors, long long n,
                         const int* __restrict__ sums) {
  __shared__ int warp_tot[kScanThreads / 32];
  const long long base = static_cast<long long>(blockIdx.x) * kScanChunk +
                         static_cast<long long>(threadIdx.x) * kScanItems;
  int c[kScanItems];
  int v = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    c[i] = base + i < n ? offsets[base + i] : 0;
    v += c[i];
  }
  int total;
  int run = sums[blockIdx.x] + block_exclusive_sum(v, warp_tot, total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i < n) {
      offsets[base + i] = run;
      if (base + i < n - 1) cursors[base + i] = run;
    }
    run += c[i];
  }
}

// Step 3: each keyed tap's id into its key's segment; the call's largest
// Term::bound of the taps' factors into maxima[1].
template <typename Term>
__global__ void __launch_bounds__(kScanThreads)
dvalue_place_kernel(const int* __restrict__ keys, const float4* __restrict__ factors,
                    long long n_taps, int* __restrict__ cursors, int* __restrict__ list,
                    unsigned* __restrict__ maxima) {
  const long long t = static_cast<long long>(blockIdx.x) * kScanThreads + threadIdx.x;
  unsigned bits = 0;
  if (t < n_taps) {
    const int k = keys[t];
    if (k >= 0) {
      list[atomicAdd(cursors + k, 1)] = static_cast<int>(t);
      bits = __float_as_uint(Term::bound(factors[t])) & 0x7fffffffu;
    }
  }
  dv_block_max<kScanThreads>(bits, maxima + 1);
}

// frexpf's exponent of a finite mx > 0: 2^(e - 1) <= mx < 2^e.
__device__ __forceinline__ int dv_exponent(float mx) {
  const unsigned bits = __float_as_uint(mx);
  const int biased = static_cast<int>(bits >> 23);
  return biased ? biased - 126 : 32 - __clz(static_cast<int>(bits)) - 149;  // subnormal
}

// The shift k of a row's fixed-point sums: n terms, each below twice the
// bound mx (finite, > 0; the bound may undershoot a term by a few roundings),
// with n * 2^e * 2^k <= 2^61 for mx < 2^e, so that the n terms rounded to
// integers sum below 2^62 + n / 2 < 2^63 in any order.
__device__ __forceinline__ int dv_shift(float mx, int n) {
  const int c = n > 1 ? 32 - __clz(n - 1) : 0;  // n <= 2^c
  return 61 - c - dv_exponent(mx);
}

// 2^p for p in [-126, 127]: multiplying by it is exact but where the product
// leaves the normal range.
__device__ __forceinline__ float pow2(int p) { return __int_as_float((p + 127) << 23); }

// Four channels of one value row, rounded once to the output's type.
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  t.x = *reinterpret_cast<const uint32_t*>(&lo);
  t.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// A value row's entries: corner e of the taps of segment e (list[lo[e] ..]),
// the segments in order e = 0 .. 3, entry v of the row in segment
// (v >= cum[1]) + (v >= cum[2]) + (v >= cum[3]).
struct DvRow {
  int lo[4], cum[4], n;
};

// Entry v's factors (w1, w2) from its tap's four corner factors (Term::pick)
// and its g row, or zeros past the row's entries.
template <typename Term>
__device__ __forceinline__ void dv_decode(const DvRow& r, int v, const int* __restrict__ list,
                                          const float4* __restrict__ factors, int lp_n,
                                          float& w1, float& w2, int& grow) {
  w1 = w2 = 0.f;
  grow = 0;
  if (v < r.n) {
    const int e = (v >= r.cum[1]) + (v >= r.cum[2]) + (v >= r.cum[3]);
    const int lo = e == 0 ? r.lo[0] : e == 1 ? r.lo[1] : e == 2 ? r.lo[2] : r.lo[3];
    const int cum = e == 0 ? 0 : e == 1 ? r.cum[1] : e == 2 ? r.cum[2] : r.cum[3];
    const int tap = list[lo + v - cum];
    Term::pick(factors[tap], e, w1, w2);
    grow = tap / lp_n;
  }
}

// Gather row i of the order the gather takes: the coarsest level's rows first
// (they have the most entries), and within a level (b, pixel, m), so that the
// rows a block takes are a pixel's heads, whose g rows lie side by side. ->
// the row ((b, s, m) in d_value's order) and its level.
__device__ __forceinline__ long long dv_row_of(long long i, int B, int S, int M,
                                               const Levels& lv, int& l) {
  l = lv.n - 1;
  for (;;) {
    const long long cnt = static_cast<long long>(B) * lv.h[l] * lv.w[l] * M;
    if (i < cnt || l == 0) break;
    i -= cnt;
    --l;
  }
  const long long hw = static_cast<long long>(lv.h[l]) * lv.w[l];
  const long long bp = i / M;
  return ((bp / hw) * S + lv.start[l] + bp % hw) * M + i % M;
}

// One value row's sums: lane group q = lane / 8 takes the entries of rounds
// q, q + 4, ... of each chunk of 32 the warp decodes (a lane an entry), lane
// k = lane % 8 channels 4k .. 4k + 3; each term is added in fixed point with
// the shift from the row's count and the call's (finite) bound; the groups'
// integers are added at the end and group 0 writes.
template <typename T, typename Term>
__device__ __forceinline__ void dv_sum_row(long long row, const DvRow& r,
                                           const int* __restrict__ list,
                                           const float4* __restrict__ factors, int lp_n,
                                           float bound, const T* __restrict__ grad,
                                           T* __restrict__ d_value) {
  const int lane = threadIdx.x & 31, grp = lane >> 3, k = lane & 7;
  const int kr = bound == 0.f ? 0 : dv_shift(bound, r.n);  // in [-98, 211]
  const float s_hi = pow2(min(kr, 127)), s_lo = pow2(kr - min(kr, 127));
  long long acc[4] = {0, 0, 0, 0};
  for (int base = 0; base < r.n; base += 32) {
    float w1, w2;
    int grow;
    dv_decode<Term>(r, base + lane, list, factors, lp_n, w1, w2, grow);
    const int rounds = min(8, (r.n - base + 3) >> 2);
#pragma unroll 2
    for (int i = 0; i < rounds; ++i) {
      const int src = 4 * i + grp;  // past the row's entries: zero factors, zero terms
      const float a1 = __shfl_sync(0xffffffffu, w1, src);
      const float a2 = __shfl_sync(0xffffffffu, w2, src);
      const int gr = __shfl_sync(0xffffffffu, grow, src);
      float g[4];
      load4(grad + static_cast<long long>(gr) * kD + 4 * k, g);
#pragma unroll
      for (int c = 0; c < 4; ++c)  // exact: a power of two, in range
        acc[c] += __float2ll_rn(Term::term(a1, a2, g[c]) * s_hi * s_lo);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {  // the four groups' integers: exact in any order
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 8);
    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 16);
  }
  if (grp == 0) {
    const int a = max(-kr, -126);  // 2^-k = 2^a * 2^(-k - a), each a normal float
    const float sa = pow2(a), sb = pow2(-kr - a);
    float res[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) res[c] = __ll2float_rn(acc[c]) * sa * sb;
    store4(d_value + row * kD + 4 * k, res);
  }
}

// Step 4 for gather rows i0 .. i0 + 7 of a warp (dv_row_of): lane j < 8 finds
// its row's four segments and, where the row has no entry, writes its zeros;
// then the warp sums each other row in turn (dv_sum_row), with the shift from
// the call's bound (maxima, as bits: max|g| times the largest factor bound).
// Term gives an entry's factors (w1, w2) from its tap's four corner factors
// and the corner (pick), and its term from (w1, w2, g) (term), the same float
// every time for one entry.
template <typename T, typename Term>
__device__ __forceinline__ void dv_gather_warp(long long i0, long long n_rows, int B,
                                               const int* __restrict__ offsets,
                                               const int* __restrict__ list,
                                               const float4* __restrict__ factors,
                                               const unsigned* __restrict__ maxima, int lp_n,
                                               const T* __restrict__ grad,
                                               T* __restrict__ d_value, int S, int M,
                                               const Levels& lv, const ExtLevels& ex) {
  const int lane = threadIdx.x & 31;
  long long row = 0;
  DvRow mine;
  mine.n = 0;
  mine.lo[0] = mine.lo[1] = mine.lo[2] = mine.lo[3] = 0;
  mine.cum[0] = mine.cum[1] = mine.cum[2] = mine.cum[3] = 0;
  if (lane < kRowsPerWarp && i0 + lane < n_rows) {
    int l;
    row = dv_row_of(i0 + lane, B, S, M, lv, l);
    const int m = static_cast<int>(row % M);
    const long long bs = row / M;
    const int s = static_cast<int>(bs % S);
    const long long b = bs / S;
    const int w = lv.w[l];
    const int local = s - static_cast<int>(lv.start[l]);
    const int y = local / w, x = local - y * w;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos =
          ex.start[l] + static_cast<long long>(y - (e >> 1) + 1) * (w + 1) + x - (e & 1) + 1;
      const long long key = (b * ex.total + pos) * M + m;
      mine.lo[e] = offsets[key];
      mine.cum[e] = mine.n;
      mine.n += offsets[key + 1] - mine.lo[e];
    }
    if (mine.n == 0) {  // its 32 zeros, 16 bytes at a time
      uint4* q = reinterpret_cast<uint4*>(d_value + row * kD);
#pragma unroll
      for (int i = 0; i < kD * static_cast<int>(sizeof(T)) / 16; ++i)
        q[i] = make_uint4(0, 0, 0, 0);
    }
  }
  unsigned todo = __ballot_sync(0xffffffffu, mine.n > 0);
  if (!todo) return;
  const float bound = __uint_as_float(maxima[0]) * __uint_as_float(maxima[1]);
  if (!(bound <= 3.4028235e38f)) {  // a g or a factor is not finite: NaN where a term is
    if (mine.n > 0) {  // 32 quiet NaNs, 16 bytes at a time
      const unsigned nan = sizeof(T) == 4 ? 0x7fffffffu : 0x7fff7fffu;
      uint4* q = reinterpret_cast<uint4*>(d_value + row * kD);
#pragma unroll
      for (int i = 0; i < kD * static_cast<int>(sizeof(T)) / 16; ++i)
        q[i] = make_uint4(nan, nan, nan, nan);
    }
    return;
  }
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    DvRow r;
    r.n = __shfl_sync(0xffffffffu, mine.n, src);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      r.lo[e] = __shfl_sync(0xffffffffu, mine.lo[e], src);
      r.cum[e] = __shfl_sync(0xffffffffu, mine.cum[e], src);
    }
    dv_sum_row<T, Term>(__shfl_sync(0xffffffffu, row, src), r, list, factors, lp_n, bound, grad,
                        d_value);
  }
}

// The counts and the maxima zeroed, before the backward kernel writes them.
inline cudaError_t dv_zero(const DvPlan& p, cudaStream_t stream) {
  return cudaMemsetAsync(p.offsets, 0, (p.n_keys + 3) * sizeof(int), stream);
}

// Steps 2 and 3 on `stream`, after the backward kernel.
template <typename Term>
inline void dv_scan_and_place(const DvPlan& p, cudaStream_t stream) {
  const long long n = p.n_keys + 1;
  dvalue_scan_reduce_kernel<<<static_cast<unsigned>(p.n_blocks), kScanThreads, 0, stream>>>(
      p.offsets, n, p.sums);
  dvalue_scan_sums_kernel<<<1, kScanThreads, 0, stream>>>(p.sums, p.n_blocks);
  dvalue_scan_write_kernel<<<static_cast<unsigned>(p.n_blocks), kScanThreads, 0, stream>>>(
      p.offsets, p.cursors, n, p.sums);
  if (p.n_taps > 0)
    dvalue_place_kernel<Term>
        <<<static_cast<unsigned>((p.n_taps + kScanThreads - 1) / kScanThreads), kScanThreads, 0,
           stream>>>(p.keys, p.factors, p.n_taps, p.cursors, p.list, p.maxima);
}

}  // namespace msda
