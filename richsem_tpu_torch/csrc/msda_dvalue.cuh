// The deterministic d_value pass of the two deformable-attention backward
// kernels, K1-bwd (ms_deform_attn_bwd.cu) and K3-bwd (ms_deform_attn_sep_bwd.cu):
// every d_value element is the sum of its terms in 64-bit fixed point, and
// that sum does not depend on the order in which the card runs the blocks.
//
// A tap whose corners touch its level is keyed by its top-left corner
// (x0, y0), x0 in [-1, w - 1] and y0 in [-1, h - 1], on the level's extended
// grid of (h + 1) x (w + 1) positions (y0 + 1, x0 + 1); a key is
// ((b * S_ext + ext_start[l] + (y0 + 1) * (w + 1) + x0 + 1) * M + m). Value
// row (y, x) of the level takes corner e = (e & 1, e >> 1) of the taps keyed
// at (y - (e >> 1) + 1, x - (e & 1) + 1): four keys, and no other tap reaches
// it, so a row's count of terms n is the sum of those four keys' counts.
//
// 1. dvalue_count_kernel: each tap's key and corner factors, computed as the
//    backward kernel computes them; the keys counted (in shared memory a
//    round, then one integer atomic add a key), the call's largest |g| and
//    largest factor bound (Term::bound) taken: counts and maxima are the same
//    in every order.
// 2. dvalue_shift_kernel, a thread a value row: the row's n and its shift k
//    (dv_shift) from n and the call's bound max|g| * the largest factor bound,
//    at least every term's magnitude less a few roundings; the 64-bit integers
//    of each row with an entry zeroed (no memset of rows that no tap reaches).
// 3. dvalue_scatter_kernel: each in-level corner's terms, each times 2^k of
//    its row and rounded to the nearest integer (dv_fixed), summed by row in
//    64-bit integers (a tile of queries' taps sorted by row in shared memory,
//    so that a row's terms from many taps meet there) and added into the
//    row's integers with red.global.add.u64 (two's complement carries the
//    sign). Integer addition is associative, and every partial sum and the
//    whole stay below 2^63 in every order (n * 2^e * 2^k <= 2^61 for a bound
//    below 2^e), so the integers come out the same bit for bit however the
//    blocks, the rounds and the reds interleave. Every term is kept to
//    2^(c - 61) of the bound (c = ceil(log2 n)), 31 bits below a float32
//    rounding of the bound. A term of 0 (a factor of 0) is left out: it adds
//    nothing.
// 4. dvalue_convert_kernel, eight lanes a value row: each integer rounded once
//    to float32, times 2^-k, and once to the output's type; zeros for a row
//    with no entry, and, where the bound is not finite (a g or a factor is
//    not: a step that diverged), NaN in every element of a row with an entry.
//
// No float atomic, no list of taps and no gather: d_value is written once, in
// the value's dtype, so the callers need no zeroed f32 scratch and no cast;
// and the sums are those of a pass that lists the taps by corner and gathers
// each row's terms in a fixed order, bit for bit.
//
// What bounds it. The 64-bit reds are the costly part: a card adds them in
// L2 at a few hundred G a second, so one red a term (819 M a call at the
// encoder's shapes) would cost more than the tap kernel itself. The scatter
// therefore merges a row's terms first, a tile of encoder queries being
// 8 x 8 pixels of one level whose taps land on few rows (four or more terms a
// row on average); then the scatter is bound by its loop over the terms
// (a float32 product, two exact scalings and a conversion to 64 bits each)
// and by the rounds' latency. A decoder's queries share few rows, so there
// every term's row takes its own reds.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "msda_common.cuh"

namespace msda {

constexpr int kPassThreads = 256;          // threads a block of the pass's kernels
constexpr int kDvEmpty = 0x7fffffff;       // a row's shift where no term reaches it
constexpr int kDvNaN = 0x7ffffffe;         // where the bound is not finite

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

// The 4-byte workspace of one call, carved in this order: the rows' 64-bit
// integers (int64 [n_rows][kD], first, so 8-byte aligned), the rows' shifts
// [n_rows], the keys' counts [n_keys] and the call's largest |g| and factor
// bound as bits [2] (these two zeroed together).
struct DvPlan {
  long long n_rows, n_keys;
  unsigned long long* acc;
  int* shift;
  int* counts;
  unsigned* maxima;  // [0] max |g|, [1] the largest factor bound, as float bits
};

inline long long dv_words(long long n_rows, long long n_keys) {
  return 2LL * kD * n_rows + n_rows + n_keys + 2;
}

// false where a key or a row would not fit an int32 or the workspace is not
// 16-byte aligned
inline bool make_plan(DvPlan& p, void* ws, long long n_rows, long long n_keys) {
  if (n_keys >= (1LL << 31) || n_rows >= (1LL << 31) || reinterpret_cast<uintptr_t>(ws) % 16)
    return false;
  p.n_rows = n_rows;
  p.n_keys = n_keys;
  p.acc = static_cast<unsigned long long*>(ws);
  p.shift = reinterpret_cast<int*>(p.acc + n_rows * kD);
  p.counts = p.shift + n_rows;
  p.maxima = reinterpret_cast<unsigned*>(p.counts + n_keys);
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The block's largest of each thread's a and b (|x| as bits) into word[0] and
// word[1], one atomic maximum each: the same in every order. Every thread of
// the block calls it, once.
template <int kThreads>
__device__ __forceinline__ void dv_block_max2(unsigned a, unsigned b, unsigned* word) {
  __shared__ unsigned part[2][kThreads / 32];
  a = __reduce_max_sync(0xffffffffu, a);
  b = __reduce_max_sync(0xffffffffu, b);
  if ((threadIdx.x & 31) == 0) {
    part[0][threadIdx.x >> 5] = a;
    part[1][threadIdx.x >> 5] = b;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned v = 0;
    for (int w = 0; w < kThreads / 32; ++w) v = max(v, part[threadIdx.x][w]);
    // a plain read first: most blocks find the maximum already there
    if (v > *reinterpret_cast<volatile unsigned*>(word + threadIdx.x))
      atomicMax(word + threadIdx.x, v);
  }
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

// Step 2, a thread a value row (b, s, m), a warp 32 rows side by side.
__global__ void __launch_bounds__(kPassThreads)
dvalue_shift_kernel(const int* __restrict__ counts, const unsigned* __restrict__ maxima,
                    int* __restrict__ shift, unsigned long long* __restrict__ acc, int n_rows,
                    int S, int M, const __grid_constant__ Levels lv,
                    const __grid_constant__ ExtLevels ex) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kPassThreads + threadIdx.x;
  bool zero = false;
  if (row < n_rows) {
    const int m = row % M, bs = row / M;
    const int s = bs % S, b = bs / S;
    int l = 0;
    while (l + 1 < lv.n && s >= lv.start[l + 1]) ++l;
    const int w = lv.w[l];
    const int local = s - static_cast<int>(lv.start[l]);
    const int y = local / w, x = local - y * w;
    int n = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long pos =
          ex.start[l] + static_cast<long long>(y - (e >> 1) + 1) * (w + 1) + x - (e & 1) + 1;
      n += counts[(b * ex.total + pos) * M + m];
    }
    int k = kDvEmpty;
    if (n > 0) {
      const float bound = __uint_as_float(maxima[0]) * __uint_as_float(maxima[1]);
      if (!(bound <= 3.4028235e38f)) {
        k = kDvNaN;  // a g or a factor is not finite
      } else {
        k = bound == 0.f ? 0 : dv_shift(bound, n);  // in [-98, 211]
        zero = true;
      }
    }
    shift[row] = k;
  }
  // the warp's 32 rows' integers, 8 KB, 16 bytes a lane at a time, where a
  // term will reach them
  uint4* q = reinterpret_cast<uint4*>(acc + static_cast<long long>(row - lane) * kD);
#pragma unroll 4
  for (int i = 0; i < kD * 8 / 16; ++i) {
    const int c = i * 32 + lane;  // 16-byte word c of the warp's rows: row c / 16
    if (__shfl_sync(0xffffffffu, zero, c >> 4)) q[c] = make_uint4(0, 0, 0, 0);
  }
}

// A term times 2^k of its row (scales s_hi * s_lo, each multiplication exact:
// powers of two, in range), rounded to the nearest integer.
__device__ __forceinline__ long long dv_fixed(float term, float s_hi, float s_lo) {
  return __float2ll_rn(term * s_hi * s_lo);
}

// v added into *p, a 64-bit integer, with no value returned.
__device__ __forceinline__ void dv_red(unsigned long long* p, long long v) {
  asm volatile("red.global.add.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A row's scales from its shift k (dv_shift's, at most 211): 2^k = s_hi * s_lo.
__device__ __forceinline__ void dv_scales(int k, float& s_hi, float& s_lo) {
  s_hi = pow2(min(k, 127));
  s_lo = pow2(k - min(k, 127));
}

// Step 3: dvalue_scatter_kernel. A block takes one (b, m) and a tile of
// queries: where the queries are the tokens (Q == S, the encoder) a kTileW x
// kTileH patch of one level's pixels, whose taps crowd into few value rows,
// else kLinearQ consecutive queries. Its taps, level by level (the tile's taps
// in (l, query, p) order, kChunkTaps a round, a thread a tap, the next round's
// inputs loaded while a round sums), give each in-level corner with a nonzero
// factor an entry: the row's token and shift, the factors and the query. A
// round hashes its entries' rows into shared memory (open addressing), sorts
// the entries by row (a count a slot, a scan, each entry to its slot's range),
// and the 32 lane groups of eight lanes take equal runs of the sorted entries,
// lane k channels k + 8c (g staged in that order): a group sums a row's
// entries' terms in 64-bit integers, each term times 2^k of its row and
// rounded as dv_fixed rounds it, and at the row's end (or its run's) adds each
// nonzero sum into the row's integers with one red.global.add.u64, eight lanes
// on 64 contiguous bytes an instruction. A row that several runs, rounds or
// blocks reach takes several reds; integer sums are the same in any order.
// Term::kScatterBlocks blocks (4 for K1-bwd, 3 for K3-bwd, whose taps take
// more registers) fit an SM, so that one block's waits at its barriers overlap
// the others' work.
constexpr int kScatterThreads = 256;
constexpr int kTileW = 8, kTileH = 8;
constexpr int kTileQ = kTileW * kTileH;                    // queries a scatter block: 64
constexpr int kLinearQ = 16;                               // or, not tiled, 16 in a run
constexpr int kChunkTaps = kScatterThreads;                // taps a round, a thread each
constexpr int kChunkEntries = 4 * kChunkTaps;              // entries a round, at most
constexpr int kSlots = 2 * kChunkEntries;                  // hash slots: half full at most

struct DvEntry {  // 16 bytes, read by a lane group as one broadcast
  float f1, f2;   // the corner's factors (Term::term)
  int key;        // its row's used-slot index u (bits 0-9), the query's index
                  // in the tile (bits 10-15) and the row's shift k + 128 (16-24)
  int pad;
};

struct DvScatterSmem {
  DvEntry entry[kChunkEntries];     // a round's entries, by slot
  float g[kTileQ * kD];             // the tile's g rows, channel k + 8c at 4k + c
  int tag[kSlots];                  // a slot's token, -1 while empty
  int cnt[kSlots];                  // entries a slot; then u << 16 | where its next entry goes
  int row_of[kChunkEntries + 1];    // the used slots in scan order: token,
  int first[kChunkEntries + 1];     // and the first of its entries (then the end)
  int n_used;
};

// The tiles of a call: the levels' kTileW x kTileH patches where tiled, else
// ceil(Q / kLinearQ) runs of queries.
inline long long dv_tiles(const Levels& lv, int Q, bool tiled) {
  if (!tiled) return (Q + kLinearQ - 1) / kLinearQ;
  long long n = 0;
  for (int l = 0; l < lv.n; ++l)
    n += static_cast<long long>((lv.h[l] + kTileH - 1) / kTileH) *
         ((lv.w[l] + kTileW - 1) / kTileW);
  return n;
}

// A block's tile: where tiled, its level's start, width and height and the
// patch's corner; else the run's first query. Worked out once a block.
struct DvTile {
  bool tiled;
  int n;         // queries a tile: kTileQ or kLinearQ
  int q0, Q;     // not tiled: queries q0 .. q0 + kLinearQ - 1, those below Q
  int start, w, h, y0, x0;

  __device__ __forceinline__ DvTile(int tile, int Q_, bool tiled_, const Levels& lv)
      : tiled(tiled_), n(tiled_ ? kTileQ : kLinearQ), q0(tile * kLinearQ), Q(Q_) {
    if (!tiled) return;
    int l = 0;
    for (;; ++l) {
      const int c = ((lv.h[l] + kTileH - 1) / kTileH) * ((lv.w[l] + kTileW - 1) / kTileW);
      if (tile < c || l == lv.n - 1) break;
      tile -= c;
    }
    w = lv.w[l];
    h = lv.h[l];
    start = static_cast<int>(lv.start[l]);
    const int tw = (w + kTileW - 1) / kTileW;
    y0 = (tile / tw) * kTileH;
    x0 = (tile % tw) * kTileW;
  }
  // query i (< n) of the tile, or -1 past the queries
  __device__ __forceinline__ int query(int i) const {
    if (!tiled) return q0 + i < Q ? q0 + i : -1;
    const int y = y0 + i / kTileW, x = x0 + i % kTileW;
    return y < h && x < w ? start + y * w + x : -1;
  }
};

// A slot of a kSlots table of tags for s >= 0: its own, or an empty one
// taken (a table is at most half full, so a free slot is always found).
__device__ __forceinline__ int dv_slot(int* tag, int s) {
  int h = static_cast<int>((static_cast<unsigned>(s) * 2654435761u) >> 21) & (kSlots - 1);
  for (;;) {
    const int old = atomicCAS(&tag[h], -1, s);
    if (old == -1 || old == s) return h;
    h = (h + 1) & (kSlots - 1);
  }
}

// A thread's tap of a round (ct: the tile's tap in (l, query, p) order): the
// tile's query index, and the tap's level, location and weight (q < 0: past
// the tile's taps, no entry).
struct DvTapIn {
  int qi, q, l;
  float2 xy;
  float a;
};

__device__ __forceinline__ DvTapIn dv_tap_in(int ct, int n_taps, const DvTile& tile, int b, int m,
                                             int Q, int M, int P, int lp_n,
                                             const float* __restrict__ loc,
                                             const float* __restrict__ aw) {
  static_assert((kTileQ & (kTileQ - 1)) == 0 && (kLinearQ & (kLinearQ - 1)) == 0, "powers of 2");
  DvTapIn in;
  const int r = ct / P;
  in.qi = r & (tile.n - 1);
  in.l = r / tile.n;
  in.q = ct < n_taps ? tile.query(in.qi) : -1;
  if (in.q >= 0) {
    const long long t =
        ((static_cast<long long>(b) * Q + in.q) * M + m) * lp_n + in.l * P + (ct - r * P);
    in.xy = *reinterpret_cast<const float2*>(loc + 2 * t);
    in.a = aw[t];
  }
  return in;
}

// Step 1: dvalue_count_kernel, on the scatter's tiles and rounds (a thread a
// tap): each keyed tap's key hashed into shared memory and counted there, each
// round's counts added into the keys' with one integer atomic add a key (a hot
// key takes one a round, not one a tap); the call's largest factor bound
// (Term::tap) and largest |g| over the tile's rows (b, q, m) that Term::kAllRows
// or a keyed tap names, one atomic maximum each a block. Counts and maxima
// are the same in every order.
template <typename T, typename Term>
__global__ void __launch_bounds__(kScatterThreads)
dvalue_count_kernel(const float* __restrict__ loc, const float* __restrict__ aw,
                    const T* __restrict__ grad, int* __restrict__ counts,
                    unsigned* __restrict__ maxima, int S, int Q, int M, int P, int tiled,
                    const __grid_constant__ Levels lv, const __grid_constant__ ExtLevels ex) {
  constexpr int kPer = kSlots / kScatterThreads;
  __shared__ int tag[kSlots], cnt[kSlots], keyed[kTileQ];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y / M, m = blockIdx.y % M;
  const int lp_n = lv.n * P;
  const DvTile tile(blockIdx.x, Q, tiled, lv);
  const int n_taps = tile.n * lp_n;
  const long long key0 = static_cast<long long>(b) * ex.total * M + m;  // key = key0 + pos * M
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    tag[tid + kScatterThreads * i] = -1;
    cnt[tid + kScatterThreads * i] = 0;
  }
  if (tid < kTileQ) keyed[tid] = 0;
  __syncthreads();
  unsigned g_bits = 0, f_bits = 0;
  for (int c0 = 0; c0 < n_taps; c0 += kChunkTaps) {
    const DvTapIn in = dv_tap_in(c0 + tid, n_taps, tile, b, m, Q, M, P, lp_n, loc, aw);
    int x0, y0;
    float fb;
    if (in.q >= 0 && Term::tap(in.xy, in.a, in.l, lv, x0, y0, fb)) {
      const int pos = static_cast<int>(ex.start[in.l]) + (y0 + 1) * (lv.w[in.l] + 1) + x0 + 1;
      atomicAdd(&cnt[dv_slot(tag, pos)], 1);
      f_bits = max(f_bits, abs_bits(fb));
      keyed[in.qi] = 1;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int h = tid + kScatterThreads * i;
      if (cnt[h] > 0) atomicAdd(counts + key0 + static_cast<long long>(tag[h]) * M, cnt[h]);
      tag[h] = -1;
      cnt[h] = 0;
    }
    __syncthreads();
  }
  for (int qi = warp; qi < tile.n; qi += kScatterThreads / 32) {  // a warp a query's g row
    const int q = tile.query(qi);
    if (q >= 0 && (Term::kAllRows || keyed[qi])) {
      const T gv = grad[((static_cast<long long>(b) * Q + q) * M + m) * kD + lane];
      g_bits = max(g_bits, abs_bits(to_f32(gv)));
    }
  }
  dv_block_max2<kScatterThreads>(g_bits, f_bits, maxima);
}

template <typename T, typename Term>
__global__ void __launch_bounds__(kScatterThreads, Term::kScatterBlocks)
dvalue_scatter_kernel(const float* __restrict__ loc, const float* __restrict__ aw,
                      const T* __restrict__ grad, const int* __restrict__ shift,
                      const unsigned* __restrict__ maxima, unsigned long long* __restrict__ acc,
                      int S, int Q, int M, int P, int tiled, const __grid_constant__ Levels lv) {
  static_assert(kSlots == 2048 && kD == 32, "the hash takes 11 bits; 8 lanes x 4 channels");
  constexpr int kWarps = kScatterThreads / 32;
  constexpr int kPer = kSlots / kScatterThreads;  // slots a thread scans: tid + 256 i
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DvScatterSmem& sm = *reinterpret_cast<DvScatterSmem*>(smem_raw);
  __shared__ int warp_tot[kWarps];
  if (!(__uint_as_float(maxima[0]) * __uint_as_float(maxima[1]) <= 3.4028235e38f))
    return;  // the bound is not finite: the convert pass writes NaN
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, kk = lane & 7;  // a row's eight lanes; channels kk + 8c
  const int b = blockIdx.y / M, m = blockIdx.y % M;
  const int lp_n = lv.n * P;
  const long long bm = static_cast<long long>(b) * S * M + m;  // row (b, s, m) = bm + s * M
  const DvTile tile(blockIdx.x, Q, tiled, lv);
  const int n_taps = tile.n * lp_n;
  DvTapIn in = dv_tap_in(tid, n_taps, tile, b, m, Q, M, P, lp_n, loc, aw);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    sm.tag[tid + kScatterThreads * i] = -1;
    sm.cnt[tid + kScatterThreads * i] = 0;
  }
#pragma unroll 4
  for (int qi = warp; qi < tile.n; qi += kWarps) {  // a warp a query's g row
    const int q = tile.query(qi);
    sm.g[qi * kD + (lane % 8) * 4 + lane / 8] =
        q < 0 ? 0.f : to_f32(grad[((static_cast<long long>(b) * Q + q) * M + m) * kD + lane]);
  }
  __syncthreads();
  for (int c0 = 0; c0 < n_taps; c0 += kChunkTaps) {
    // Fill: this thread's tap's entries, each row's shift and slot, the counts.
    int s[4], ks[4], slot[4], mask = 0;
    float f1[4], f2[4];
    if (in.q >= 0) mask = Term::entries(in.xy, in.a, in.l, lv, s, f1, f2);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((mask >> e) & 1) ks[e] = shift[bm + static_cast<long long>(s[e]) * M];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((mask >> e) & 1) {
        slot[e] = dv_slot(sm.tag, s[e]);
        atomicAdd(&sm.cnt[slot[e]], 1);
      }
    }
    const int qi = in.qi;
    __syncthreads();
    // Scan, in (thread, i) order of slots tid + 256 i: each used slot's first
    // entry; the used slots listed in that order.
    {
      int n = 0, u = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = sm.cnt[tid + kScatterThreads * i];
        n += v;
        u += v > 0;
      }
      int inc = (n << 16) | u;  // at most 1,024 entries and 1,024 used slots: no carry
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += t;
      }
      if (lane == 31) warp_tot[warp] = inc;
      __syncthreads();
      int run = inc - ((n << 16) | u), total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) run += warp_tot[w];
        total += warp_tot[w];
      }
      int at = run >> 16, ui = run & 0xffff;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int h = tid + kScatterThreads * i, v = sm.cnt[h];
        if (v > 0) {
          sm.row_of[ui] = sm.tag[h];
          sm.first[ui] = at;
          sm.cnt[h] = (ui++ << 16) | at;
        }
        at += v;
      }
      if (tid == 0) {
        sm.n_used = total & 0xffff;
        sm.first[total & 0xffff] = total >> 16;
      }
    }
    __syncthreads();
    // Each entry to its slot's range (in any order within it).
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if ((mask >> e) & 1) {
        const int c = atomicAdd(&sm.cnt[slot[e]], 1);
        DvEntry en;
        en.f1 = f1[e];
        en.f2 = f2[e];
        en.key = (c >> 16) | (qi << 10) | ((ks[e] + 128) << 16);
        sm.entry[c & 0xffff] = en;
      }
    }
    __syncthreads();
    if (c0 + kChunkTaps < n_taps)  // the next round's inputs, in flight while this one sums
      in = dv_tap_in(c0 + kChunkTaps + tid, n_taps, tile, b, m, Q, M, P, lp_n, loc, aw);
    // Lane group j (of 32, eight lanes each) takes entries [j E / 32,
    // (j + 1) E / 32) of the E sorted ones: trip counts within one of each
    // other, so that a warp's four groups run together.
    {
      const int n_ent = sm.first[sm.n_used], j = warp * 4 + grp;
      const int e0 = (n_ent * j) >> 5, e1 = (n_ent * (j + 1)) >> 5;
      const int n_max = __reduce_max_sync(0xffffffffu, e1 - e0);
      int cur = -1;  // the row being summed (used-slot index)
      float s_hi = 1.f, s_lo = 1.f;
      long long sum[4] = {0, 0, 0, 0};
      for (int i = 0; i <= n_max; ++i) {
        const int e = e0 + i;
        DvEntry en;
        en.key = -1;
        if (e < e1) en = sm.entry[e];
        const int u = en.key < 0 ? -1 : (en.key & 0x3ff);
        if (u != cur) {  // the row ends here (or the run): its sums into its integers
          if (cur >= 0) {
            unsigned long long* p =
                acc + (bm + static_cast<long long>(sm.row_of[cur]) * M) * kD + kk;
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (sum[c] != 0) dv_red(p + 8 * c, sum[c]);
          }
          cur = u;
          sum[0] = sum[1] = sum[2] = sum[3] = 0;
          if (u >= 0) dv_scales((en.key >> 16) - 128, s_hi, s_lo);
        }
        if (u >= 0) {
          const float4 g =
              *reinterpret_cast<const float4*>(&sm.g[((en.key >> 10) & 0x3f) * kD + 4 * kk]);
          sum[0] += dv_fixed(Term::term(en.f1, en.f2, g.x), s_hi, s_lo);
          sum[1] += dv_fixed(Term::term(en.f1, en.f2, g.y), s_hi, s_lo);
          sum[2] += dv_fixed(Term::term(en.f1, en.f2, g.z), s_hi, s_lo);
          sum[3] += dv_fixed(Term::term(en.f1, en.f2, g.w), s_hi, s_lo);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      sm.tag[tid + kScatterThreads * i] = -1;
      sm.cnt[tid + kScatterThreads * i] = 0;
    }
    __syncthreads();
  }
}

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

// Four channels of one value row, every element the bits `f32` (float) or
// `bf16` (bfloat16).
__device__ __forceinline__ void fill4(float* p, uint32_t f32, uint32_t) {
  *reinterpret_cast<uint4*>(p) = make_uint4(f32, f32, f32, f32);
}
__device__ __forceinline__ void fill4(__nv_bfloat16* p, uint32_t, uint32_t bf16) {
  const uint32_t pair = bf16 | (bf16 << 16);
  *reinterpret_cast<uint2*>(p) = make_uint2(pair, pair);
}

// Step 4: lane k = i % 8 of row i / 8 takes channels 4k .. 4k + 3.
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
dvalue_convert_kernel(const long long* __restrict__ acc, const int* __restrict__ shift,
                      T* __restrict__ d_value, long long n_rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kPassThreads + threadIdx.x;
  const long long row = i >> 3;
  if (row >= n_rows) return;
  const int k = static_cast<int>(i & 7);
  T* out = d_value + row * kD + 4 * k;
  const int kr = shift[row];
  if (kr == kDvEmpty) {
    fill4(out, 0u, 0u);
  } else if (kr == kDvNaN) {  // quiet NaNs
    fill4(out, 0x7fffffffu, 0x7fffu);
  } else {
    const longlong2* p = reinterpret_cast<const longlong2*>(acc + row * kD + 4 * k);
    const longlong2 lo = p[0], hi = p[1];
    const long long v[4] = {lo.x, lo.y, hi.x, hi.y};
    const int a = max(-kr, -126);  // 2^-k = 2^a * 2^(-k - a), each a normal float
    const float sa = pow2(a), sb = pow2(-kr - a);
    float res[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) res[c] = __ll2float_rn(v[c]) * sa * sb;
    store4(out, res);
  }
}

// Steps 1 and 2 on `stream`: the counts and maxima zeroed, counted, and the
// rows' shifts. The caller then launches its backward kernel, dv_scatter and
// dv_convert.
template <typename T, typename Term>
inline cudaError_t dv_prepare(const DvPlan& p, const float* loc, const float* aw, const T* grad,
                              int B, int S, int Q, int M, int P, const Levels& lv,
                              const ExtLevels& ex, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(p.counts, 0, (p.n_keys + 2) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (Q > 0) {
    const bool tiled = Q == S;
    dvalue_count_kernel<T, Term>
        <<<dim3(static_cast<unsigned>(dv_tiles(lv, Q, tiled)), B * M), kScatterThreads, 0,
           stream>>>(loc, aw, grad, p.counts, p.maxima, S, Q, M, P, tiled, lv, ex);
  }
  dvalue_shift_kernel<<<static_cast<unsigned>((p.n_rows + kPassThreads - 1) / kPassThreads),
                        kPassThreads, 0, stream>>>(p.counts, p.maxima, p.shift, p.acc,
                                                   static_cast<int>(p.n_rows), S, M, lv, ex);
  return cudaGetLastError();
}

// Step 3 on `stream`: the terms into the rows' integers.
template <typename T, typename Term>
inline cudaError_t dv_scatter(const DvPlan& p, const float* loc, const float* aw, const T* grad,
                              int B, int S, int Q, int M, int P, const Levels& lv,
                              cudaStream_t stream) {
  static bool sized = false;  // the kernel's shared memory above 48 KB, once
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(dvalue_scatter_kernel<T, Term>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(sizeof(DvScatterSmem)));
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const bool tiled = Q == S;
  dvalue_scatter_kernel<T, Term>
      <<<dim3(static_cast<unsigned>(dv_tiles(lv, Q, tiled)), B * M), kScatterThreads,
         sizeof(DvScatterSmem), stream>>>(loc, aw, grad, p.shift, p.maxima, p.acc, S, Q, M, P,
                                          tiled, lv);
  return cudaGetLastError();
}

// Step 4 on `stream`, after the scatter.
template <typename T>
inline void dv_convert(const DvPlan& p, T* d_value, cudaStream_t stream) {
  dvalue_convert_kernel<T>
      <<<static_cast<unsigned>((p.n_rows * 8 + kPassThreads - 1) / kPassThreads), kPassThreads, 0,
         stream>>>(reinterpret_cast<const long long*>(p.acc), p.shift, d_value, p.n_rows);
}

}  // namespace msda
