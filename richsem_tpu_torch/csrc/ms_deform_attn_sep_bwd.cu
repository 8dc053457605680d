// K3-bwd: separable deformable attention of the decoder, backward.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_sep_pallas.py:_bwd_kernel
// (behind _bwd_impl, the custom VJP of ms_deform_attn_sep_pallas). That kernel
// differentiates the dense hat-basis products of the forward (K3,
// ms_deform_attn_sep_fwd.cu) with more dense products and carries d_img across
// its sequential row-chunk grid. Only two x-taps and two y-taps of each hat are
// nonzero, so this kernel visits those four corners per (b, q, m, l, p) and
// rounds where the TPU kernel rounds (cdt = bf16 for a bf16 value, else f32; g
// is rounded to cdt first, :122, which the caller's cast to the value's dtype
// does):
//
//   hx_i  = max(0, 1 - |x - i|),  hxw_i = cdt(hx_i * aw)    i in {x0, x0+1} in range
//   hy_j  = max(0, 1 - |y - j|)                             j in {y0, y0+1} in range
//   dhat(c, i) = -sign(c - i) if |c - i| < 1 else 0         (0 at |c - i| = 0 and 1)
//   r_j   = hxw_x0 * V[j, x0] + hxw_x1 * V[j, x1]            f32
//   d_loc_y = H * sum_{j,d} g * r_j * dhat(y, j)
//   d_r_j   = cdt(g * hy_j)
//   d_hxw_i = sum_{j,d} d_r_j * V[j, i]                      f32
//   d_aw    = sum_i d_hxw_i * hx_i
//   d_loc_x = W * aw * sum_i d_hxw_i * dhat(x, i)
//   d_V[j, i] = sum of hxw_i * d_r_j over the taps           fixed point
//
// Layouts: value [B, S, M, 32] (bf16 or f32), loc [B, Q, M, L, P, 2] f32,
// aw [B, Q, M, L, P] f32, g [B, Q, M*32] in the value's dtype; outputs d_value
// [B, S, M, 32] in the value's dtype (each element summed exactly and rounded
// once, as JAX accumulates d_img in f32 and casts once), d_loc like loc, d_aw
// like aw; an int32 workspace of msda_sep_bwd_workspace() words.
//
// What bounds it on the card: at the decoder's shapes (B2, Q = 1,100, M8, L4,
// P4) device memory moves value, loc, aw and g once and d_value, d_loc and d_aw
// once, 59 MB (d_value counted in the value's dtype, as the call returns it),
// against 281,600 taps of four gathered corner rows, nearly all in L2, and the
// d_value pass over every value row: the rows' 64-bit integers zeroed, added
// into and read, 102 MB each way, and 36 M fixed-point terms, whose rows the
// decoder's queries share little, so that nearly every term's row takes its
// own 64-bit reds.
//
// Design (K1-bwd's lanes, ms_deform_attn_bwd.cu, with K3's geometry):
// - A warp serves two (b, q, m) rows, one per half-warp, in row-major order.
//   When the rows are odd in number, the last warp's spare half-warp reads
//   the last row's addresses with every tap zeroed, so it adds nothing, and
//   writes no d_aw or d_loc.
// - The lane that loads a tap computes its geometry once (msda_common.cuh:
//   sep_tap, as K3 does) and keeps hx_i, dhat(x, i) and aw for the tap's
//   outputs. Every factor of an out-of-range corner or tap is 0: hy, dhat(y,
//   j), hx_i, dhat(x, i) and hxw_i, so no term that the TPU kernel's dense
//   basis lacks reaches d_loc.
// - Eight lanes serve a tap, four channels each (8- or 16-byte loads), so a
//   half-warp takes two taps of its row at once and a row's 16 taps in eight
//   rounds; g's four channels of a lane are loaded once a row.
// - Corner loads are issued unconditionally from clamped addresses for a batch
//   of two taps before the first product.
// - The three sums are reduced over the 8 lanes (3 shuffle steps each), and
//   the lane that loaded the tap takes them and writes d_aw and d_loc:
//   coalesced, one row's taps by one half-warp.
// - d_value is summed in msda_dvalue.cuh's deterministic pass with this
//   file's Term: the terms hxw_i * d_r_j of each in-range corner, in fixed
//   point, summed by row and added into the rows' 64-bit integers, so that
//   two calls on the same inputs give the same d_value bit for bit, as the
//   TPU kernel, which adds over its grid in program order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"
#include "msda_dvalue.cuh"

namespace {

using namespace msda;  // Levels, load4, group_sum, round_cdt, SepTap, sep_tap, the d_value pass

constexpr int kThreads = 256;          // 8 warps: 16 rows a block
constexpr int kLanes = 8;              // lanes a tap: 4 channels each
constexpr int kGroups = 16 / kLanes;   // lane groups a row (a half-warp): 2
constexpr int kRounds = 16 / kGroups;  // taps a group takes from a 16-tap chunk: 8
constexpr int kBatch = 2;              // taps whose loads are issued together

// A d_value term of K3-bwd: hxw_i * cdt(g[c] * hy_j) for corner e = (i, j) =
// (e & 1, e >> 1), with the factors of msda_common.cuh:sep_tap.
template <typename T>
struct Term {
  static constexpr bool kAllRows = true;  // max|g| over every row
  static constexpr int kScatterBlocks = 3;  // scatter blocks an SM (msda_dvalue.cuh)
  __device__ __forceinline__ static float term(float hxw, float hy, float g) {
    return __fmul_rn(hxw, round_cdt<T>(__fmul_rn(g, hy)));
  }
  // A keyed tap's top-left corner and bound, at least |hxw_i| |hy_j| for
  // every corner, so that max|g| times it bounds the terms but for the
  // rounding of cdt(g * hy_j); false for a tap with no corner in its level.
  __device__ __forceinline__ static bool tap(float2 xy, float a, int l, const Levels& lv,
                                             int& x0, int& y0, float& bound) {
    const float x = pixel(xy.x, lv.w[l]), y = pixel(xy.y, lv.h[l]);
    if (!inside(x, y, lv.h[l], lv.w[l])) return false;
    const SepTap t = sep_tap<T>(xy, a, l, lv);
    x0 = static_cast<int>(floorf(x));
    y0 = static_cast<int>(floorf(y));
    bound = fmaxf(fabsf(t.hxw[0]), fabsf(t.hxw[1])) * fmaxf(fabsf(t.hy[0]), fabsf(t.hy[1]));
    return true;
  }
  // A tap's entries: each in-range corner e = (i, j) whose factors hxw_i and
  // hy_j are not 0 (a term of 0 adds nothing), its token s[e] and factors.
  // -> their mask.
  __device__ __forceinline__ static int entries(float2 xy, float a, int l, const Levels& lv,
                                                int (&s)[4], float (&f1)[4], float (&f2)[4]) {
    const int h = lv.h[l], w = lv.w[l];
    const float x = pixel(xy.x, w), y = pixel(xy.y, h);
    if (!inside(x, y, h, w)) return 0;
    const SepTap t = sep_tap<T>(xy, a, l, lv);
    const int x0 = static_cast<int>(floorf(x)), y0 = static_cast<int>(floorf(y));
    int mask = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cx = x0 + (e & 1), cy = y0 + (e >> 1);
      f1[e] = t.hxw[e & 1];
      f2[e] = t.hy[e >> 1];
      s[e] = static_cast<int>(lv.start[l]) + cy * w + cx;
      if (cx >= 0 && cx < w && cy >= 0 && cy < h && f1[e] != 0.f && f2[e] != 0.f) mask |= 1 << e;
    }
    return mask;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_sep_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ aw, const T* __restrict__ grad,
                    float* __restrict__ d_loc, float* __restrict__ d_aw, long long n_rows,
                    int S, int Q, int M, int P, Levels lv) {
  static_assert(kRounds % kBatch == 0, "batches split the rounds");
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (2 * warp >= n_rows) return;  // uniform across the warp
  const long long row = 2 * warp + (lane >> 4);  // (b, q, m), row-major
  const bool live = row < n_rows;
  const long long r = live ? row : n_rows - 1;  // a spare half-warp's taps are zero
  const int hl = lane & 15, grp = hl / kLanes, k = hl % kLanes;
  const int m = static_cast<int>(r % M);
  const long long b = r / M / Q;
  const int lp_n = lv.n * P;
  const long long tok = static_cast<long long>(M) * kD;  // elements a token
  const long long vrow = b * S * tok + static_cast<long long>(m) * kD + 4 * k;

  float g[4];
  load4(grad + r * kD + 4 * k, g);

  for (int t0 = 0; t0 < lp_n; t0 += 16) {
    // Lane l loads tap t0 + (l & 15) of its row and computes its geometry
    // (msda_common.cuh:sep_tap), keeping hat(x, i), dhat(x, i) and aw for the
    // tap's outputs. A tap past the row's taps, or of a spare half-warp, keeps
    // token 0 and zero factors, so it adds nothing.
    const int tl = t0 + hl;
    const bool mine = live && tl < lp_n;
    SepTap tap;
    float a = 0.f;
    if (mine) {
      a = aw[r * lp_n + tl];
      const float2 xy = *reinterpret_cast<const float2*>(loc + (r * lp_n + tl) * 2);
      const int l = tl / P;
      tap = sep_tap<T>(xy, a, l, lv);
    }
    float my_y = 0.f, my_h0 = 0.f, my_h1 = 0.f;  // this lane's tap's three sums
#pragma unroll
    for (int r0 = 0; r0 < kRounds; r0 += kBatch) {
      float v[kBatch][4][4];
      long long c00[kBatch];
      int sx[kBatch], sy[kBatch];
      float w0[kBatch], w1[kBatch], h0[kBatch], h1[kBatch], d0[kBatch], d1[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int src_lane = (lane & 16) | ((r0 + i) * kGroups + grp);
        const int t = __shfl_sync(0xffffffffu, tap.tok, src_lane);
        const int step = __shfl_sync(0xffffffffu, tap.step, src_lane);
        w0[i] = __shfl_sync(0xffffffffu, tap.hxw[0], src_lane);
        w1[i] = __shfl_sync(0xffffffffu, tap.hxw[1], src_lane);
        h0[i] = __shfl_sync(0xffffffffu, tap.hy[0], src_lane);
        h1[i] = __shfl_sync(0xffffffffu, tap.hy[1], src_lane);
        d0[i] = __shfl_sync(0xffffffffu, tap.dy[0], src_lane);
        d1[i] = __shfl_sync(0xffffffffu, tap.dy[1], src_lane);
        sx[i] = step & 1;
        sy[i] = step >> 1;
        c00[i] = vrow + static_cast<long long>(t) * tok;
        load4(value + c00[i], v[i][0]);
        load4(value + c00[i] + sx[i] * tok, v[i][1]);
        load4(value + c00[i] + sy[i] * tok, v[i][2]);
        load4(value + c00[i] + (sy[i] + sx[i]) * tok, v[i][3]);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        float s_y = 0.f, s_h0 = 0.f, s_h1 = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float hy = j ? h1[i] : h0[i], dy = j ? d1[i] : d0[i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v0 = v[i][2 * j][c], v1 = v[i][2 * j + 1][c];
            const float rj = __fadd_rn(__fmul_rn(w0[i], v0), __fmul_rn(w1[i], v1));
            s_y += __fmul_rn(__fmul_rn(g[c], rj), dy);
            const float dr = round_cdt<T>(__fmul_rn(g[c], hy));  // d_r_j
            s_h0 += __fmul_rn(dr, v0);
            s_h1 += __fmul_rn(dr, v1);
          }
        }
        s_y = group_sum(s_y);
        s_h0 = group_sum(s_h0);
        s_h1 = group_sum(s_h1);
        // the lanes that loaded this round's taps (2 (r0 + i) + group) take the sums
        const int from = (lane & 16) | ((hl & 1) * kLanes);
        s_y = __shfl_sync(0xffffffffu, s_y, from);
        s_h0 = __shfl_sync(0xffffffffu, s_h0, from);
        s_h1 = __shfl_sync(0xffffffffu, s_h1, from);
        if ((hl >> 1) == r0 + i) my_y = s_y, my_h0 = s_h0, my_h1 = s_h1;
      }
    }
    if (mine) {
      const long long at = r * lp_n + tl;
      const int l = tl / P;
      d_aw[at] = my_h0 * tap.hx[0] + my_h1 * tap.hx[1];
      *reinterpret_cast<float2*>(d_loc + 2 * at) =
          make_float2((my_h0 * tap.dx[0] + my_h1 * tap.dx[1]) * a * static_cast<float>(lv.w[l]),
                      my_y * static_cast<float>(lv.h[l]));
    }
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* aw, const void* grad,
           void* d_value, void* d_loc, void* d_aw, void* ws, long long ws_words, int B,
           int S, int Q, int M, int D, int L, int P, const int* shapes, cudaStream_t stream) {
  Levels lv;
  if (D != kD || B * M > 65535 || !make_levels(lv, L, shapes, S))
    return static_cast<int>(cudaErrorInvalidValue);
  const ExtLevels ex = make_ext(lv);
  const long long n_rows = static_cast<long long>(B) * Q * M;
  const long long v_rows = static_cast<long long>(B) * S * M;
  const long long n_keys = B * ex.total * M;
  DvPlan plan;
  if (!make_plan(plan, ws, v_rows, n_keys) || ws_words < dv_words(v_rows, n_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  if (v_rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = dv_prepare<T, Term<T>>(plan, static_cast<const float*>(loc),
                                           static_cast<const float*>(aw),
                                           static_cast<const T*>(grad), B, S, Q, M, P, lv, ex,
                                           stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows > 0) {
    const long long blocks = (n_rows + 2 * (kThreads / 32) - 1) / (2 * (kThreads / 32));
    msda_sep_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<const T*>(grad),
        static_cast<float*>(d_loc), static_cast<float*>(d_aw), n_rows, S, Q, M, P, lv);
    err = dv_scatter<T, Term<T>>(plan, static_cast<const float*>(loc),
                                 static_cast<const float*>(aw), static_cast<const T*>(grad), B, S,
                                 Q, M, P, lv, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dv_convert<T>(plan, static_cast<T*>(d_value), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int32 words of the workspace msda_sep_bwd takes; -1 for a bad pyramid.
extern "C" long long msda_sep_bwd_workspace(int B, int S, int Q, int M, int L, int P,
                                            const int* shapes) {
  Levels lv;
  if (!make_levels(lv, L, shapes, S)) return -1;
  return dv_words(static_cast<long long>(B) * S * M, B * make_ext(lv).total * M);
}

// shapes: host array of L (h, w) pairs; D must be 32; ws: msda_sep_bwd_workspace()
// int32 words. Returns cudaGetLastError() after the launches.
extern "C" int msda_sep_bwd(const void* value, const void* loc, const void* aw,
                            const void* grad, void* d_value, void* d_loc, void* d_aw, void* ws,
                            long long ws_words, int B, int S, int Q, int M, int D, int L, int P,
                            const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, grad, d_value, d_loc, d_aw, ws, ws_words, B,
                                 S, Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, grad, d_value, d_loc, d_aw, ws, ws_words, B, S, Q, M,
                       D, L, P, shapes, s);
}
