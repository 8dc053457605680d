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
//   d_V[j, i] += hxw_i * d_r_j                               f32 atomics
//
// Layouts: value [B, S, M, 32] (bf16 or f32), loc [B, Q, M, L, P, 2] f32,
// aw [B, Q, M, L, P] f32, g [B, Q, M*32] in the value's dtype; outputs d_value
// [B, S, M, 32] f32 (zeroed by the caller, cast by it to the value's dtype, as
// JAX accumulates d_img in f32 and casts once), d_loc like loc, d_aw like aw.
//
// What bounds it on the card: at the decoder's shapes (B2, Q = 1,100, M8, L4,
// P4) device memory moves value, loc, aw and g once and d_value, d_loc and d_aw
// once, 59 MB (d_value counted in the value's dtype, as the call returns it),
// against 281,600 taps of four gathered corner rows and up to four rows of
// atomic adds, nearly all in L2; decoder queries rarely share a value row, so
// the atomics contend little, but their order still changes from run to run.
//
// Design (K1-bwd's lanes, ms_deform_attn_bwd.cu, with K3's geometry):
// - A warp serves two (b, q, m) rows, one per half-warp, in row-major order.
//   When the rows are odd in number, the last warp's spare half-warp reads
//   the last row's addresses with every tap zeroed, so it adds nothing to
//   d_value, and writes no d_aw or d_loc.
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
// - Each corner row's four channels go into d_value with one float4 atomic
//   (sm_90), skipped where hxw_i or hy_j is 0 (the add would be 0).
//
// The order of the f32 adds into d_value changes from run to run, which moves
// d_value by a few f32 ulps of its magnitude.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"

namespace {

using namespace msda;  // Levels, load4, group_sum, round_cdt, SepTap, sep_tap

constexpr int kThreads = 256;          // 8 warps: 16 rows a block
constexpr int kLanes = 8;              // lanes a tap: 4 channels each
constexpr int kGroups = 16 / kLanes;   // lane groups a row (a half-warp): 2
constexpr int kRounds = 16 / kGroups;  // taps a group takes from a 16-tap chunk: 8
constexpr int kBatch = 2;              // taps whose loads are issued together

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_sep_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ aw, const T* __restrict__ grad,
                    float* __restrict__ d_value, float* __restrict__ d_loc,
                    float* __restrict__ d_aw, long long n_rows, int S, int Q, int M, int P,
                    Levels lv) {
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
    // token 0 and zero factors, so it adds nothing to d_value.
    const int tl = t0 + hl;
    const bool mine = live && tl < lp_n;
    SepTap tap;
    float a = 0.f;
    if (mine) {
      a = aw[r * lp_n + tl];
      tap = sep_tap<T>(*reinterpret_cast<const float2*>(loc + (r * lp_n + tl) * 2), a,
                       tl / P, lv);
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
        float dr[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float hy = j ? h1[i] : h0[i], dy = j ? d1[i] : d0[i];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float v0 = v[i][2 * j][c], v1 = v[i][2 * j + 1][c];
            const float rj = __fadd_rn(__fmul_rn(w0[i], v0), __fmul_rn(w1[i], v1));
            s_y += __fmul_rn(__fmul_rn(g[c], rj), dy);
            dr[j][c] = round_cdt<T>(__fmul_rn(g[c], hy));
            s_h0 += __fmul_rn(dr[j][c], v0);
            s_h1 += __fmul_rn(dr[j][c], v1);
          }
        }
        // corner e = (x0 + (e & 1), y0 + (e >> 1)); an add of 0 is skipped
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float we = (e & 1) ? w1[i] : w0[i];
          const float he = (e >> 1) ? h1[i] : h0[i];
          if (we == 0.f || he == 0.f) continue;
          const float(&d)[4] = dr[e >> 1];
          const long long at = c00[i] + ((e >> 1) * sy[i] + (e & 1) * sx[i]) * tok;
          atomicAdd(reinterpret_cast<float4*>(d_value + at),
                    make_float4(__fmul_rn(we, d[0]), __fmul_rn(we, d[1]),
                                __fmul_rn(we, d[2]), __fmul_rn(we, d[3])));
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
           void* d_value, void* d_loc, void* d_aw, int B, int S, int Q, int M,
           int D, int L, int P, const int* shapes, cudaStream_t stream) {
  Levels lv;
  if (D != kD || !make_levels(lv, L, shapes, S)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * Q * M;
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rows + 2 * (kThreads / 32) - 1) / (2 * (kThreads / 32));
  msda_sep_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const T*>(grad),
      static_cast<float*>(d_value), static_cast<float*>(d_loc), static_cast<float*>(d_aw),
      n_rows, S, Q, M, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; d_value must be zeroed. D must be 32.
// Returns cudaGetLastError() after the launch.
extern "C" int msda_sep_bwd(const void* value, const void* loc, const void* aw,
                            const void* grad, void* d_value, void* d_loc, void* d_aw,
                            int B, int S, int Q, int M, int D, int L, int P,
                            const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, grad, d_value, d_loc, d_aw, B, S,
                                 Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, grad, d_value, d_loc, d_aw, B, S, Q, M, D,
                       L, P, shapes, s);
}
