// K1-bwd: multi-scale deformable attention backward, exact zero-padded bilinear gather.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_pallas2.py:_bwd_kernel
// (behind _bwd_pallas2, the custom VJP of ms_deform_attn_pallas2). That kernel
// differentiates the windowed hat-basis formulation; this one differentiates the
// exact gather that K1 (ms_deform_attn_fwd.cu) computes, i.e. the gradient of
//
//   out[b,q,m,c] = sum_{l,p} aw[b,q,m,l,p] * sum_corners w_k(x,y) * V_l[b, y_k, x_k, m, c]
//
// with x = loc_x * W_l - 0.5, y = loc_y * H_l - 0.5, bilinear corner weights
// w_k and zero contribution from out-of-bounds corners:
//
//   d_value[corner, c] += aw * w_k * g[c]                        (scatter)
//   d_aw[l,p]          = sum_c g[c] * sample[c]
//   d_loc_x            = aw * W_l * sum_c g[c] * dsample/dx[c]
//   d_loc_y            = aw * H_l * sum_c g[c] * dsample/dy[c]
//
// where dsample/dx = (1-dy)(v01 - v00) + dy(v11 - v10) and
// dsample/dy = (1-dx)(v10 - v00) + dx(v11 - v01), out-of-bounds corners read
// as 0 (the floor-based derivative of the JAX exact gather, not the tent
// derivative of the windowed kernel, which is -sign(0) = 0 at integer pixels).
// One kernel serves the clamped encoder and the unclamped decoder; the clamp's
// own gradient is taken outside, by autograd.
//
// Layouts: value [B, S, M, D] (bf16 or f32, D = 32), loc [B, Q, M, L, P, 2] f32,
// aw [B, Q, M, L, P] f32, g [B, Q, M*D] in the value's dtype; outputs
// d_value [B, S, M, D] in the value's dtype (every element written once),
// d_loc like loc, d_aw like aw; an int32 workspace of msda_bwd_workspace()
// words.
//
// What bounds it. At the encoder shapes (B2, Q = S = 24,990, M8, L4, P4, D32)
// a call has 6.40 M taps, i.e. 25.6 M corner rows of 32 channels to gather
// for the tap's sums and to add into d_value (819 M terms), nearly all in L2
// (value and g are 25.6 MB each in bf16). Each tap is a dependent chain
// (location -> corner addresses -> four row reads -> products), so the tap
// kernel is bound by how many taps are in flight and by L2 traffic, far from
// the bytes bound of the call's inputs and outputs; the d_value pass
// (msda_dvalue.cuh) by its 64-bit fixed-point terms, one conversion each, and
// by the reds of the rows' sums.
//
// Design. msda_bwd_kernel: a block serves one (b, m) and kTile = 16 queries.
// Eight lanes serve one tap, four channels a lane (8- or 16-byte loads), so a
// warp takes four taps at once and reduces d_aw and d_loc over 8 lanes (3
// shuffles each, a fixed tree); the tap's first lane writes them. It writes
// nothing for d_value.
//
// d_value is summed in msda_dvalue.cuh's deterministic pass, with this file's
// Term: a count kernel gives each value row its fixed-point shift, and a
// scatter kernel sums each row's terms, (w_k * a) * g[c] times 2^k rounded to
// an integer, by tiles of 8 x 8 encoder queries in shared memory and adds the
// sums into the row's 64-bit integers with red.global.add.u64. Integer sums
// are the same in every order, so two calls on the same inputs give the same
// d_value bit for bit (the TPU kernel adds in a fixed order too, into
// per-tile windows), and the same bits as a pass that lists the taps by
// corner and gathers each row's terms. Float4 atomic adds into an f32 d_value
// changed their order from run to run; a red a term from this kernel (819 M
// at the encoder) cost more than the kernel; a windowed design (a counting
// sort of a block's corners by pixel, 64-query tiles) took twice as long.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"
#include "msda_dvalue.cuh"

namespace {

using namespace msda;  // Levels, load4, the tap geometry, group_sum, the d_value pass; kD = 32

constexpr int kLanes = 8;       // lanes a tap: 4 channels each
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanes;
constexpr int kTile = 16;       // queries a block

// A d_value term of K1-bwd: (w_e * a) * g[c], as the plain version's autograd
// forms it; the tap's factors are (w_0 a, w_1 a, w_2 a, w_3 a).
struct Term {
  static constexpr bool kAllRows = false;  // max|g| over the rows with a keyed tap
  static constexpr int kScatterBlocks = 4;  // scatter blocks an SM (msda_dvalue.cuh)
  __device__ __forceinline__ static float factor(float w, float a) { return __fmul_rn(w, a); }
  __device__ __forceinline__ static float term(float f, float, float g) { return __fmul_rn(g, f); }
  // A keyed tap's top-left corner and bound, at least |w_e a| for every
  // corner, so that max|g| times it bounds the terms; false for a tap with no
  // corner in its level.
  __device__ __forceinline__ static bool tap(float2 xy, float a, int l, const Levels& lv,
                                             int& x0, int& y0, float& bound) {
    const int h = lv.h[l], w = lv.w[l];
    const float x = pixel(xy.x, w), y = pixel(xy.y, h);
    if (!inside(x, y, h, w)) return false;
    const Corners cr = corners(x, y, h, w);
    x0 = cr.x0;
    y0 = cr.y0;
    bound = fmaxf(fmaxf(fabsf(factor(cr.wk[0], a)), fabsf(factor(cr.wk[1], a))),
                  fmaxf(fabsf(factor(cr.wk[2], a)), fabsf(factor(cr.wk[3], a))));
    return true;
  }
  // A tap's entries: each in-level corner e whose factor is not 0 (a term of
  // 0 adds nothing), its token s[e] and factor f1[e]. -> their mask.
  __device__ __forceinline__ static int entries(float2 xy, float a, int l, const Levels& lv,
                                                int (&s)[4], float (&f1)[4], float (&f2)[4]) {
    const int h = lv.h[l], w = lv.w[l];
    const float x = pixel(xy.x, w), y = pixel(xy.y, h);
    if (!inside(x, y, h, w)) return 0;
    const Corners cr = corners(x, y, h, w);
    int mask = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f1[e] = factor(cr.wk[e], a);
      f2[e] = 0.f;
      s[e] = static_cast<int>(lv.start[l]) + (cr.y0 + (e >> 1)) * w + cr.x0 + (e & 1);
      if (cr.in[e] && f1[e] != 0.f) mask |= 1 << e;
    }
    return mask;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const T* __restrict__ grad,
                float* __restrict__ d_loc, float* __restrict__ d_aw, int S, int Q, int M, int P,
                Levels lv) {
  const int tid = threadIdx.x;
  const int b = blockIdx.y / M;
  const int m = blockIdx.y % M;
  const int lp_n = lv.n * P;
  const int n_taps = kTile * lp_n;
  const long long row_stride = static_cast<long long>(M) * kD;
  const long long vbase = static_cast<long long>(b) * S * row_stride + static_cast<long long>(m) * kD;

  // Eight lanes a tap, channels 4k .. 4k + 3 on lane k; the four taps of a warp
  // run the loop together (group_sum below).
  const int k = tid % kLanes;
  for (int t = tid / kLanes; t < n_taps; t += kGroups) {
    const int q = blockIdx.x * kTile + t / lp_n;
    const bool live = q < Q;
    const int lp = t % lp_n, l = lp / P;
    const int h = lv.h[l], w = lv.w[l];
    float x = -2.f, y = -2.f, a = 0.f;
    long long tap = 0;
    if (live) {
      // rounded as the plain version rounds it: the bilinear derivative jumps at
      // integer pixels
      tap = ((static_cast<long long>(b) * Q + q) * M + m) * lp_n + lp;
      x = pixel(loc[2 * tap], w);
      y = pixel(loc[2 * tap + 1], h);
      a = aw[tap];
    }
    float s_aw = 0.f, s_x = 0.f, s_y = 0.f;
    if (live && inside(x, y, h, w)) {  // else every corner is out
      float g[4];
      load4(grad + ((static_cast<long long>(b) * Q + q) * M + m) * kD + 4 * k, g);
      const Corners cr = corners(x, y, h, w);
      const float dx = cr.dx, dy = cr.dy;
      const bool(&in)[4] = cr.in;
      const float(&wk)[4] = cr.wk;
      const int cx[4] = {cr.x0, cr.x0 + 1, cr.x0, cr.x0 + 1};
      const int cy[4] = {cr.y0, cr.y0, cr.y0 + 1, cr.y0 + 1};
      const long long lbase = vbase + lv.start[l] * row_stride;
      float v[4][4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (in[c]) {
          load4(value + lbase + (static_cast<long long>(cy[c]) * w + cx[c]) * row_stride + 4 * k,
                v[c]);
        } else {
          v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s_aw += g[i] * (wk[0] * v[0][i] + wk[1] * v[1][i] + wk[2] * v[2][i] + wk[3] * v[3][i]);
        s_x += g[i] * ((1.f - dy) * (v[1][i] - v[0][i]) + dy * (v[3][i] - v[2][i]));
        s_y += g[i] * ((1.f - dx) * (v[2][i] - v[0][i]) + dx * (v[3][i] - v[1][i]));
      }
    }
    s_aw = group_sum(s_aw);
    s_x = group_sum(s_x);
    s_y = group_sum(s_y);
    if (k == 0 && live) {
      d_aw[tap] = s_aw;
      d_loc[2 * tap] = a * s_x * w;
      d_loc[2 * tap + 1] = a * s_y * h;
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
  const long long n_rows = static_cast<long long>(B) * S * M;
  const long long n_keys = B * ex.total * M;
  DvPlan plan;
  if (!make_plan(plan, ws, n_rows, n_keys) || ws_words < dv_words(n_rows, n_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = dv_prepare<T, Term>(plan, static_cast<const float*>(loc),
                                        static_cast<const float*>(aw), static_cast<const T*>(grad),
                                        B, S, Q, M, P, lv, ex, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (Q > 0) {
    msda_bwd_kernel<T><<<dim3((Q + kTile - 1) / kTile, B * M), kThreads, 0, stream>>>(
        static_cast<const T*>(value), static_cast<const float*>(loc),
        static_cast<const float*>(aw), static_cast<const T*>(grad),
        static_cast<float*>(d_loc), static_cast<float*>(d_aw), S, Q, M, P, lv);
    err = dv_scatter<T, Term>(plan, static_cast<const float*>(loc), static_cast<const float*>(aw),
                              static_cast<const T*>(grad), B, S, Q, M, P, lv, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dv_convert<T>(plan, static_cast<T*>(d_value), stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The int32 words of the workspace msda_bwd takes; -1 for a bad pyramid.
extern "C" long long msda_bwd_workspace(int B, int S, int Q, int M, int L, int P,
                                        const int* shapes) {
  Levels lv;
  if (!make_levels(lv, L, shapes, S)) return -1;
  return dv_words(static_cast<long long>(B) * S * M, B * make_ext(lv).total * M);
}

// shapes: host array of L (h, w) pairs; D must be 32; ws: msda_bwd_workspace()
// int32 words. Returns cudaGetLastError() after the launches.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
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
