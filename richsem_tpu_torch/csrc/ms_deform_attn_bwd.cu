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
// d_value [B, S, M, D] f32 (zeroed by the caller, cast by it afterwards),
// d_loc like loc, d_aw like aw.
//
// What bounds it. At the encoder shapes (B2, Q = S = 24,990, M8, L4, P4, D32)
// a call has 6.40 M taps, i.e. 25.6 M corner rows of 32 channels to gather and
// to add into d_value (819 M f32 adds), nearly all in L2 (value and d_value
// are 25.6 and 51 MB). Each tap is a dependent chain (location -> corner
// addresses -> four row reads -> products -> adds), so the kernel is bound by
// how many taps are in flight and by the L2 traffic of the reads and adds, far
// from the bytes bound of the call's inputs and outputs.
//
// Design. A block serves one (b, m) and kTile = 16 queries. Eight lanes serve
// one tap, four channels a lane (8- or 16-byte loads), so a warp takes four
// taps at once, reduces d_aw and d_loc over 8 lanes (3 shuffles each) and adds
// each corner's four channels with one float4 atomic (sm_90): 4x fewer atomic
// instructions than one channel a lane, and no shuffles over 32 lanes.
//
// Every corner goes to d_value directly, not through the TPU kernel's per-tile
// d_value windows (_bwd_kernel's dwin_refs): Hopper has no shared-memory f32
// atomic add, so a window needs a counting sort of the block's corners by
// pixel and a gather, and pays only with 64-query tiles (4x fewer blocks in
// flight); made exact that way, it took twice as long on an H100 (PERF.md).
//
// The order of the f32 adds into d_value changes from run to run, which moves
// d_value by a few f32 ulps of its magnitude.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"

namespace {

using namespace msda;  // Levels, load4, the tap geometry, group_sum; kD = 32

constexpr int kLanes = 8;       // lanes a tap: 4 channels each
constexpr int kThreads = 256;
constexpr int kGroups = kThreads / kLanes;
constexpr int kTile = 16;       // queries a block

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, const T* __restrict__ grad,
                float* __restrict__ d_value, float* __restrict__ d_loc,
                float* __restrict__ d_aw, int S, int Q, int M, int P, Levels lv) {
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
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!in[c]) continue;
        atomicAdd(reinterpret_cast<float4*>(
                      d_value + lbase + (static_cast<long long>(cy[c]) * w + cx[c]) * row_stride +
                      4 * k),
                  make_float4(a * g[0] * wk[c], a * g[1] * wk[c], a * g[2] * wk[c],
                              a * g[3] * wk[c]));
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
           void* d_value, void* d_loc, void* d_aw, int B, int S, int Q, int M,
           int D, int L, int P, const int* shapes, cudaStream_t stream) {
  Levels lv;
  if (D != kD || B * M > 65535 || !make_levels(lv, L, shapes, S))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * Q * M == 0) return static_cast<int>(cudaSuccess);
  msda_bwd_kernel<T><<<dim3((Q + kTile - 1) / kTile, B * M), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const T*>(grad),
      static_cast<float*>(d_value), static_cast<float*>(d_loc), static_cast<float*>(d_aw), S,
      Q, M, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; d_value must be zeroed. D must be 32.
// Returns cudaGetLastError() after the launch.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
                        const void* grad, void* d_value, void* d_loc, void* d_aw,
                        int B, int S, int Q, int M, int D, int L, int P,
                        const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, grad, d_value, d_loc, d_aw, B, S, Q, M, D, L,
                                 P, shapes, s);
  return launch<float>(value, loc, aw, grad, d_value, d_loc, d_aw, B, S, Q, M, D, L, P, shapes,
                       s);
}
