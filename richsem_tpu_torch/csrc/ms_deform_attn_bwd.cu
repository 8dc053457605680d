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
// Layouts: value [B, S, M, D] (bf16 or f32), loc [B, Q, M, L, P, 2] f32,
// aw [B, Q, M, L, P] f32, g [B, Q, M*D] in the value's dtype; outputs
// d_value [B, S, M, D] f32 (zeroed by the caller, cast by it afterwards),
// d_loc like loc, d_aw like aw.
//
// Design: one warp per (b, q, m), lanes over D, as K1. Per tap the warp reads
// the four corner rows (D contiguous values each), forms the three per-channel
// products, reduces them across the warp with shuffles, and scatters
// aw * w_k * g into the f32 d_value with atomicAdd. What bounds it on the card:
// the gathered corner reads and the scattered atomic adds, B*Q*M*L*P*4 of each
// per channel; at the encoder shapes (B2, Q=S=24,990, M8, L4, P4, D32) that is
// 51 M corner rows read and 51 M rows of 32 atomics, nearly all in L2 (value
// and d_value are 25.6 and 51 MB). Encoder queries near each other hit the same
// value rows, so the atomics contend; the order of the f32 adds changes from
// run to run, which moves d_value by a few f32 ulps of its magnitude. Device
// memory traffic proper is value, loc, aw, g read once and d_value (f32),
// d_loc, d_aw written once. Sorting taps by row, or accumulating d_value per
// query tile in shared memory, is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kMaxLevels = 8;

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void msda_bwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ aw,
                                const T* __restrict__ grad,
                                float* __restrict__ d_value,
                                float* __restrict__ d_loc,
                                float* __restrict__ d_aw,
                                long long n_warps, int S, int Q, int M, int D,
                                int P, Levels lv) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // uniform across the warp
  const int m = static_cast<int>(warp % M);
  const long long b = warp / M / Q;
  const int lp = lv.n * P;
  const float* locw = loc + warp * lp * 2;
  const float* aww = aw + warp * lp;
  const T* gw = grad + warp * D;
  float* dlocw = d_loc + warp * lp * 2;
  float* daww = d_aw + warp * lp;
  const long long row_stride = static_cast<long long>(M) * D;
  const long long base = b * S * row_stride + static_cast<long long>(m) * D;

  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const long long lbase = base + lv.start[l] * row_stride;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      // Rounded as PyTorch rounds loc * size - 0.5 (no fused multiply-add):
      // the bilinear derivative jumps at integer pixels, so a sample one ulp
      // across one must fall on the same side as in the plain version.
      const float x = __fsub_rn(__fmul_rn(locw[2 * i], static_cast<float>(w)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locw[2 * i + 1], static_cast<float>(h)), 0.5f);
      const float a = aww[i];
      float s_aw = 0.f, s_x = 0.f, s_y = 0.f;
      if (x > -1.f && x < w && y > -1.f && y < h) {  // else every corner is out
        const float xf = floorf(x);
        const float yf = floorf(y);
        const float dx = x - xf;
        const float dy = y - yf;
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const bool in00 = y0 >= 0 && x0 >= 0;
        const bool in01 = y0 >= 0 && x0 + 1 < w;
        const bool in10 = y0 + 1 < h && x0 >= 0;
        const bool in11 = y0 + 1 < h && x0 + 1 < w;
        const long long r00 = lbase + (static_cast<long long>(y0) * w + x0) * row_stride;
        const long long r01 = r00 + row_stride;
        const long long r10 = r00 + static_cast<long long>(w) * row_stride;
        const long long r11 = r10 + row_stride;
        const float w00 = (1.f - dy) * (1.f - dx), w01 = (1.f - dy) * dx;
        const float w10 = dy * (1.f - dx), w11 = dy * dx;
        for (int c = lane; c < D; c += 32) {
          const float g = to_f32(gw[c]);
          const float v00 = in00 ? to_f32(value[r00 + c]) : 0.f;
          const float v01 = in01 ? to_f32(value[r01 + c]) : 0.f;
          const float v10 = in10 ? to_f32(value[r10 + c]) : 0.f;
          const float v11 = in11 ? to_f32(value[r11 + c]) : 0.f;
          s_aw += g * (w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11);
          s_x += g * ((1.f - dy) * (v01 - v00) + dy * (v11 - v10));
          s_y += g * ((1.f - dx) * (v10 - v00) + dx * (v11 - v01));
          const float ag = a * g;
          if (in00) atomicAdd(d_value + r00 + c, ag * w00);
          if (in01) atomicAdd(d_value + r01 + c, ag * w01);
          if (in10) atomicAdd(d_value + r10 + c, ag * w10);
          if (in11) atomicAdd(d_value + r11 + c, ag * w11);
        }
      }
      s_aw = warp_sum(s_aw);
      s_x = warp_sum(s_x);
      s_y = warp_sum(s_y);
      if (lane == 0) {
        daww[i] = s_aw;
        dlocw[2 * i] = a * s_x * w;
        dlocw[2 * i + 1] = a * s_y * h;
      }
    }
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* aw, const void* grad,
           void* d_value, void* d_loc, void* d_aw, int B, int S, int Q, int M,
           int D, int L, int P, const int* shapes, cudaStream_t stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  lv.n = L;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  if (start != S) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_warps = static_cast<long long>(B) * Q * M;
  if (n_warps == 0) return static_cast<int>(cudaSuccess);
  constexpr int kThreads = 256;
  const long long blocks = (n_warps * 32 + kThreads - 1) / kThreads;
  msda_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const T*>(grad),
      static_cast<float*>(d_value), static_cast<float*>(d_loc),
      static_cast<float*>(d_aw), n_warps, S, Q, M, D, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; d_value must be zeroed. Returns
// cudaGetLastError() after the launch.
extern "C" int msda_bwd(const void* value, const void* loc, const void* aw,
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
