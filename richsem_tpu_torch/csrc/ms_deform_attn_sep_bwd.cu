// K3-bwd: separable deformable attention of the decoder, backward.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_sep_pallas.py:_bwd_kernel
// (behind _bwd_impl, the custom VJP of ms_deform_attn_sep_pallas). That kernel
// differentiates the dense hat-basis products of the forward (K3,
// ms_deform_attn_sep_fwd.cu) with more dense products and carries d_img across
// its sequential row-chunk grid. Only two x-taps and two y-taps of each hat are
// nonzero, so this kernel visits those four taps per (b, q, m, l, p) and rounds
// where the TPU kernel rounds (cdt = bf16 for a bf16 value, else f32; g is
// rounded to cdt first, :122):
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
// Layouts: value [B, S, M, D] (bf16 or f32), loc [B, Q, M, L, P, 2] f32,
// aw [B, Q, M, L, P] f32, g [B, Q, M*D] in the value's dtype; outputs d_value
// [B, S, M, D] f32 (zeroed by the caller, cast by it to the value's dtype, as
// JAX accumulates d_img in f32 and casts once), d_loc like loc, d_aw like aw.
//
// Design: one warp per (b, q, m), lanes over D, as K1-bwd: per tap the warp
// reads up to four value rows (D contiguous values each), forms the per-channel
// products, reduces the three per-tap sums across the warp with shuffles, and
// adds hxw * d_r into the f32 d_value with atomicAdd. What bounds it on the
// card: at the decoder's shapes (B2, Q = 1,100, M8, L4, P4, D32) device memory
// moves value, loc, aw and g once and d_value (51 MB f32), d_loc and d_aw once,
// ~59 MB, against 563 K taps of four gathered rows and four rows of 32 atomics,
// nearly all in L2; decoder queries rarely share a value row, so the atomics
// contend little, but their order still changes from run to run.

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

template <typename T> __device__ __forceinline__ float round_cdt(float v);
template <> __device__ __forceinline__ float round_cdt<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_cdt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float hat(float c, int i) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, static_cast<float>(i)))));
}

__device__ __forceinline__ float dhat(float c, int i) {
  const float diff = __fsub_rn(c, static_cast<float>(i));
  if (!(fabsf(diff) < 1.f) || diff == 0.f) return 0.f;
  return diff > 0.f ? -1.f : 1.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void msda_sep_bwd_kernel(const T* __restrict__ value,
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
      const float x = __fsub_rn(__fmul_rn(locw[2 * i], static_cast<float>(w)), 0.5f);
      const float y = __fsub_rn(__fmul_rn(locw[2 * i + 1], static_cast<float>(h)), 0.5f);
      const float a = aww[i];
      float s_y = 0.f, s_h0 = 0.f, s_h1 = 0.f;  // sum g r dhat_y; d_hxw of x0, x0+1
      float hx0 = 0.f, hx1 = 0.f, dx0 = 0.f, dx1 = 0.f;
      if (x > -1.f && x < w && y > -1.f && y < h) {  // else every tap is out or zero
        const int x0 = static_cast<int>(floorf(x));
        const int y0 = static_cast<int>(floorf(y));
        const bool x0in = x0 >= 0, x1in = x0 + 1 < w;
        if (x0in) {
          hx0 = hat(x, x0);
          dx0 = dhat(x, x0);
        }
        if (x1in) {
          hx1 = hat(x, x0 + 1);
          dx1 = dhat(x, x0 + 1);
        }
        const float hxw0 = round_cdt<T>(__fmul_rn(hx0, a));
        const float hxw1 = round_cdt<T>(__fmul_rn(hx1, a));
        for (int j = y0; j <= y0 + 1; ++j) {
          if (j < 0 || j >= h) continue;
          const float hy = hat(y, j);
          const float dy = dhat(y, j);
          const long long r0 = lbase + (static_cast<long long>(j) * w + x0) * row_stride;
          const long long r1 = r0 + row_stride;
          for (int c = lane; c < D; c += 32) {
            const float g = round_cdt<T>(to_f32(gw[c]));
            const float v0 = x0in ? to_f32(value[r0 + c]) : 0.f;
            const float v1 = x1in ? to_f32(value[r1 + c]) : 0.f;
            const float r = __fadd_rn(__fmul_rn(hxw0, v0), __fmul_rn(hxw1, v1));
            s_y += __fmul_rn(__fmul_rn(g, r), dy);
            const float d_r = round_cdt<T>(__fmul_rn(g, hy));
            s_h0 += __fmul_rn(d_r, v0);
            s_h1 += __fmul_rn(d_r, v1);
            if (x0in) atomicAdd(d_value + r0 + c, __fmul_rn(hxw0, d_r));
            if (x1in) atomicAdd(d_value + r1 + c, __fmul_rn(hxw1, d_r));
          }
        }
      }
      s_y = warp_sum(s_y);
      s_h0 = warp_sum(s_h0);
      s_h1 = warp_sum(s_h1);
      if (lane == 0) {
        daww[i] = s_h0 * hx0 + s_h1 * hx1;
        dlocw[2 * i] = (s_h0 * dx0 + s_h1 * dx1) * a * static_cast<float>(w);
        dlocw[2 * i + 1] = s_y * static_cast<float>(h);
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
  msda_sep_bwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<const T*>(grad),
      static_cast<float*>(d_value), static_cast<float*>(d_loc),
      static_cast<float*>(d_aw), n_warps, S, Q, M, D, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; d_value must be zeroed. Returns
// cudaGetLastError() after the launch.
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
