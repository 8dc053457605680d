// K1: multi-scale deformable attention forward, exact zero-padded bilinear gather.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_pallas2.py:_fwd_kernel
// (the windowed hat-basis Pallas kernel behind ms_deform_attn_pallas2). That
// kernel reads one static window per 16x16 query tile and is exact only for taps
// within `margin` of the tile, which the model's offset clamp guarantees; it was
// shaped by the TPU's lack of vector gathers. Hopper gathers natively, so this
// kernel computes the reference CUDA sampler's function directly, with no
// window:
//
//   out[b,q,m,:] = sum_{l,p} aw[b,q,m,l,p] * bilinear0(V_l[b,:,:,m,:], loc[b,q,m,l,p])
//
// with pixel = loc * size - 0.5 and zero contribution from out-of-bounds taps.
// One kernel therefore serves both callers: the clamped encoder (Q = S) and the
// unclamped decoder (Q = 900, box references).
//
// Layouts (row-major, as the JAX package's public functions have them):
//   value [B, S, M, D] (bf16 or f32), loc [B, Q, M, L, P, 2] f32 (x, y),
//   aw [B, Q, M, L, P] f32 -> out [B, Q, M*D] in the value's dtype.
//
// Design: one warp per (b, q, m); the 32 lanes cover 32 channels of D, so each
// tap reads D contiguous values (64 bytes in bf16) as one coalesced access. Every
// lane computes the tap geometry itself from broadcast loads of loc/aw, and
// accumulates in f32. What bounds it on the card is the gathered bytes: at the
// production encoder shapes (B2, S=Q=24,990, M8, L4, P4, D32) one call gathers
// B*Q*M*L*P*4 taps * 64 B = 0.82 GB, almost all of it from L2 (the 25.6 MB value
// tensor fits in the 50 MB L2), against ~100 MB of device-memory traffic for
// loc, aw, value and out. Packing two channels per lane and sharing the tap
// geometry across lanes are later work.

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void msda_fwd_kernel(const T* __restrict__ value,
                                const float* __restrict__ loc,
                                const float* __restrict__ aw,
                                T* __restrict__ out,
                                long long n_warps, int S, int Q, int M, int D,
                                int P, Levels lv) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp enumerates (b, q, m) in row-major order, which is also the row index
  // of loc/aw viewed as [B*Q*M, L*P(*2)] and of out viewed as [B*Q*M, D].
  const int m = static_cast<int>(warp % M);
  const long long b = warp / M / Q;
  const int lp = lv.n * P;
  const float* locw = loc + warp * lp * 2;
  const float* aww = aw + warp * lp;
  const long long row_stride = static_cast<long long>(M) * D;  // one token of value

  for (int c = lane; c < D; c += 32) {
    const T* vbase = value + b * S * row_stride + static_cast<long long>(m) * D + c;
    float acc = 0.f;
    for (int l = 0; l < lv.n; ++l) {
      const int h = lv.h[l];
      const int w = lv.w[l];
      const T* vl = vbase + lv.start[l] * row_stride;
      for (int p = 0; p < P; ++p) {
        const int i = l * P + p;
        const float x = locw[2 * i] * w - 0.5f;
        const float y = locw[2 * i + 1] * h - 0.5f;
        // Taps at x <= -1 or x >= w (likewise y) all fall outside the level or
        // carry zero weight; skipping them also keeps the int casts in range.
        if (!(x > -1.f && x < w && y > -1.f && y < h)) continue;
        const float a = aww[i];
        const float xf = floorf(x);
        const float yf = floorf(y);
        const float dx = x - xf;
        const float dy = y - yf;
        const int x0 = static_cast<int>(xf);
        const int y0 = static_cast<int>(yf);
        const bool x0in = x0 >= 0;
        const bool x1in = x0 + 1 < w;
        if (y0 >= 0) {
          const T* r = vl + static_cast<long long>(y0) * w * row_stride;
          const float wy = a * (1.f - dy);
          if (x0in) acc += wy * (1.f - dx) * to_f32(r[x0 * row_stride]);
          if (x1in) acc += wy * dx * to_f32(r[(x0 + 1) * row_stride]);
        }
        if (y0 + 1 < h) {
          const T* r = vl + static_cast<long long>(y0 + 1) * w * row_stride;
          const float wy = a * dy;
          if (x0in) acc += wy * (1.f - dx) * to_f32(r[x0 * row_stride]);
          if (x1in) acc += wy * dx * to_f32(r[(x0 + 1) * row_stride]);
        }
      }
    }
    store(out + warp * D + c, acc);
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* aw, void* out, int B,
           int S, int Q, int M, int D, int L, int P, const int* shapes,
           cudaStream_t stream) {
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
  msda_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<T*>(out), n_warps, S, Q, M, D, P,
      lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs. Returns cudaGetLastError() after the launch.
extern "C" int msda_fwd(const void* value, const void* loc, const void* aw,
                        void* out, int B, int S, int Q, int M, int D, int L, int P,
                        const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
}
