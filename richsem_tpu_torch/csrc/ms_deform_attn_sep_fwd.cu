// K3: separable deformable attention of the decoder, forward.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_sep_pallas.py:_fwd_kernel
// (behind _fwd_impl, the dec_msda_impl="sep_pallas" sampler). That kernel writes
// the bilinear sampler as two hat bases per level and contracts them as dense
// products, [ck, W] x [W, H*D] then a 0/1 reduction matrix over y, because the
// MXU is the TPU's fast unit. Only two x-taps and two y-taps of each hat are
// nonzero, and adding the zeros of the dense product is exact, so this kernel
// gathers those four taps per (b, q, m, l, p), as K1 does, and rounds where the
// TPU kernel rounds (cdt = bf16 for a bf16 value, else f32):
//
//   x = loc_x * W - 0.5, y = loc_y * H - 0.5       (no FMA contraction)
//   hxw_i = cdt(max(0, 1 - |x - i|) * aw)          for the in-range taps i in {x0, x0+1}
//   r_j   = hxw_x0 * V[j, x0] + hxw_x1 * V[j, x1]   f32, for the in-range taps j in {y0, y0+1}
//   rh_j  = cdt(r_j * max(0, 1 - |y - j|))
//   out[b, q, m, :] = cdt(sum_p f32(sum_l sum_j rh_j))
//
// so that it agrees with the plain dense version up to the order of f32 sums.
//
// Layouts (row-major, as the JAX package's public functions have them):
//   value [B, S, M, D] (bf16 or f32), loc [B, Q, M, L, P, 2] f32 (x, y),
//   aw [B, Q, M, L, P] f32 -> out [B, Q, M*D] in the value's dtype.
//
// Design: one warp per (b, q, m); the 32 lanes cover 32 channels of D, so each
// tap reads D contiguous values (64 bytes in bf16) as one coalesced access, and
// every lane computes the tap geometry itself from broadcast loads of loc/aw.
// What bounds it on the card: at the decoder's shapes (B2, Q = 1,100 with the
// 200 DN queries, M8, L4, P4, D32) the call gathers B*Q*M*L*P*4 taps of 64 B =
// 18 MB, almost all from L2 (the 25.6 MB value fits the 50 MB L2), and moves
// ~30 MB of device memory (value, loc, aw read once, out written once), so
// its bound is the bytes; at ~17,600 warps it is also short of filling the
// card for long. Sharing the tap geometry across lanes and two channels a
// lane are later work.

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

// Rounding to the compute type: bf16 for a bf16 value, none for f32.
template <typename T> __device__ __forceinline__ float round_cdt(float v);
template <> __device__ __forceinline__ float round_cdt<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_cdt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// max(0, 1 - |c - i|), as the TPU kernel's _hat.
__device__ __forceinline__ float hat(float c, int i) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, static_cast<float>(i)))));
}

template <typename T>
__global__ void msda_sep_fwd_kernel(const T* __restrict__ value,
                                    const float* __restrict__ loc,
                                    const float* __restrict__ aw,
                                    T* __restrict__ out,
                                    long long n_warps, int S, int Q, int M, int D,
                                    int P, Levels lv) {
  const long long warp = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp enumerates (b, q, m) in row-major order: the row of loc/aw viewed as
  // [B*Q*M, L*P(*2)] and of out viewed as [B*Q*M, D].
  const int m = static_cast<int>(warp % M);
  const long long b = warp / M / Q;
  const int lp = lv.n * P;
  const float* locw = loc + warp * lp * 2;
  const float* aww = aw + warp * lp;
  const long long row_stride = static_cast<long long>(M) * D;  // one token of value

  for (int c = lane; c < D; c += 32) {
    const T* vbase = value + b * S * row_stride + static_cast<long long>(m) * D + c;
    float acc = 0.f;
    for (int p = 0; p < P; ++p) {
      float acc_p = 0.f;  // the TPU kernel sums levels per row, then rows over P
      for (int l = 0; l < lv.n; ++l) {
        const int h = lv.h[l];
        const int w = lv.w[l];
        const int i = l * P + p;
        const float x = __fsub_rn(__fmul_rn(locw[2 * i], static_cast<float>(w)), 0.5f);
        const float y = __fsub_rn(__fmul_rn(locw[2 * i + 1], static_cast<float>(h)), 0.5f);
        // x <= -1 or x >= w (likewise y): every tap is outside the level or has
        // a zero hat; skipping also keeps the int casts in range.
        if (!(x > -1.f && x < w && y > -1.f && y < h)) continue;
        const float a = aww[i];
        const int x0 = static_cast<int>(floorf(x));
        const int y0 = static_cast<int>(floorf(y));
        const bool x0in = x0 >= 0, x1in = x0 + 1 < w;
        const float hxw0 = x0in ? round_cdt<T>(__fmul_rn(hat(x, x0), a)) : 0.f;
        const float hxw1 = x1in ? round_cdt<T>(__fmul_rn(hat(x, x0 + 1), a)) : 0.f;
        const T* vl = vbase + lv.start[l] * row_stride;
        for (int j = y0; j <= y0 + 1; ++j) {
          if (j < 0 || j >= h) continue;
          const T* row = vl + static_cast<long long>(j) * w * row_stride;
          const float v0 = x0in ? to_f32(row[x0 * row_stride]) : 0.f;
          const float v1 = x1in ? to_f32(row[(x0 + 1) * row_stride]) : 0.f;
          const float r = __fadd_rn(__fmul_rn(hxw0, v0), __fmul_rn(hxw1, v1));
          acc_p += round_cdt<T>(__fmul_rn(r, hat(y, j)));
        }
      }
      acc += acc_p;
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
  msda_sep_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<T*>(out), n_warps, S, Q, M, D, P,
      lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs. Returns cudaGetLastError() after the launch.
extern "C" int msda_sep_fwd(const void* value, const void* loc, const void* aw,
                            void* out, int B, int S, int Q, int M, int D, int L, int P,
                            const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
}
