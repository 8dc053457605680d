// Elementwise cost probes over basis-build-sized f32 arrays.
//
// Replaces the Pallas kernels of tools/bench_vpu_model.py, launched by its
// run :90 over a grid of T cells:
//
//   probe_chain <- chain_kernel :54: acc = x; n times acc = acc + x.
//   probe_fma   <- fma_kernel :62 and fma_chunk_kernel :77:
//                  out[t, m, y, x, k] = sum_p hy[t, m, y, pK + k] * hx[t, m, x, pK + k]
//                  for p < P, p in order; with two_acc the even p go to one
//                  sum and the odd p to another, added at the end, as the JAX
//                  kernel writes it. fma_chunk_kernel computes the same
//                  function in 128-lane chunks of K (a Mosaic register-
//                  residency layout) and shares this kernel.
//                  hy [T, M, WY, 4K], hx [T, M, WXP, 4K]; out [T, M, WY, WXP, K].
//
// Both are memory-bound fused passes with __fadd_rn/__fmul_rn, so that the
// sums round exactly as the plain version's separate operations do. chain
// reads every input element once and writes every output element once, four
// floats a thread (16-byte loads and stores). fma writes 1.70 GB from 0.45 GB
// of inputs, so its bound is the writes: a block stages its hx slab in shared
// memory, each lane keeps its hy float4 in registers across the 32 x, and
// every output float4 leaves in one streaming 16-byte store (fma_kernel
// below). The .sum() that the JAX probe takes of the output is outside its
// kernel, and stays outside here.
//
// Plain C interface; each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

#include "hopper_wgmma.cuh"  // cp.async

namespace {

using namespace hopper;

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__global__ void chain_kernel(const float* __restrict__ x, float* __restrict__ out, long long n,
                             int n_ops) {
  const long long i4 = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 4;
  if (i4 + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i4);
    float4 acc = v;
    for (int i = 0; i < n_ops; ++i) {
      acc.x = __fadd_rn(acc.x, v.x);
      acc.y = __fadd_rn(acc.y, v.y);
      acc.z = __fadd_rn(acc.z, v.z);
      acc.w = __fadd_rn(acc.w, v.w);
    }
    *reinterpret_cast<float4*>(out + i4) = acc;
  } else {
    for (long long j = i4; j < n; ++j) {
      float acc = x[j];
      for (int i = 0; i < n_ops; ++i) acc = __fadd_rn(acc, x[j]);
      out[j] = acc;
    }
  }
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

constexpr int kFmaWarps = 8;   // a block's warps: y rows in flight, one a warp
constexpr int kFmaKC = 128;    // k a block: 32 lanes x 4
constexpr int kFmaXB = 32;     // x a block

// Block (tm, kc, xb) writes out[tm, :, xb * 32 .., kc * 128 ..]: it stages
// hx[tm, x, p K + kc * 128 ..] for its 32 x and P points in shared memory
// once (P x 16 KB); warp w takes y = w, w + 8, ...: each lane loads its float4
// of hy for the P points once and walks the x, writing one float4 (a warp
// 512 contiguous bytes) with a streaming store. Lanes past K and x past WXP
// do nothing. 32-bit indices; 64-bit only in the base offsets.
template <int P, bool kTwo>
__global__ void __launch_bounds__(kFmaWarps * 32)
fma_kernel(const float* __restrict__ hy, const float* __restrict__ hx, float* __restrict__ out,
           int WY, int WXP, int K) {
  extern __shared__ float4 hxs[];  // [P][kFmaXB][32 lanes]
  const int tm = blockIdx.x, kc = blockIdx.y, x0 = blockIdx.z * kFmaXB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = kc * kFmaKC + 4 * lane;
  const int nx = min(kFmaXB, WXP - x0);
  const long long row = 4LL * K;  // floats in a row of hy or hx
  const float* hxb = hx + (static_cast<long long>(tm) * WXP + x0) * row + kc * kFmaKC;
  for (int i = threadIdx.x; i < P * kFmaXB * 32; i += kFmaWarps * 32) {
    const int p = i >> 10, x = (i >> 5) & 31, l = i & 31;
    if (x < nx && kc * kFmaKC + 4 * l < K)
      cp_async16(smem_u32(hxs + i), hxb + x * row + p * K + 4 * l);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (k >= K) return;
  for (int y = warp; y < WY; y += kFmaWarps) {
    const long long tmy = static_cast<long long>(tm) * WY + y;
    float4 a[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      a[p] = __ldg(reinterpret_cast<const float4*>(hy + tmy * row + p * K + k));
    float* o = out + (tmy * WXP + x0) * K + k;
    for (int x = 0; x < nx; ++x, o += K) {
      float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 prod = mul4(a[p], hxs[(p * kFmaXB + x) * 32 + lane]);
        if (kTwo && (p & 1))
          acc1 = p == 1 ? prod : add4(acc1, prod);
        else
          acc0 = p == 0 ? prod : add4(acc0, prod);
      }
      if (kTwo && P > 1) acc0 = add4(acc0, acc1);
      __stcs(reinterpret_cast<float4*>(o), acc0);
    }
  }
}

template <int P, bool kTwo>
int launch_fma(const float* hy, const float* hx, float* out, int tm, int WY, int WXP, int K,
               cudaStream_t st) {
  const int smem = P * kFmaXB * 32 * static_cast<int>(sizeof(float4));
  cudaError_t err =
      cudaFuncSetAttribute(fma_kernel<P, kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tm, (K + kFmaKC - 1) / kFmaKC, (WXP + kFmaXB - 1) / kFmaXB);
  fma_kernel<P, kTwo><<<grid, kFmaWarps * 32, smem, st>>>(hy, hx, out, WY, WXP, K);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTwo>
int launch_fma_p(const float* hy, const float* hx, float* out, int tm, int WY, int WXP, int K,
                 int P, cudaStream_t st) {
  switch (P) {
    case 1: return launch_fma<1, kTwo>(hy, hx, out, tm, WY, WXP, K, st);
    case 2: return launch_fma<2, kTwo>(hy, hx, out, tm, WY, WXP, K, st);
    case 3: return launch_fma<3, kTwo>(hy, hx, out, tm, WY, WXP, K, st);
    default: return launch_fma<4, kTwo>(hy, hx, out, tm, WY, WXP, K, st);
  }
}

}  // namespace

extern "C" int probe_chain(const void* x, void* out, long long n, int n_ops, void* stream) {
  const long long threads = (n + 3) / 4;
  chain_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(out), n, n_ops);
  return static_cast<int>(cudaGetLastError());
}

// tm = T * M; WY, WXP >= 1; K a multiple of 4; 1 <= P <= 4.
extern "C" int probe_fma(const void* hy, const void* hx, void* out, int tm, int WY, int WXP,
                         int K, int P, int two_acc, void* stream) {
  const auto* y = static_cast<const float*>(hy);
  const auto* x = static_cast<const float*>(hx);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return two_acc ? launch_fma_p<true>(y, x, o, tm, WY, WXP, K, P, st)
                 : launch_fma_p<false>(y, x, o, tm, WY, WXP, K, P, st);
}
