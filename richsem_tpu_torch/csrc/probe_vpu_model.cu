// Elementwise cost probes over basis-build-sized f32 arrays.
//
// Replaces the Pallas kernels of tools/bench_vpu_model.py, launched by its
// run :90 over a grid of T cells:
//
//   probe_chain <- chain_kernel :53: acc = x; n times acc = acc + x.
//   probe_fma   <- fma_kernel :61 and fma_chunk_kernel :75:
//                  out[t, m, y, x, k] = sum_p hy[t, m, y, pK + k] * hx[t, m, x, pK + k]
//                  for p < P, p in order; with two_acc the even p go to one
//                  sum and the odd p to another, added at the end, as the JAX
//                  kernel writes it. fma_chunk_kernel computes the same
//                  function in 128-lane chunks of K (a Mosaic register-
//                  residency layout) and shares this kernel.
//                  hy [T, M, WY, 4K], hx [T, M, WXP, 4K]; out [T, M, WY, WXP, K].
//
// Both are memory-bound fused passes: every input element is read once from
// device memory and every output element written once, four floats a thread
// (16-byte loads and stores), with __fadd_rn/__fmul_rn so that the sums round
// exactly as the plain version's separate operations do. The .sum() that the
// JAX probe takes of the output is outside its kernel, and stays outside here.
//
// Plain C interface; each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>

namespace {

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

// One thread per 4 consecutive k of one output (t, m, y, x) row; K % 4 == 0.
__global__ void fma_kernel(const float* __restrict__ hy, const float* __restrict__ hx,
                           float* __restrict__ out, long long n_rows, int WY, int WXP, int K,
                           int P, int two_acc) {
  const int k4 = K / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_rows * k4) return;
  const int k = static_cast<int>(idx % k4) * 4;
  const long long row = idx / k4;  // (t, m, y, x)
  const int x = static_cast<int>(row % WXP);
  const long long tmy = row / WXP;  // (t, m, y)
  const long long tm = tmy / WY;
  const float* hyr = hy + tmy * 4LL * K + k;
  const float* hxr = hx + (tm * WXP + x) * 4LL * K + k;
  float4 acc0 = make_float4(0.f, 0.f, 0.f, 0.f), acc1 = acc0;
  for (int p = 0; p < P; ++p) {
    const float4 a = *reinterpret_cast<const float4*>(hyr + p * K);
    const float4 b = *reinterpret_cast<const float4*>(hxr + p * K);
    const float4 prod = make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                                    __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
    if (two_acc && (p & 1)) {
      acc1 = p == 1 ? prod : add4(acc1, prod);
    } else {
      acc0 = p == 0 ? prod : add4(acc0, prod);
    }
  }
  if (two_acc && P > 1) acc0 = add4(acc0, acc1);
  *reinterpret_cast<float4*>(out + idx * 4) = acc0;
}

}  // namespace

extern "C" int probe_chain(const void* x, void* out, long long n, int n_ops, void* stream) {
  const long long threads = (n + 3) / 4;
  chain_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(out), n, n_ops);
  return static_cast<int>(cudaGetLastError());
}

// n_rows = T * M * WY * WXP output rows of K.
extern "C" int probe_fma(const void* hy, const void* hx, void* out, long long n_rows, int WY,
                         int WXP, int K, int P, int two_acc, void* stream) {
  const long long threads = n_rows * (K / 4);
  fma_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hy), static_cast<const float*>(hx), static_cast<float*>(out),
      n_rows, WY, WXP, K, P, two_acc);
  return static_cast<int>(cudaGetLastError());
}
