// Calibration probes of the card: CUDA-core rate, a tensor-core loop at the
// decoder's narrow shapes, a one-block-per-cell grid, and a tiled accumulate.
//
// Replaces the four Pallas probes of tools/bench_pallas_cal.py (each computes
// the function of the TPU kernel, not its block layout):
//
//   probe_vpu   <- run_vpu :52 (vpu_kernel :40)
//                  acc = 0; for i < reps: acc += max(0, 1 - |x - (y + i)|) * y
//                  in the input dtype, every op rounded (the f32 form uses
//                  __fmul_rn/__fadd_rn so nvcc contracts nothing into an FMA;
//                  the bf16 form rounds to bf16 after every op, i rounded as
//                  JAX's i.astype(bf16)). One thread an element. Bound: 6 ops an
//                  element-rep on the CUDA cores.
//   probe_mxu   <- run_mxu :67
//                  acc_f32 = 0; for i < reps: acc += bf16(a + bf16(i)) @ b
//                  a [k, s], b [s, d] bf16, f32 out [k, d]. A block of four
//                  warps owns a 32 x 32 output tile and stages its rows of a
//                  and columns of b in shared memory once; per rep each warp
//                  walks s, adds bf16(i) to the a fragments as it loads them,
//                  and multiplies with WMMA (mma.sync, bf16 in, f32
//                  accumulate) into a fresh fragment, which it then adds to the
//                  carry, as fori_loop adds each rep's dot. Bound: the bf16
//                  tensor-core rate; at (96, 1664, 32) only three blocks exist.
//                  Each warp's products depend on one another, so the time is
//                  this kernel's latency, not the tensor cores' rate.
//   probe_grid  <- run_grid_overhead :92
//                  out = 2 x, one block of 256 threads (4 floats each) per
//                  [8, 128] cell. Bound: bytes (each block streams 8 KB, so
//                  the time a block is memory time, not a scheduling cost).
//   probe_repeat <- run_repeat :108
//                  acc = 0; for i < reps: acc += tile(x + i, wx, axis 1)
//                  x [rows, wy] -> [rows, wy * wx], out[r, c] sums x[r, c % wy]
//                  (pltpu.repeat tiles). One thread an output element.
//
// Plain C interface; each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

__global__ void vpu_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                               float* __restrict__ out, long long n, int reps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float xv = x[idx], yv = y[idx];
  float acc = 0.f;
  for (int i = 0; i < reps; ++i) {
    const float d = __fsub_rn(xv, __fadd_rn(yv, static_cast<float>(i)));
    const float h = fmaxf(0.f, __fsub_rn(1.f, fabsf(d)));
    acc = __fadd_rn(acc, __fmul_rn(h, yv));
  }
  out[idx] = acc;
}

// bf16 arithmetic rounded after every operation: each op in f32 (exact for a
// product of two bf16 values, and for a sum a single rounding to 24 bits,
// which then rounds to bf16 as the direct operation would: 24 >= 2 * 8 + 2),
// then rounded to bf16. The __hadd/__hmul intrinsics would let the code
// generator fuse a multiply and an add into one bf16 FMA.
__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void vpu_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                const __nv_bfloat16* __restrict__ y,
                                __nv_bfloat16* __restrict__ out, long long n, int reps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float xv = __bfloat162float(x[idx]), yv = __bfloat162float(y[idx]);
  float acc = 0.f;
  for (int i = 0; i < reps; ++i) {
    const float d = bf(__fsub_rn(xv, bf(__fadd_rn(yv, bf(static_cast<float>(i))))));
    const float h = fmaxf(0.f, bf(__fsub_rn(1.f, fabsf(d))));
    acc = bf(__fadd_rn(acc, bf(__fmul_rn(h, yv))));
  }
  out[idx] = __float2bfloat16_rn(acc);
}

constexpr int kMxuTile = 32;  // output rows and columns of a block
constexpr int kMxuPad = 8;    // row padding of the staged operands (bf16 elements)

// a [k, s] and b [s, d] bf16 row-major; out [k, d] f32. k and d multiples of 32,
// s of 16. The block stages its 32 rows of a and 32 columns of b once (s <= 1760
// fits both in shared memory); each pass adds bf16(i) to the a fragments as they
// are loaded, so nothing is staged again.
__global__ void __launch_bounds__(128, 1)
mxu_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
           float* __restrict__ out, int k, int s, int d, int reps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = s + kMxuPad;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);  // [row][kk]
  __nv_bfloat16* bs = as + kMxuTile * ld;                       // [col][kk]: col-major B
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.y * kMxuTile, col0 = blockIdx.x * kMxuTile;
  const int wr = (warp >> 1) * 16, wc = (warp & 1) * 16;
  for (int e = tid; e < kMxuTile * s; e += blockDim.x) {
    const int r = e / s, c = e % s;
    as[r * ld + c] = a[static_cast<long long>(row0 + r) * s + c];
    const int kk = e / kMxuTile, col = e % kMxuTile;
    bs[col * ld + kk] = b[static_cast<long long>(kk) * d + col0 + col];
  }
  __syncthreads();
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> carry, rep;
  wmma::fill_fragment(carry, 0.f);
  for (int i = 0; i < reps; ++i) {
    const float fi = bf(static_cast<float>(i));
    wmma::fill_fragment(rep, 0.f);
    for (int kk = 0; kk < s; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, as + wr * ld + kk, ld);
      wmma::load_matrix_sync(fb, bs + wc * ld + kk, ld);
#pragma unroll
      for (int e = 0; e < fa.num_elements; ++e)  // bf16(a + bf16(i)), element by element
        fa.x[e] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(fa.x[e]), fi));
      wmma::mma_sync(rep, fa, fb, rep);
    }
#pragma unroll
    for (int e = 0; e < carry.num_elements; ++e) carry.x[e] = __fadd_rn(carry.x[e], rep.x[e]);
  }
  wmma::store_matrix_sync(out + static_cast<long long>(row0 + wr) * d + col0 + wc, carry, d,
                          wmma::mem_row_major);
}

// x, out [n_cells, 8, 128] f32: one block a cell, 256 threads x 4 floats.
__global__ void __launch_bounds__(256)
grid_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * 1024 + threadIdx.x * 4;
  const float4 v = *reinterpret_cast<const float4*>(x + base);
  *reinterpret_cast<float4*>(out + base) =
      make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

__global__ void repeat_f32_kernel(const float* __restrict__ x, float* __restrict__ out,
                                  int rows, int wy, int wx, int reps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cols = wy * wx;
  if (idx >= static_cast<long long>(rows) * cols) return;
  const int r = static_cast<int>(idx / cols), c = static_cast<int>(idx % cols);
  const float xv = x[static_cast<long long>(r) * wy + c % wy];
  float acc = 0.f;
  for (int i = 0; i < reps; ++i) acc = __fadd_rn(acc, __fadd_rn(xv, static_cast<float>(i)));
  out[idx] = acc;
}

__global__ void repeat_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                   __nv_bfloat16* __restrict__ out, int rows, int wy, int wx,
                                   int reps) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int cols = wy * wx;
  if (idx >= static_cast<long long>(rows) * cols) return;
  const int r = static_cast<int>(idx / cols), c = static_cast<int>(idx % cols);
  const float xv = __bfloat162float(x[static_cast<long long>(r) * wy + c % wy]);
  float acc = 0.f;
  for (int i = 0; i < reps; ++i)
    acc = bf(__fadd_rn(acc, bf(__fadd_rn(xv, bf(static_cast<float>(i))))));
  out[idx] = __float2bfloat16_rn(acc);
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int probe_vpu(const void* x, const void* y, void* out, long long n, int reps,
                         int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    vpu_bf16_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
        static_cast<__nv_bfloat16*>(out), n, reps);
  else
    vpu_f32_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out),
        n, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_mxu(const void* a, const void* b, void* out, int k, int s, int d,
                         int reps, void* stream) {
  const int smem = 2 * kMxuTile * (s + kMxuPad) * 2;
  cudaError_t err =
      cudaFuncSetAttribute(mxu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(d / kMxuTile, k / kMxuTile);
  mxu_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
      static_cast<float*>(out), k, s, d, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_grid(const void* x, void* out, int n_cells, void* stream) {
  grid_kernel<<<n_cells, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_repeat(const void* x, void* out, int rows, int wy, int wx, int reps,
                            int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n = static_cast<long long>(rows) * wy * wx;
  if (is_bf16)
    repeat_bf16_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), rows, wy, wx,
        reps);
  else
    repeat_f32_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, wy, wx, reps);
  return static_cast<int>(cudaGetLastError());
}
