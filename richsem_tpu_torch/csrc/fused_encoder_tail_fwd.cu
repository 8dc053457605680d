// K2: fused encoder-layer tail, forward.
//
// Replaces the TPU kernel richsem_tpu/ops/fused_ffn.py:_fwd_kernel (behind
// fused_encoder_tail). Same math and the same cast points as fused_ffn.py:74-90:
//
//   x  = LN1(src + attn)                 f32 statistics from the mean and the
//                                        mean of squares, eps given
//   h1 = relu(bf16(bf16(x) @ W1) + b1)   f32 accumulation, cast, bias add in bf16
//   h2 = bf16(bf16(h1 @ W2) + b2)        likewise
//   y  = LN2(x + h2)                     f32
//
// Layouts: src, attn, y [N, 256] f32; W1 [F, 256] and W2 [256, F] bf16 in
// nn.Linear's (out, in) layout; b1 [F], b2 [256] bf16; LN scales/biases [256] f32.
//
// What bounds it on the card: the two matmuls, 4*N*256*F flops (105 GFLOP at the
// production N = 49,980, F = 2048), and, in a plain composition, the [N, F]
// hidden, which would be written and read back through device memory (205 MB in
// bf16 per call). Design: one block of 8 warps owns 64 rows. It normalizes them
// once into shared memory (f32 for the residual, bf16 for the matmul), then walks
// F in chunks of 64: it stages the W1 and W2 chunks in shared memory, computes
// the [64, 64] hidden chunk with bf16 WMMA fragments (mma.sync, f32 accumulate),
// applies the bf16 cast, bias and relu in shared memory, and accumulates the
// chunk's contribution to the [64, 256] output in registers. The hidden never
// leaves the SM. The staging is not overlapped with the math and the block is
// alone on its SM (192 KB of shared memory); TMA loads, wgmma and a deeper
// pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kD = 256;        // model width
constexpr int kBM = 64;        // rows per block
constexpr int kFC = 64;        // hidden units per chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kXbLd = kD + 8;   // bf16 x, row-major
constexpr int kW1Ld = kD + 8;   // bf16 W1 chunk [kFC][kD] (B operand, col-major)
constexpr int kW2Ld = kFC + 8;  // bf16 W2 chunk [kD][kFC] (B operand, col-major)
constexpr int kHsLd = kFC + 4;  // f32 hidden chunk accumulators
constexpr int kHbLd = kFC + 8;  // bf16 hidden chunk after bias + relu

// Shared-memory carve-up (byte offsets; each is a multiple of 256).
constexpr int kXfOff = 0;                                 // f32 x [kBM][kD]
constexpr int kXbOff = kXfOff + kBM * kD * 4;             // bf16 x
constexpr int kW1Off = kXbOff + kBM * kXbLd * 2;
constexpr int kW2Off = kW1Off + kFC * kW1Ld * 2;
constexpr int kHsOff = kW2Off + kD * kW2Ld * 2;
constexpr int kHbOff = kHsOff + kBM * kHsLd * 4;
constexpr int kSmem = kHbOff + kBM * kHbLd * 2;
// The f32 output accumulators [kBM][kD] reuse the x(bf16) and W1 regions at the end.
constexpr int kAccOff = kXbOff;
static_assert(kW2Off - kXbOff >= kBM * kD * 4, "accumulator reuse overflows");
static_assert(kSmem <= 227 * 1024, "too much shared memory");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Each lane owns 8 channels of a row: [4*lane, 4*lane+4) and [128+4*lane, ...).
__device__ __forceinline__ int chan(int lane, int half) { return half * 128 + 4 * lane; }

__global__ void __launch_bounds__(kThreads, 1)
encoder_tail_fwd_kernel(const float* __restrict__ src, const float* __restrict__ attn,
                        const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        const __nv_bfloat16* __restrict__ b2,
                        const float* __restrict__ s1, const float* __restrict__ sb1,
                        const float* __restrict__ s2, const float* __restrict__ sb2,
                        float* __restrict__ out, int n, int f, float eps) {
  extern __shared__ __align__(256) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem + kXfOff);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + kXbOff);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + kW1Off);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Off);
  float* hs = reinterpret_cast<float*>(smem + kHsOff);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + kHbOff);
  float* acc_s = reinterpret_cast<float*>(smem + kAccOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  constexpr int kRowsPerWarp = kBM / kWarps;

  // ---- x = LN1(src + attn): f32 copy for the residual, bf16 copy for W1 ----
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const long long g = row0 + r;
    float u[8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
      if (g < n) {
        a = *reinterpret_cast<const float4*>(src + g * kD + chan(lane, half));
        b = *reinterpret_cast<const float4*>(attn + g * kD + chan(lane, half));
      }
      u[4 * half + 0] = a.x + b.x;
      u[4 * half + 1] = a.y + b.y;
      u[4 * half + 2] = a.z + b.z;
      u[4 * half + 3] = a.w + b.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sum += u[j];
      sq += u[j] * u[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / kD;
    const float rstd = rsqrtf(sq / kD - mean * mean + eps);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j / 4) + (j % 4);
      const float x = (u[j] - mean) * rstd * s1[c] + sb1[c];
      xf[r * kD + c] = x;
      xb[r * kXbLd + c] = __float2bfloat16(x);
    }
  }

  // ---- walk the hidden dimension in chunks; the output stays in registers ----
  const int rt = warp >> 1;          // this warp's 16-row tile
  const int ct1 = (warp & 1) * 2;    // its two 16-col tiles of the hidden chunk
  const int ct2 = (warp & 1) * 8;    // its eight 16-col tiles of the output
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc2[j], 0.f);

  for (int f0 = 0; f0 < f; f0 += kFC) {
    __syncthreads();  // x is ready; the previous chunk is done with w1s/w2s/hb
    for (int idx = tid; idx < kFC * (kD / 8); idx += kThreads) {
      const int r = idx / (kD / 8), c8 = idx % (kD / 8);
      *reinterpret_cast<uint4*>(w1s + r * kW1Ld + 8 * c8) =
          *reinterpret_cast<const uint4*>(w1 + static_cast<long long>(f0 + r) * kD + 8 * c8);
    }
    for (int idx = tid; idx < kD * (kFC / 8); idx += kThreads) {
      const int r = idx / (kFC / 8), c8 = idx % (kFC / 8);
      *reinterpret_cast<uint4*>(w2s + r * kW2Ld + 8 * c8) =
          *reinterpret_cast<const uint4*>(w2 + static_cast<long long>(r) * f + f0 + 8 * c8);
    }
    __syncthreads();

    // hidden chunk [kBM, kFC] = x(bf16) @ W1 chunk
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[2];
    wmma::fill_fragment(acc1[0], 0.f);
    wmma::fill_fragment(acc1[1], 0.f);
    for (int k = 0; k < kD; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, xb + rt * 16 * kXbLd + k, kXbLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w1s + (ct1 + j) * 16 * kW1Ld + k, kW1Ld);
        wmma::mma_sync(acc1[j], a, b, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(hs + rt * 16 * kHsLd + (ct1 + j) * 16, acc1[j], kHsLd,
                              wmma::mem_row_major);
    __syncthreads();

    // cast to bf16, add the bf16 bias, relu
    for (int idx = tid; idx < kBM * kFC; idx += kThreads) {
      const int r = idx / kFC, c = idx % kFC;
      const float v = round_bf16(round_bf16(hs[r * kHsLd + c]) +
                                 __bfloat162float(b1[f0 + c]));
      hb[r * kHbLd + c] = __float2bfloat16(fmaxf(v, 0.f));
    }
    __syncthreads();

    // output [kBM, kD] += hidden chunk @ W2 chunk
    for (int k = 0; k < kFC; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::load_matrix_sync(a, hb + rt * 16 * kHbLd + k, kHbLd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(b, w2s + (ct2 + j) * 16 * kW2Ld + k, kW2Ld);
        wmma::mma_sync(acc2[j], a, b, acc2[j]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(acc_s + rt * 16 * kD + (ct2 + j) * 16, acc2[j], kD,
                            wmma::mem_row_major);
  __syncthreads();

  // ---- y = LN2(x + bf16(bf16(acc) + b2)) ----
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const long long g = row0 + r;
    if (g >= n) break;  // uniform across the warp
    float u[8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j / 4) + (j % 4);
      const float h2 = round_bf16(round_bf16(acc_s[r * kD + c]) + __bfloat162float(b2[c]));
      u[j] = xf[r * kD + c] + h2;
      sum += u[j];
      sq += u[j] * u[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / kD;
    const float rstd = rsqrtf(sq / kD - mean * mean + eps);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = chan(lane, half) + j;
        y[j] = (u[4 * half + j] - mean) * rstd * s2[c] + sb2[c];
      }
      *reinterpret_cast<float4*>(out + g * kD + chan(lane, half)) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

}  // namespace

// All pointers are device pointers; d must be 256 and f a multiple of 64.
// Returns cudaGetLastError() after the launch (or the attribute call's error).
extern "C" int encoder_tail_fwd(const void* src, const void* attn, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* s1, const void* sb1, const void* s2,
                                const void* sb2, void* out, int n, int d, int f,
                                float eps, void* stream) {
  if (d != kD || f <= 0 || f % kFC != 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_tail_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBM - 1) / kBM;
  encoder_tail_fwd_kernel<<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(attn),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(s1), static_cast<const float*>(sb1),
      static_cast<const float*>(s2), static_cast<const float*>(sb2),
      static_cast<float*>(out), n, f, eps);
  return static_cast<int>(cudaGetLastError());
}
