// K2-bwd: fused encoder-layer tail, backward.
//
// Replaces the TPU kernel richsem_tpu/ops/fused_ffn.py:_bwd_kernel (behind the
// custom VJP of fused_encoder_tail). Same math and the same cast points as
// fused_ffn.py:100-124, with the forward state recomputed, not stored:
//
//   x  = LN1(src + attn), h1 = relu(bf16(bf16(bf16(x) @ W1) + b1)),
//   h2 = bf16(bf16(h1 @ W2) + b2), u2 = x + h2, y = LN2(u2)       (recomputed)
//   du2 = LN2'(dy);   ds2 = sum dy*xhat2, dsb2 = sum dy, db2 = sum du2  (f32)
//   du2c = bf16(du2)
//   dh1 = bf16(du2c @ W2^T) * (h1 > 0);   db1 = sum dh1               (f32)
//   dx = du2 + dh1 @ W1 (f32);  du1 = LN1'(dx);  ds1, dsb1 likewise
//   dW1 = dh1^T bf16(x),  dW2 = du2c^T h1   (f32 accumulation)
//
// Layouts: src, attn, dy, du1 [N, 256] f32; W1 [F, 256] and W2 [256, F] bf16
// in nn.Linear's (out, in) layout, so dW1 is [F, 256] and dW2 [256, F], f32.
//
// The TPU kernel carries the weight-gradient sums across its sequential grid.
// Hopper blocks run in no order, so the work is split in three kernels:
//
// (a) row_block: one block of 8 warps owns 64 rows, as K2's forward does. It
//     recomputes LN1, walks F in 64-wide chunks with bf16 WMMA (mma.sync, f32
//     accumulate) to rebuild h1 and h2, does the LN2 backward, walks F again
//     for dh1 and dx_ffn, and does the LN1 backward. It writes du1, and, for
//     (b), bf16 x, h1, dh1 and du2c [N_pad, .] to device memory, plus per-block
//     partial sums of ds1, dsb1, ds2, dsb2, db2 and db1.
// (b) atb: a split-K product C += A^T B over the rows (the reduction axis),
//     64x64 output tiles, WMMA fragments loaded straight from device memory,
//     each split adding its f32 tile into C with atomicAdd. It runs twice:
//     dW1 = dh1^T x and dW2 = du2c^T h1.
// (c) colsum: the per-block partials summed in a fixed order (deterministic).
//
// What bounds it on the card: the matmuls. (a) does 3 products of 2*N*256*F
// (h1, h2 and dh1, dx_ffn: 4 in all, 210 GFLOP at N = 49,980, F = 2048) and
// (b) 2 more (105 GFLOP), 315 GFLOP in all, 0.32 ms at the H100's 989 TFLOP/s
// bf16 peak. Read as work for the tensor cores, this kernel is compute-bound;
// its device traffic is the f32 stream tensors (N*256*4 B each: src, attn, dy
// read, du1 written, 51 MB apiece) and the ~410 MB of bf16 transients that (a)
// writes and (b) reads back. Keeping h1/dh1 on chip, TMA staging and wgmma are
// later work; (b)'s atomics make dW1/dW2 sums run in a changing order.

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
constexpr int kRowsPerWarp = kBM / kWarps;
constexpr int kXbLd = kD + 8;   // bf16 x / du2c, row-major
constexpr int kW1Ld = kD + 8;   // bf16 W1 chunk [kFC][kD]
constexpr int kW2Ld = kFC + 8;  // bf16 W2 chunk [kD][kFC]
constexpr int kHsLd = kFC + 4;  // f32 chunk accumulators
constexpr int kHbLd = kFC + 8;  // bf16 chunk after cast / mask
constexpr int kNVec = 5;        // ds1, dsb1, ds2, dsb2, db2

// Shared-memory carve-up (byte offsets; each a multiple of 256).
constexpr int kXfOff = 0;                              // f32 x, later du2 [kBM][kD]
constexpr int kXbOff = kXfOff + kBM * kD * 4;          // bf16 x, later du2c
constexpr int kW1Off = kXbOff + kBM * kXbLd * 2;
constexpr int kW2Off = kW1Off + kFC * kW1Ld * 2;
constexpr int kHsOff = kW2Off + kD * kW2Ld * 2;
constexpr int kHbOff = kHsOff + kBM * kHsLd * 4;
constexpr int kVecOff = kHbOff + kBM * kHbLd * 2;      // f32 [kNVec][kD] block partials
constexpr int kStatOff = kVecOff + kNVec * kD * 4;     // f32 mean1, rstd1 [kBM] each
constexpr int kSmem = kStatOff + 2 * kBM * 4;
// f32 [kBM][kD] accumulators (h2, then dx_ffn) reuse the W1 and W2 chunk regions.
constexpr int kAccOff = kW1Off;
static_assert(kHsOff - kW1Off >= kBM * kD * 4, "accumulator reuse overflows");
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
__device__ __forceinline__ int chan(int lane, int j) { return (j / 4) * 128 + 4 * lane + (j % 4); }

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ void stage_w1(__nv_bfloat16* w1s, const __nv_bfloat16* w1, int f0, int tid) {
  for (int idx = tid; idx < kFC * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8), c8 = idx % (kD / 8);
    *reinterpret_cast<uint4*>(w1s + r * kW1Ld + 8 * c8) =
        *reinterpret_cast<const uint4*>(w1 + static_cast<long long>(f0 + r) * kD + 8 * c8);
  }
}

__device__ void stage_w2(__nv_bfloat16* w2s, const __nv_bfloat16* w2, int f0, int f, int tid) {
  for (int idx = tid; idx < kD * (kFC / 8); idx += kThreads) {
    const int r = idx / (kFC / 8), c8 = idx % (kFC / 8);
    *reinterpret_cast<uint4*>(w2s + r * kW2Ld + 8 * c8) =
        *reinterpret_cast<const uint4*>(w2 + static_cast<long long>(r) * f + f0 + 8 * c8);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
row_block_kernel(const float* __restrict__ src, const float* __restrict__ attn,
                 const __nv_bfloat16* __restrict__ w1,
                 const __nv_bfloat16* __restrict__ b1,
                 const __nv_bfloat16* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ b2,
                 const float* __restrict__ s1, const float* __restrict__ sb1,
                 const float* __restrict__ s2, const float* __restrict__ sb2,
                 const float* __restrict__ dy, float* __restrict__ du1,
                 __nv_bfloat16* __restrict__ xb_out, __nv_bfloat16* __restrict__ h1_out,
                 __nv_bfloat16* __restrict__ dh1_out, __nv_bfloat16* __restrict__ du2c_out,
                 float* __restrict__ part_vec, float* __restrict__ part_db1,
                 int n, int f, float eps) {
  extern __shared__ __align__(256) unsigned char smem[];
  float* xf = reinterpret_cast<float*>(smem + kXfOff);
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(smem + kXbOff);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + kW1Off);
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem + kW2Off);
  float* hs = reinterpret_cast<float*>(smem + kHsOff);
  __nv_bfloat16* hb = reinterpret_cast<__nv_bfloat16*>(smem + kHbOff);
  float* vec = reinterpret_cast<float*>(smem + kVecOff);
  float* mean1 = reinterpret_cast<float*>(smem + kStatOff);
  float* rstd1 = mean1 + kBM;
  float* acc_s = reinterpret_cast<float*>(smem + kAccOff);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int rt = warp >> 1;        // this warp's 16-row tile
  const int ct1 = (warp & 1) * 2;  // its two 16-col tiles of a hidden chunk
  const int ct2 = (warp & 1) * 8;  // its eight 16-col tiles of a [kBM, kD] output

  for (int i = tid; i < kNVec * kD; i += kThreads) vec[i] = 0.f;

  // ---- x = LN1(src + attn); rows past n read zeros -------------------------
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const long long g = row0 + r;
    float u[8];
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j);
      u[j] = g < n ? src[g * kD + c] + attn[g * kD + c] : 0.f;
      sum += u[j];
      sq += u[j] * u[j];
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    const float mean = sum / kD;
    const float rstd = rsqrtf(sq / kD - mean * mean + eps);
    if (lane == 0) {
      mean1[r] = mean;
      rstd1[r] = rstd;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j);
      const float x = (u[j] - mean) * rstd * s1[c] + sb1[c];
      xf[r * kD + c] = x;
      const __nv_bfloat16 xbv = __float2bfloat16(x);
      xb[r * kXbLd + c] = xbv;
      xb_out[g * kD + c] = xbv;
    }
  }

  // ---- recompute h1 (written out) and h2 = h1 @ W2 (in registers) ----------
  FragC acc2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc2[j], 0.f);
  for (int f0 = 0; f0 < f; f0 += kFC) {
    __syncthreads();
    stage_w1(w1s, w1, f0, tid);
    stage_w2(w2s, w2, f0, f, tid);
    __syncthreads();
    FragC acc1[2];
    wmma::fill_fragment(acc1[0], 0.f);
    wmma::fill_fragment(acc1[1], 0.f);
    for (int k = 0; k < kD; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, xb + rt * 16 * kXbLd + k, kXbLd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragBc b;
        wmma::load_matrix_sync(b, w1s + (ct1 + j) * 16 * kW1Ld + k, kW1Ld);
        wmma::mma_sync(acc1[j], a, b, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(hs + rt * 16 * kHsLd + (ct1 + j) * 16, acc1[j], kHsLd,
                              wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kBM * kFC; idx += kThreads) {
      const int r = idx / kFC, c = idx % kFC;
      const float v = round_bf16(round_bf16(hs[r * kHsLd + c]) +
                                 __bfloat162float(b1[f0 + c]));
      const __nv_bfloat16 h = __float2bfloat16(fmaxf(v, 0.f));
      hb[r * kHbLd + c] = h;
      h1_out[(row0 + r) * f + f0 + c] = h;
    }
    __syncthreads();
    for (int k = 0; k < kFC; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, hb + rt * 16 * kHbLd + k, kHbLd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragBc b;
        wmma::load_matrix_sync(b, w2s + (ct2 + j) * 16 * kW2Ld + k, kW2Ld);
        wmma::mma_sync(acc2[j], a, b, acc2[j]);
      }
    }
  }
  __syncthreads();  // every warp is done with w1s/w2s before acc_s overwrites them
#pragma unroll
  for (int j = 0; j < 8; ++j)
    wmma::store_matrix_sync(acc_s + rt * 16 * kD + (ct2 + j) * 16, acc2[j], kD,
                            wmma::mem_row_major);
  __syncthreads();

  // ---- LN2 forward + backward per row: du2 (f32, over xf), du2c (bf16) -----
  {
    float p_ds2[8], p_dsb2[8], p_db2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p_ds2[j] = p_dsb2[j] = p_db2[j] = 0.f;
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const long long g = row0 + r;
      float u[8], dyv[8];
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = chan(lane, j);
        const float h2 = round_bf16(round_bf16(acc_s[r * kD + c]) + __bfloat162float(b2[c]));
        u[j] = xf[r * kD + c] + h2;
        dyv[j] = g < n ? dy[g * kD + c] : 0.f;
        sum += u[j];
        sq += u[j] * u[j];
      }
      sum = warp_sum(sum);
      sq = warp_sum(sq);
      const float mean = sum / kD;
      const float rstd = rsqrtf(sq / kD - mean * mean + eps);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = chan(lane, j);
        u[j] = (u[j] - mean) * rstd;  // xhat2
        const float dxh = dyv[j] * s2[c];
        m1 += dxh;
        m2 += dxh * u[j];
        p_ds2[j] += dyv[j] * u[j];
        p_dsb2[j] += dyv[j];
      }
      m1 = warp_sum(m1) / kD;
      m2 = warp_sum(m2) / kD;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = chan(lane, j);
        const float du2 = rstd * (dyv[j] * s2[c] - m1 - u[j] * m2);
        p_db2[j] += du2;
        xf[r * kD + c] = du2;
        const __nv_bfloat16 dc = __float2bfloat16(du2);
        xb[r * kXbLd + c] = dc;
        du2c_out[g * kD + c] = dc;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j);
      atomicAdd(vec + 2 * kD + c, p_ds2[j]);
      atomicAdd(vec + 3 * kD + c, p_dsb2[j]);
      atomicAdd(vec + 4 * kD + c, p_db2[j]);
    }
  }

  // ---- dh1 = bf16(du2c @ W2^T) * (h1 > 0); dx_ffn = dh1 @ W1 ---------------
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc2[j], 0.f);
  for (int f0 = 0; f0 < f; f0 += kFC) {
    __syncthreads();  // du2c is complete; the previous chunk is done with w1s/w2s/hb
    stage_w1(w1s, w1, f0, tid);
    stage_w2(w2s, w2, f0, f, tid);
    __syncthreads();
    FragC acc1[2];
    wmma::fill_fragment(acc1[0], 0.f);
    wmma::fill_fragment(acc1[1], 0.f);
    for (int k = 0; k < kD; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, xb + rt * 16 * kXbLd + k, kXbLd);  // du2c
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // B[k=j_d][n=f] = W2[j_d][f0 + f]: the W2 chunk read row-major
        FragBr b;
        wmma::load_matrix_sync(b, w2s + k * kW2Ld + (ct1 + j) * 16, kW2Ld);
        wmma::mma_sync(acc1[j], a, b, acc1[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(hs + rt * 16 * kHsLd + (ct1 + j) * 16, acc1[j], kHsLd,
                              wmma::mem_row_major);
    __syncthreads();
    for (int idx = tid; idx < kBM * kFC; idx += kThreads) {
      const int r = idx / kFC, c = idx % kFC;
      const long long gi = (row0 + r) * f + f0 + c;
      const bool on = __bfloat162float(h1_out[gi]) > 0.f;
      const __nv_bfloat16 v = on ? __float2bfloat16(hs[r * kHsLd + c]) : __float2bfloat16(0.f);
      hb[r * kHbLd + c] = v;
      dh1_out[gi] = v;
    }
    __syncthreads();
    if (tid < kFC) {  // db1 partial from the bf16 dh1, rows in order
      float s = 0.f;
      for (int r = 0; r < kBM; ++r) s += __bfloat162float(hb[r * kHbLd + tid]);
      part_db1[static_cast<long long>(blockIdx.x) * f + f0 + tid] = s;
    }
    for (int k = 0; k < kFC; k += 16) {
      FragA a;
      wmma::load_matrix_sync(a, hb + rt * 16 * kHbLd + k, kHbLd);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B[k=f][n=j_d] = W1[f0 + f][j_d]: the W1 chunk read row-major
        FragBr b;
        wmma::load_matrix_sync(b, w1s + k * kW1Ld + (ct2 + j) * 16, kW1Ld);
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

  // ---- LN1 backward: dx = du2 + dx_ffn -> du1 -------------------------------
  {
    float p_ds1[8], p_dsb1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) p_ds1[j] = p_dsb1[j] = 0.f;
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const long long g = row0 + r;
      const float mean = mean1[r], rstd = rstd1[r];
      float xh[8], dx[8];
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = chan(lane, j);
        const float u = g < n ? src[g * kD + c] + attn[g * kD + c] : 0.f;
        xh[j] = (u - mean) * rstd;
        dx[j] = xf[r * kD + c] + acc_s[r * kD + c];
        const float dxh = dx[j] * s1[c];
        m1 += dxh;
        m2 += dxh * xh[j];
        p_ds1[j] += dx[j] * xh[j];
        p_dsb1[j] += dx[j];
      }
      m1 = warp_sum(m1) / kD;
      m2 = warp_sum(m2) / kD;
      if (g < n) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = chan(lane, j);
          du1[g * kD + c] = rstd * (dx[j] * s1[c] - m1 - xh[j] * m2);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = chan(lane, j);
      atomicAdd(vec + 0 * kD + c, p_ds1[j]);
      atomicAdd(vec + 1 * kD + c, p_dsb1[j]);
    }
  }
  __syncthreads();
  for (int i = tid; i < kNVec * kD; i += kThreads)
    part_vec[static_cast<long long>(blockIdx.x) * kNVec * kD + i] = vec[i];
}

// C[mo, no] += sum_k A[k, i] * B[k, j] over this block's split of k.
// A [K, mo] row-major (lda = mo), B [K, no] row-major (ldb = no); mo, no
// multiples of 64, K a multiple of 16.
constexpr int kSplit = 1024;

__global__ void __launch_bounds__(kThreads)
atb_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
           float* __restrict__ c, int k_total, int mo, int no) {
  __shared__ __align__(256) float tile[64 * 64];
  const int warp = threadIdx.x >> 5;
  const int i0 = blockIdx.y * 64;
  const int j0 = blockIdx.x * 64;
  const int k_begin = blockIdx.z * kSplit;
  const int k_end = min(k_begin + kSplit, k_total);
  const int ti = warp >> 1;          // 16-row tile of the 64x64 output
  const int tj = (warp & 1) * 2;     // its two 16-col tiles
  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  for (int k = k_begin; k < k_end; k += 16) {
    // A^T tile (i, k) = A[k, i]: column-major with leading dimension mo
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa;
    wmma::load_matrix_sync(fa, a + static_cast<long long>(k) * mo + i0 + ti * 16, mo);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + static_cast<long long>(k) * no + j0 + (tj + j) * 16, no);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(tile + ti * 16 * 64 + (tj + j) * 16, acc[j], 64,
                            wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < 64 * 64; idx += kThreads) {
    const int r = idx / 64, col = idx % 64;
    atomicAdd(c + static_cast<long long>(i0 + r) * no + j0 + col, tile[idx]);
  }
}

// out[col] = sum_r part[r, col], rows in order.
__global__ void colsum_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int rows, int cols) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += part[static_cast<long long>(r) * cols + col];
  out[col] = s;
}

}  // namespace

// All pointers are device pointers; d must be 256 and f a multiple of 64.
// Scratch (rows padded to n_pad = 64 * ceil(n / 64)): xb, du2c [n_pad, 256] and
// h1, dh1 [n_pad, f] bf16; part_vec [n_blk, 5*256], part_db1 [n_blk, f] f32.
// dw1 [f, 256] and dw2 [256, f] must be zeroed. vec gets ds1, dsb1, ds2, dsb2,
// db2 ([5, 256]). Returns the first CUDA error of the five launches, or 0.
extern "C" int encoder_tail_bwd(const void* src, const void* attn, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* s1, const void* sb1, const void* s2,
                                const void* sb2, const void* dy, void* du1,
                                void* xb, void* h1, void* dh1, void* du2c,
                                void* part_vec, void* part_db1, void* dw1, void* dw2,
                                void* vec, void* db1, int n, int d, int f, float eps,
                                void* stream) {
  if (d != kD || f <= 0 || f % kFC != 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      row_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (n + kBM - 1) / kBM;
  const int n_pad = n_blk * kBM;
  row_block_kernel<<<n_blk, kThreads, kSmem, s>>>(
      static_cast<const float*>(src), static_cast<const float*>(attn),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(s1), static_cast<const float*>(sb1),
      static_cast<const float*>(s2), static_cast<const float*>(sb2),
      static_cast<const float*>(dy), static_cast<float*>(du1),
      static_cast<__nv_bfloat16*>(xb), static_cast<__nv_bfloat16*>(h1),
      static_cast<__nv_bfloat16*>(dh1), static_cast<__nv_bfloat16*>(du2c),
      static_cast<float*>(part_vec), static_cast<float*>(part_db1), n, f, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int splits = (n_pad + kSplit - 1) / kSplit;
  // dW1 [f, 256] = dh1^T x
  atb_kernel<<<dim3(kD / 64, f / 64, splits), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(dh1), static_cast<const __nv_bfloat16*>(xb),
      static_cast<float*>(dw1), n_pad, f, kD);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dW2 [256, f] = du2c^T h1
  atb_kernel<<<dim3(f / 64, kD / 64, splits), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(du2c), static_cast<const __nv_bfloat16*>(h1),
      static_cast<float*>(dw2), n_pad, kD, f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<(kNVec * kD + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_vec), static_cast<float*>(vec), n_blk, kNVec * kD);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  colsum_kernel<<<(f + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part_db1), static_cast<float*>(db1), n_blk, f);
  return static_cast<int>(cudaGetLastError());
}
