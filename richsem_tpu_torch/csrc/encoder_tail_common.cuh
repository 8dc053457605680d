// Parts shared by K2 (fused_encoder_tail_fwd.cu) and K2-bwd
// (fused_encoder_tail_bwd.cu), so that both compute the same bf16(x), and with
// it the same relu masks, as the plain version:
//
// - LN1 of one row with PyTorch's roundings and torch 2.11's CUDA reduction
//   order (ln1_row), and LayerNorm's affine output (ln_out);
// - the f32 row-stream loads of the epilogues (load2) and the bf16 helpers;
// - the staging of one 64-wide W1 or W2 chunk into a 32 KB ring slot of
//   128-byte-swizzled blocks, by cp.async (stage_w1_chunk, stage_w2_chunk).
//
// Needs hopper_wgmma.cuh (swz, cp_async16).

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

#include "hopper_wgmma.cuh"

namespace tail {

constexpr int kD = 256;   // model width
constexpr int kFC = 64;   // hidden units per chunk

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sum over the four lanes of a quad: the 64 columns of a fragment row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Loads kept in program order (volatile): the LN passes load their row streams
// a few column pairs ahead, instead of having them scheduled early and kept
// live beside the 128 accumulator registers. Plain C++ volatile accesses keep
// [base + offset] addressing, so the unrolled passes need no register per
// address.
__device__ __forceinline__ float2 ldv2(const float* p) {
  const volatile float* v = p;
  return make_float2(v[0], v[1]);
}

// f32 pair (row g, columns c, c + 1) of a [N, 256] stream; zeros past row n
// (read from row n - 1 and dropped, so that the load needs no predicate).
__device__ __forceinline__ float2 load2(const float* p, long long g, int c, int n) {
  const float2 v = ldv2(p + min(g, static_cast<long long>(n) - 1) * kD + c);
  return g < n ? v : make_float2(0.f, 0.f);
}

// LayerNorm's affine output with PyTorch's roundings: (u - mean) * rstd * s + b,
// each operation rounded, no fused multiply-add.
__device__ __forceinline__ float ln_out(float u, float mean, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(u, mean), rstd), s), b);
}

// x = LN1(src + attn) of row g (rows past n read 0), one warp a row: lane t
// holds channels 4t .. 4t+3 and 128+4t .. 128+4t+3 and sums them as torch
// 2.11's CUDA row reduction does (four running sums, combined in order, then a
// shuffle-down tree from offset 16 down to 1), with every operation rounded as
// PyTorch rounds it, so that bf16(x), and with it the relu mask, is PyTorch's.
// -> the row's mean and rstd (every lane), and bf16(x) of the lane's channels
// packed: pk[h] holds channels 128 h + 4t .. 128 h + 4t + 3.
__device__ __forceinline__ void ln1_row(const float* __restrict__ src,
                                        const float* __restrict__ attn, long long g, int n,
                                        int lane, const float* __restrict__ s1,
                                        const float* __restrict__ sb1, float eps, float& mean,
                                        float& rstd, uint2 (&pk)[2]) {
  float u[8];
  if (g < n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 sv = *reinterpret_cast<const float4*>(src + g * kD + 128 * h + 4 * lane);
      const float4 av = *reinterpret_cast<const float4*>(attn + g * kD + 128 * h + 4 * lane);
      u[4 * h] = sv.x + av.x; u[4 * h + 1] = sv.y + av.y;
      u[4 * h + 2] = sv.z + av.z; u[4 * h + 3] = sv.w + av.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) u[k] = 0.f;
  }
  float sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(u[0], u[4]), __fadd_rn(u[1], u[5])),
                                  __fadd_rn(u[2], u[6])), __fadd_rn(u[3], u[7]));
  float sq[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) sq[k] = __fmul_rn(u[k], u[k]);
  float ssq = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sq[0], sq[4]), __fadd_rn(sq[1], sq[5])),
                                  __fadd_rn(sq[2], sq[6])), __fadd_rn(sq[3], sq[7]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum = __fadd_rn(sum, __shfl_down_sync(0xffffffffu, sum, o));
    ssq = __fadd_rn(ssq, __shfl_down_sync(0xffffffffu, ssq, o));
  }
  mean = __fmul_rn(__shfl_sync(0xffffffffu, sum, 0), 1.f / kD);
  const float msq = __fmul_rn(__shfl_sync(0xffffffffu, ssq, 0), 1.f / kD);
  rstd = rsqrtf(__fadd_rn(__fsub_rn(msq, __fmul_rn(mean, mean)), eps));
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = 128 * h + 4 * lane;
    pk[h].x = pack_bf16(ln_out(u[4 * h], mean, rstd, s1[c0], sb1[c0]),
                        ln_out(u[4 * h + 1], mean, rstd, s1[c0 + 1], sb1[c0 + 1]));
    pk[h].y = pack_bf16(ln_out(u[4 * h + 2], mean, rstd, s1[c0 + 2], sb1[c0 + 2]),
                        ln_out(u[4 * h + 3], mean, rstd, s1[c0 + 3], sb1[c0 + 3]));
  }
}

// Byte offset of bf16(x)'s channels c0 .. c0 + 3 (c0 % 4 == 0) of row lr (0..63)
// inside a 64-row A tile of 4 swizzled blocks [64 rows][64 channels], 8 KB apart.
__device__ __forceinline__ uint32_t x_tile_offset(int lr, int c0) {
  return static_cast<uint32_t>((c0 >> 6) * 8192) + hopper::swz(lr, (c0 & 63) >> 3) + (c0 & 4) * 2;
}

// One W1 chunk (rows f0 .. f0 + 63 of W1 [F, 256]) into a 32 KB slot as 4
// blocks of [64 f][64 d], 8 KB apart: K-major for x W1c^T, MN-major for dh1 W1c.
// kThreads threads (thread index tid) issue 2048 / kThreads copies each.
template <int kThreads>
__device__ __forceinline__ void stage_w1_chunk(uint32_t slot, const __nv_bfloat16* w1, int f0,
                                               int tid) {
#pragma unroll
  for (int i = 0; i < 2048 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 5, c = idx & 31;
    hopper::cp_async16(slot + (c >> 3) * 8192 + hopper::swz(r, c & 7),
                       w1 + static_cast<long long>(f0 + r) * kD + c * 8);
  }
}

// One W2 chunk (columns f0 .. f0 + 63 of W2 [256, F]) into a 32 KB slot as one
// block of [256 d][64 f]: K-major for h1c W2c^T, MN-major for du2c W2c.
template <int kThreads>
__device__ __forceinline__ void stage_w2_chunk(uint32_t slot, const __nv_bfloat16* w2, int f,
                                               int f0, int tid) {
#pragma unroll
  for (int i = 0; i < 2048 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 3, c = idx & 7;
    hopper::cp_async16(slot + hopper::swz(r, c), w2 + static_cast<long long>(r) * f + f0 + c * 8);
  }
}

}  // namespace tail
