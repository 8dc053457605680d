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
// What bounds it: the tensor cores. Six products of 2*N*256*F (h1, h2, dh1,
// dx_ffn in the row pass; dW1, dW2), 315 GFLOP at N = 49,980, F = 2048, are
// 0.32 ms at the H100's 989 TFLOP/s bf16 peak; the bytes the function must
// move (the f32 row streams, the weights and their gradients) are ~0.07 ms.
// The design keeps the products on the tensor cores' fast path and the
// transients off device memory where it can:
//
// (a) row_pass: a block of two consumer warpgroups owns 128 rows, 64 each, and
//     every product runs as wgmma.mma_async (m64n64k16 for a 64-wide hidden
//     chunk, m64n256k16 for the [64 x 256] h2 and dx accumulators, which stay
//     in registers: 128 f32 a thread, 255 registers and no spills). The W1 and
//     W2 chunks come through a three-slot shared-memory ring filled by
//     cp.async two steps ahead, so the next chunk is loading while this one
//     multiplies, and both warpgroups share each staged chunk. The bias, relu
//     and bf16 casts run on the accumulator registers; the bf16 h1 / dh1 chunk
//     goes to shared memory as the A operand of the next product and to device
//     memory for (b). The relu mask stays on chip as bits in the accumulator's
//     own fragment order (one 32-bit word a thread and chunk, 32 KB a block),
//     so the second walk reads no h1. dx_ffn accumulates onto du2 in the same
//     registers. LN1 and LN2 and their backward run on the fragments with quad
//     shuffles; LN1's forward reproduces PyTorch's reduction order and
//     roundings, so that bf16(x) and the relu mask are PyTorch's bit for bit.
//     That order is how torch 2.11's CUDA mean reduces a 256-wide f32 row, a
//     detail of that build, not of LayerNorm: chip_smoke.py phase 5 counts the
//     elements of bf16(x) and the relu masks that differ from the plain
//     version's, so a PyTorch that reduces in another order shows there.
//     The column sums (ds1, dsb1, ds2, dsb2, db2, db1) are added over the
//     block's warps in a fixed order. What is left between the products and
//     the card's rate: the block synchronises at every step (the ring, then
//     the wgmma wait before each epilogue), so the tensor cores idle through
//     the epilogues and the two LN stages, whose row-stream loads are issued
//     in order to keep the registers for the accumulators.
// (b) dw_gemm: dW2 = du2c^T h1 and dW1^T = bf16(x)^T dh1 in one launch, as
//     [256 x 128] output tiles over a 4-stage cp.async ring; both operands are
//     MN-major (rows of [N, .] data), read by wgmma's transpose bits. The row
//     axis is split in up to 4 ranges so that 128 blocks fill the card; each
//     split writes its f32 partial tile to scratch, and no atomics are used.
// (c) colsum: the split partials of dW1 and dW2 and the per-block column sums
//     summed in a fixed order. Every output is therefore bit-reproducible from
//     call to call.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kD = 256;          // model width
constexpr int kFC = 64;          // hidden units per chunk
constexpr int kBM = 128;         // rows per block: 64 per consumer warpgroup
constexpr int kThreads = 256;    // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks = 32;   // F <= 2048: the relu mask's room
constexpr int kStages = 3;       // ring slots, one 32 KB weight chunk each
constexpr int kSlot = 32768;
constexpr int kNVec = 5;         // ds1, dsb1, ds2, dsb2, db2
constexpr int kPf = 2;           // LN passes: column pairs of the row streams loaded ahead

// Shared-memory carve-up of the row pass (byte offsets from a 1024-aligned base).
constexpr int kXaOff = 0;                          // bf16 x, later du2c: 2 x [4 blocks of 64 x 64]
constexpr int kHcOff = kXaOff + 2 * 32768;         // bf16 h1 / dh1 chunk: 2 x [64 x 64]
constexpr int kRingOff = kHcOff + 2 * 8192;        // kStages weight chunks
constexpr int kMaskOff = kRingOff + kStages * kSlot;   // u32 [2][kMaxChunks][128]
constexpr int kStatOff = kMaskOff + 2 * kMaxChunks * 128 * 4;  // f32 mean1, rstd1 [kBM]
constexpr int kRedOff = kStatOff + 2 * kBM * 4;              // f32 [kWarps][kD] column sums
constexpr int kParOff = kRedOff + kWarps * kD * 4;           // f32 s1, sb1, s2, b2 [kD] each
constexpr int kB1Off = kParOff + 4 * kD * 4;                  // bf16 b1 [kMaxChunks * kFC]
constexpr int kRowSmem = kB1Off + kMaxChunks * kFC * 2 + 1024;  // + alignment slack
static_assert(kRowSmem <= 232448, "too much shared memory");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Sum over the four lanes of a quad: the 64 columns of a fragment row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the eight quads of a warp: a column's 16 fragment rows.
__device__ __forceinline__ float col_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Loads kept in program order (volatile): the LN passes load their row streams
// kPf column pairs ahead, instead of having them scheduled early and kept live
// beside the 128 accumulator registers. Plain C++ volatile accesses keep
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

// Block column sums in a fixed order: after col_sum, lanes 0-3 of each warp hold
// its 16 rows' sums of columns c, c + 1; red_put stages them in a [kWarps][kD]
// buffer, red_flush (a barrier, then one thread a column) adds the 8 warps in
// order, for nv consecutive buffers and output vectors. Every thread of the
// block calls both.
__device__ __forceinline__ void red_put(float* red, int warp, int lane, int c, float p0,
                                        float p1) {
  if (lane < 4) *reinterpret_cast<float2*>(red + warp * kD + c) = make_float2(p0, p1);
}

__device__ __forceinline__ void red_flush(const float* red, float* out, int tid, int nv = 1) {
  __syncthreads();
  for (int v = 0; v < nv; ++v) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(v * kWarps + w) * kD + tid];
    out[v * kD + tid] = s;
  }
  __syncthreads();  // the buffers are free again
}

// Step t of the row pass: phase A (t < 2 NC) walks W1 chunk j then W2 chunk j;
// phase B walks W2 chunk j then W1 chunk j. Slot layouts: a W1 chunk is 4 blocks
// of [64 f][64 d], a W2 chunk one block of [256 d][64 f].
__device__ __forceinline__ bool step_is_w1(int t, int nc) {
  return t < 2 * nc ? (t & 1) == 0 : (t & 1) == 1;
}

__device__ void load_step(uint32_t slot, const __nv_bfloat16* w1, const __nv_bfloat16* w2,
                          int t, int nc, int f, int tid) {
  const int f0 = ((t < 2 * nc ? t : t - 2 * nc) >> 1) * kFC;
  if (step_is_w1(t, nc)) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 5, c = idx & 31;
      cp_async16(slot + (c >> 3) * 8192 + swz(r, c & 7),
                 w1 + static_cast<long long>(f0 + r) * kD + c * 8);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 3, c = idx & 7;
      cp_async16(slot + swz(r, c), w2 + static_cast<long long>(r) * f + f0 + c * 8);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
row_pass_kernel(const float* __restrict__ src, const float* __restrict__ attn,
                const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ b1,
                const __nv_bfloat16* __restrict__ w2, const __nv_bfloat16* __restrict__ b2,
                const float* __restrict__ s1, const float* __restrict__ sb1,
                const float* __restrict__ s2, const float* __restrict__ sb2,
                const float* __restrict__ dy, float* __restrict__ du1,
                __nv_bfloat16* __restrict__ xb_out, __nv_bfloat16* __restrict__ h1_out,
                __nv_bfloat16* __restrict__ dh1_out, __nv_bfloat16* __restrict__ du2c_out,
                float* __restrict__ part_vec, float* __restrict__ part_db1,
                int n, int f, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  float* mean1 = reinterpret_cast<float*>(smem + kStatOff);
  float* rstd1 = mean1 + kBM;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;           // this thread's warpgroup: rows 64 wg .. 64 wg + 63
  const int tw = tid & 127;
  const int nc = f / kFC;
  const int n_steps = 4 * nc;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const uint32_t xa = sbase + kXaOff + wg * 32768;
  const uint32_t hc = sbase + kHcOff + wg * 8192;
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + kMaskOff) + wg * kMaxChunks * 128;
  float* red = reinterpret_cast<float*>(smem + kRedOff);
  // the per-column parameters, read in every epilogue and LN pass
  float* par = reinterpret_cast<float*>(smem + kParOff);  // s1, sb1, s2, b2
  const volatile float* vpar = par;
  __nv_bfloat16* b1s = reinterpret_cast<__nv_bfloat16*>(smem + kB1Off);
  par[tid] = s1[tid];
  par[kD + tid] = sb1[tid];
  par[2 * kD + tid] = s2[tid];
  par[3 * kD + tid] = __bfloat162float(b2[tid]);
  for (int i = tid; i < f; i += kThreads) b1s[i] = b1[i];
  float* pv = part_vec + static_cast<long long>(blockIdx.x) * (kNVec * kD);
  float* pdb1 = part_db1 + static_cast<long long>(blockIdx.x) * f;

  load_step(sbase + kRingOff, w1, w2, 0, nc, f, tid);
  cp_async_commit();
  load_step(sbase + kRingOff + kSlot, w1, w2, 1, nc, f, tid);
  cp_async_commit();

  // ---- x = LN1(src + attn) -> bf16 A operand and xb_out; rows past n read 0.
  // A warp a row; lane t holds channels 4t .. 4t+3 and 128+4t .. 128+4t+3 and
  // sums them as torch 2.11's CUDA row reduction does (four running sums,
  // combined in order, then a shuffle-down tree from offset 16 down to 1), with
  // every operation rounded as PyTorch rounds it, so that bf16(x), and with it
  // the relu mask, is PyTorch's.
  for (int i = 0; i < kBM / kWarps; ++i) {
    const int r = warp * (kBM / kWarps) + i;
    const long long g = row0 + r;
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
    const float mean = __fmul_rn(__shfl_sync(0xffffffffu, sum, 0), 1.f / kD);
    const float msq = __fmul_rn(__shfl_sync(0xffffffffu, ssq, 0), 1.f / kD);
    const float rstd = rsqrtf(__fadd_rn(__fsub_rn(msq, __fmul_rn(mean, mean)), eps));
    if (lane == 0) {
      mean1[r] = mean;
      rstd1[r] = rstd;
    }
    const int lr = r & 63;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = 128 * h + 4 * lane;
      uint2 pk;
      pk.x = pack_bf16(ln_out(u[4 * h], mean, rstd, s1[c0], sb1[c0]),
                       ln_out(u[4 * h + 1], mean, rstd, s1[c0 + 1], sb1[c0 + 1]));
      pk.y = pack_bf16(ln_out(u[4 * h + 2], mean, rstd, s1[c0 + 2], sb1[c0 + 2]),
                       ln_out(u[4 * h + 3], mean, rstd, s1[c0 + 3], sb1[c0 + 3]));
      // column c0 sits in block c0 / 64, 16-byte chunk (c0 % 64) / 8, half (c0 % 8) / 4
      *reinterpret_cast<uint2*>(smem + kXaOff + (r >> 6) * 32768 + (c0 >> 6) * 8192 +
                                swz(lr, (c0 & 63) >> 3) + (c0 & 4) * 2) = pk;
      *reinterpret_cast<uint2*>(xb_out + g * kD + c0) = pk;
    }
  }

  float acc[128];  // h2, then du2 + dx_ffn: the [64 x 256] fragment
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();  // step t's chunk, and every shared write of step t - 1, visible
    if (t + 2 < n_steps)
      load_step(sbase + kRingOff + ((t + 2) % kStages) * kSlot, w1, w2, t + 2, nc, f, tid);
    cp_async_commit();
    const uint32_t slot = sbase + kRingOff + (t % kStages) * kSlot;
    // Descriptors and addresses are rebuilt every step, not hoisted out of the
    // loop, where they would hold registers beside the accumulators.
    const uint32_t xa_t = opaque(xa), hc_t = opaque(hc);
    const int lane_t = static_cast<int>(opaque(lane));
    const int q = lane_t & 3;  // this thread's column pairs: 8 jj + 2 q
    // its two fragment rows (block-local) and their global indices
    const int fr0 = 64 * wg + 16 * (warp & 3) + (lane_t >> 2);
    const long long g0 = row0 + fr0, g1 = g0 + 8;
    const bool phase_a = t < 2 * nc;
    const int j = (phase_a ? t : t - 2 * nc) >> 1;
    const int f0 = j * kFC;
    if (!phase_a && (t & 1) && tid < kFC) {  // the block's db1 of chunk j, warps in order
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w * kD + tid];
      pdb1[f0 + tid] = s;
    }

    if (!(t & 1)) {
      // ---- a 64-wide hidden chunk: h1 = x @ W1c^T (A), dh1 = du2c @ W2c (B) ----
      float a1[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.f;
      reg_fence(a1);
      wgmma_fence();
      if (phase_a)  // W1 chunk K-major: 4 blocks of [64 f][64 d]
        mma_k<0, 16, 0, 0, 64, 64>(a1, desc_lo(xa_t, 16), desc_lo(slot, 16));
      else  // W2 chunk MN-major: [256 d][64 f]
        mma_k<0, 16, 0, 1, 64, 0>(a1, desc_lo(xa_t, 16), desc_lo(slot, 8192));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(a1);
      uint32_t bits = phase_a ? 0u : mask[j * 128 + tw];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + 2 * q;
        float v[4];
        if (phase_a) {
          const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b1s + f0 + c);
          const float bl = __low2float(bb), bh = __high2float(bb);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float h = round_bf16(round_bf16(a1[4 * jj + e]) + ((e & 1) ? bh : bl));
            v[e] = fmaxf(h, 0.f);
            if (v[e] > 0.f) bits |= 1u << (4 * jj + e);
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = (bits >> (4 * jj + e)) & 1u ? round_bf16(a1[4 * jj + e]) : 0.f;
          // db1 from the bf16 dh1: this warp's 16 rows of columns c, c + 1
          const float p0 = col_sum(v[0] + v[2]), p1 = col_sum(v[1] + v[3]);
          red_put(red, warp, lane, c, p0, p1);  // summed over the warps at step t + 1
        }
        const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
        const int lr0 = fr0 & 63;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hc_t + swz(lr0, jj) + 4 * q), "r"(lo));
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hc_t + swz(lr0 + 8, jj) + 4 * q), "r"(hi));
        __nv_bfloat16* out = phase_a ? h1_out : dh1_out;
        *reinterpret_cast<uint32_t*>(out + g0 * f + f0 + c) = lo;
        *reinterpret_cast<uint32_t*>(out + g1 * f + f0 + c) = hi;
      }
      if (phase_a) mask[j * 128 + tw] = bits;
    } else {
      // ---- the [64 x 256] accumulator: h2 += h1c @ W2c^T (A), dx += dh1c @ W1c (B)
      reg_fence(acc);
      wgmma_fence();
      if (phase_a)  // W2 chunk K-major: [256 d][64 f]
        mma_k<0, 4, 0, 0, 64, 256>(acc, desc_lo(hc_t, 16), desc_lo(slot, 16));
      else  // W1 chunk MN-major: 4 blocks of [64 f][64 d], 8 KB apart
        mma_k<0, 4, 0, 1, 64, 0>(acc, desc_lo(hc_t, 16), desc_lo(slot, 8192));
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);

      if (t == 2 * nc - 1) {
        // ---- LN2 forward and backward on the fragment: acc becomes du2 ---------
        // Row streams are loaded kPf column pairs ahead of their use; the column
        // sums go to the free ring slot (its chunk is consumed, the next load
        // into it is issued at step t + 1), one [kWarps][kD] buffer a vector.
        float* cbuf = reinterpret_cast<float*>(smem + kRingOff + (t % kStages) * kSlot);
        __syncthreads();  // both warpgroups are done reading the slot's chunk
        float mu1[2], rs1[2], sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mu1[hr] = mean1[fr0 + 8 * hr];
          rs1[hr] = rstd1[fr0 + 8 * hr];
        }
        {
          float2 ps[kPf][2], pa[kPf][2];
#pragma unroll
          for (int k = 0; k < kPf; ++k) {
            ps[k][0] = load2(src, g0, 8 * k + 2 * q, n), ps[k][1] = load2(src, g1, 8 * k + 2 * q, n);
            pa[k][0] = load2(attn, g0, 8 * k + 2 * q, n), pa[k][1] = load2(attn, g1, 8 * k + 2 * q, n);
          }
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int c = 8 * jj + 2 * q, k = jj % kPf;
            const float2 sv[2] = {ps[k][0], ps[k][1]}, av[2] = {pa[k][0], pa[k][1]};
            if (jj + kPf < 32) {
              ps[k][0] = load2(src, g0, c + 8 * kPf, n), ps[k][1] = load2(src, g1, c + 8 * kPf, n);
              pa[k][0] = load2(attn, g0, c + 8 * kPf, n), pa[k][1] = load2(attn, g1, c + 8 * kPf, n);
            }
            const float sc0 = vpar[c], sc1 = vpar[c + 1];
            const float bi0 = vpar[kD + c], bi1 = vpar[kD + c + 1];
            const float bb0 = vpar[3 * kD + c], bb1 = vpar[3 * kD + c + 1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const float x0 = ln_out(sv[hr].x + av[hr].x, mu1[hr], rs1[hr], sc0, bi0);
              const float x1 = ln_out(sv[hr].y + av[hr].y, mu1[hr], rs1[hr], sc1, bi1);
              float& a0 = acc[4 * jj + 2 * hr];
              float& a1v = acc[4 * jj + 2 * hr + 1];
              a0 = x0 + round_bf16(round_bf16(a0) + bb0);  // u2 = x + h2
              a1v = x1 + round_bf16(round_bf16(a1v) + bb1);
              sum[hr] += a0 + a1v;
              sq[hr] += a0 * a0 + a1v * a1v;
            }
          }
        }
        float mean[2], rstd[2], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mean[hr] = quad_sum(sum[hr]) / kD;
          rstd[hr] = rsqrtf(quad_sum(sq[hr]) / kD - mean[hr] * mean[hr] + eps);
        }
        {  // xhat2 in place, m1 and m2; the column sums ds2 = sum dy*xhat2, dsb2 = sum dy
          float2 pd[kPf][2];
#pragma unroll
          for (int k = 0; k < kPf; ++k)
            pd[k][0] = load2(dy, g0, 8 * k + 2 * q, n), pd[k][1] = load2(dy, g1, 8 * k + 2 * q, n);
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int c = 8 * jj + 2 * q, k = jj % kPf;
            const float2 d[2] = {pd[k][0], pd[k][1]};
            if (jj + kPf < 32)
              pd[k][0] = load2(dy, g0, c + 8 * kPf, n), pd[k][1] = load2(dy, g1, c + 8 * kPf, n);
            const float sc0 = vpar[2 * kD + c], sc1 = vpar[2 * kD + c + 1];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& a0 = acc[4 * jj + 2 * hr];
              float& a1v = acc[4 * jj + 2 * hr + 1];
              a0 = (a0 - mean[hr]) * rstd[hr];
              a1v = (a1v - mean[hr]) * rstd[hr];
              m1[hr] += d[hr].x * sc0 + d[hr].y * sc1;
              m2[hr] += d[hr].x * sc0 * a0 + d[hr].y * sc1 * a1v;
            }
            red_put(cbuf, warp, lane, c, col_sum(d[0].x * acc[4 * jj] + d[1].x * acc[4 * jj + 2]),
                    col_sum(d[0].y * acc[4 * jj + 1] + d[1].y * acc[4 * jj + 3]));
            red_put(cbuf + kWarps * kD, warp, lane, c, col_sum(d[0].x + d[1].x),
                    col_sum(d[0].y + d[1].y));
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          m1[hr] = quad_sum(m1[hr]) / kD;
          m2[hr] = quad_sum(m2[hr]) / kD;
        }
        {  // du2 in place, its bf16 copy to shared memory (the A operand of phase B)
           // and to du2c_out, and the column sums db2 = sum du2
          const int lr0 = fr0 & 63;
          float2 pd[kPf][2];
#pragma unroll
          for (int k = 0; k < kPf; ++k)
            pd[k][0] = load2(dy, g0, 8 * k + 2 * q, n), pd[k][1] = load2(dy, g1, 8 * k + 2 * q, n);
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int c = 8 * jj + 2 * q, k = jj % kPf;
            const float2 d[2] = {pd[k][0], pd[k][1]};
            if (jj + kPf < 32)
              pd[k][0] = load2(dy, g0, c + 8 * kPf, n), pd[k][1] = load2(dy, g1, c + 8 * kPf, n);
            const float sc[2] = {vpar[2 * kD + c], vpar[2 * kD + c + 1]};
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              float& a0 = acc[4 * jj + 2 * hr];
              float& a1v = acc[4 * jj + 2 * hr + 1];
              a0 = rstd[hr] * (d[hr].x * sc[0] - m1[hr] - a0 * m2[hr]);
              a1v = rstd[hr] * (d[hr].y * sc[1] - m1[hr] - a1v * m2[hr]);
            }
            red_put(cbuf + 2 * kWarps * kD, warp, lane, c, col_sum(acc[4 * jj] + acc[4 * jj + 2]),
                    col_sum(acc[4 * jj + 1] + acc[4 * jj + 3]));
            const uint32_t lo = pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
            const uint32_t hi = pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
            const uint32_t blk = xa_t + (jj >> 3) * 8192;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(blk + swz(lr0, jj & 7) + 4 * q), "r"(lo));
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(blk + swz(lr0 + 8, jj & 7) + 4 * q),
                         "r"(hi));
            *reinterpret_cast<uint32_t*>(du2c_out + g0 * kD + c) = lo;
            *reinterpret_cast<uint32_t*>(du2c_out + g1 * kD + c) = hi;
          }
        }
        red_flush(cbuf, pv + 2 * kD, tid, 3);  // ds2, dsb2, db2
      } else if (t == n_steps - 1) {
        // ---- LN1 backward on the fragment: acc = dx = du2 + dx_ffn -> du1 -------
        float* cbuf = reinterpret_cast<float*>(smem + kRingOff + (t % kStages) * kSlot);
        __syncthreads();  // both warpgroups are done reading the slot's chunk
        float mu1[2], rs1[2], m1[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          mu1[hr] = mean1[fr0 + 8 * hr];
          rs1[hr] = rstd1[fr0 + 8 * hr];
        }
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {  // m1, m2; then du1 and ds1, dsb1
          float2 ps[kPf][2], pa[kPf][2];
#pragma unroll
          for (int k = 0; k < kPf; ++k) {
            ps[k][0] = load2(src, g0, 8 * k + 2 * q, n), ps[k][1] = load2(src, g1, 8 * k + 2 * q, n);
            pa[k][0] = load2(attn, g0, 8 * k + 2 * q, n), pa[k][1] = load2(attn, g1, 8 * k + 2 * q, n);
          }
#pragma unroll
          for (int jj = 0; jj < 32; ++jj) {
            const int c = 8 * jj + 2 * q, k = jj % kPf;
            const float2 sv[2] = {ps[k][0], ps[k][1]}, av[2] = {pa[k][0], pa[k][1]};
            if (jj + kPf < 32) {
              ps[k][0] = load2(src, g0, c + 8 * kPf, n), ps[k][1] = load2(src, g1, c + 8 * kPf, n);
              pa[k][0] = load2(attn, g0, c + 8 * kPf, n), pa[k][1] = load2(attn, g1, c + 8 * kPf, n);
            }
            const float sc[2] = {vpar[c], vpar[c + 1]};
            float xh[2][2];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              xh[hr][0] = (sv[hr].x + av[hr].x - mu1[hr]) * rs1[hr];
              xh[hr][1] = (sv[hr].y + av[hr].y - mu1[hr]) * rs1[hr];
              const float d0 = acc[4 * jj + 2 * hr] * sc[0], d1 = acc[4 * jj + 2 * hr + 1] * sc[1];
              if (pass == 0) {
                m1[hr] += d0 + d1;
                m2[hr] += d0 * xh[hr][0] + d1 * xh[hr][1];
              } else if ((hr ? g1 : g0) < n) {
                *reinterpret_cast<float2*>(du1 + (hr ? g1 : g0) * kD + c) =
                    make_float2(rs1[hr] * (d0 - m1[hr] - xh[hr][0] * m2[hr]),
                                rs1[hr] * (d1 - m1[hr] - xh[hr][1] * m2[hr]));
              }
            }
            if (pass == 1) {
              red_put(cbuf, warp, lane, c,
                      col_sum(acc[4 * jj] * xh[0][0] + acc[4 * jj + 2] * xh[1][0]),
                      col_sum(acc[4 * jj + 1] * xh[0][1] + acc[4 * jj + 3] * xh[1][1]));
              red_put(cbuf + kWarps * kD, warp, lane, c, col_sum(acc[4 * jj] + acc[4 * jj + 2]),
                      col_sum(acc[4 * jj + 1] + acc[4 * jj + 3]));
            }
          }
          if (pass == 0) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              m1[hr] = quad_sum(m1[hr]) / kD;
              m2[hr] = quad_sum(m2[hr]) / kD;
            }
          }
        }
        red_flush(cbuf, pv, tid, 2);  // ds1 = sum dx * xhat1, dsb1 = sum dx
      }
    }
  }
  cp_async_wait<0>();
}

// ---- (b) dW2 = du2c^T h1 ([256, F]) and dW1^T = xb^T dh1 (stored as [F, 256]) --
// One block: a [256 x 128] output tile of one product over one split of the rows;
// warpgroup w owns output rows 128 w .. 128 w + 127 as two m64n128 accumulators.
constexpr int kGStages = 4;
constexpr int kGA = 32768;            // A stage: [64 rows][256] as 4 blocks of 64 x 64
constexpr int kGB = 16384;            // B stage: [64 rows][128] as 2 blocks
constexpr int kGStage = kGA + kGB;
constexpr int kGemmSmem = kGStages * kGStage + 1024;
constexpr int kMaxSplits = 4;
static_assert(kGemmSmem <= 232448, "too much shared memory");

__device__ void gemm_load(uint32_t stage, const __nv_bfloat16* a, const __nv_bfloat16* b,
                          long long k0, int n0, int f, int tid) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 5, c = idx & 31;
    cp_async16(stage + (c >> 3) * 8192 + swz(r, c & 7), a + (k0 + r) * kD + c * 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 4, c = idx & 15;
    cp_async16(stage + kGA + (c >> 3) * 8192 + swz(r, c & 7), b + (k0 + r) * f + n0 + c * 8);
  }
}

// One m64n128 accumulator to its partial tile: [256, f] rows m (dW2), or
// transposed into [f, 256] (dW1).
__device__ __forceinline__ void store_tile(const float (&d)[64], float* out, int m_base,
                                           int col_base, int f, bool transposed) {
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int col = col_base + 8 * jj;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m_base + 8 * hr;
      const float v0 = d[4 * jj + 2 * hr], v1 = d[4 * jj + 2 * hr + 1];
      if (transposed) {
        out[static_cast<long long>(col) * kD + m] = v0;
        out[static_cast<long long>(col + 1) * kD + m] = v1;
      } else {
        *reinterpret_cast<float2*>(out + static_cast<long long>(m) * f + col) =
            make_float2(v0, v1);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
dw_gemm_kernel(const __nv_bfloat16* __restrict__ xb, const __nv_bfloat16* __restrict__ h1,
               const __nv_bfloat16* __restrict__ dh1, const __nv_bfloat16* __restrict__ du2c,
               float* __restrict__ part_dw1, float* __restrict__ part_dw2, int n_pad, int f) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sbase = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int q = lane & 3;
  const int tiles = f / 128;
  const bool dw1 = blockIdx.x >= tiles;  // product 1: dW1^T = xb^T dh1
  const int n0 = (blockIdx.x % tiles) * 128;
  const __nv_bfloat16* a = dw1 ? xb : du2c;
  const __nv_bfloat16* b = dw1 ? dh1 : h1;
  const int nk = n_pad / 64, splits = gridDim.y, s = blockIdx.y;
  const int kt0 = static_cast<int>(static_cast<long long>(nk) * s / splits);
  const int kt1 = static_cast<int>(static_cast<long long>(nk) * (s + 1) / splits);
  const int count = kt1 - kt0;

  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;

#pragma unroll
  for (int i = 0; i < kGStages - 1; ++i) {
    if (i < count)
      gemm_load(sbase + i * kGStage, a, b, static_cast<long long>(kt0 + i) * 64, n0, f, tid);
    cp_async_commit();
  }
  for (int i = 0; i < count; ++i) {
    cp_async_wait<kGStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage i landed for every thread; stage i - 1 is free
    if (i + kGStages - 1 < count)
      gemm_load(sbase + ((i + kGStages - 1) % kGStages) * kGStage, a, b,
                static_cast<long long>(kt0 + i + kGStages - 1) * 64, n0, f, tid);
    cp_async_commit();
    const uint32_t st = sbase + (i % kGStages) * kGStage;
    reg_fence(acc0);
    reg_fence(acc1);
    wgmma_fence();
    const uint32_t b_lo = desc_lo(st + kGA, 8192);  // [64 rows][128 n]: 2 blocks
    mma_k<0, 4, 1, 1, 0, 0>(acc0, desc_lo(st + (2 * wg) * 8192, 8192), b_lo);
    mma_k<0, 4, 1, 1, 0, 0>(acc1, desc_lo(st + (2 * wg + 1) * 8192, 8192), b_lo);
    wgmma_commit();
    wgmma_wait0();
    reg_fence(acc0);
    reg_fence(acc1);
  }
  cp_async_wait<0>();

  float* out = (dw1 ? part_dw1 : part_dw2) + static_cast<long long>(s) * kD * f;
  const int m_base = 128 * wg + 16 * (warp & 3) + (lane >> 2);
  store_tile(acc0, out, m_base, n0 + 2 * q, f, dw1);
  store_tile(acc1, out, m_base + 64, n0 + 2 * q, f, dw1);
}

// out[col] = sum_r part[r, col], rows in order: 8 row-strided partial sums a
// column, then those 8 in order. Deterministic.
__global__ void colsum_kernel(const float* __restrict__ part, float* __restrict__ out,
                              int rows, long long cols) {
  __shared__ float acc[8][32];
  const long long col = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.f;
  if (col < cols)
    for (int r = threadIdx.y; r < rows; r += 8) s += part[static_cast<long long>(r) * cols + col];
  acc[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += acc[y][threadIdx.x];
    out[col] = t;
  }
}

int colsum(const float* part, float* out, int rows, long long cols, cudaStream_t s) {
  colsum_kernel<<<static_cast<unsigned>((cols + 31) / 32), dim3(32, 8), 0, s>>>(part, out, rows,
                                                                               cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers; d must be 256, f a multiple of 128 and at
// most 2048. Scratch (rows padded to n_pad = 128 * ceil(n / 128)): xb, du2c
// [n_pad, 256] and h1, dh1 [n_pad, f] bf16; part_vec [n_pad / 128, 5*256] and
// part_db1 [n_pad / 128, f] f32 (a row per block); part_dw [2, splits, 256 * f]
// f32 with splits = encoder_tail_bwd_splits(n). Outputs dw1 [f, 256], dw2
// [256, f], vec = ds1, dsb1, ds2, dsb2, db2 ([5, 256]) and db1 [f], f32.
// Returns the first CUDA error of the launches, or 0.
extern "C" int encoder_tail_bwd_splits(int n) {
  const int nk = (n + kBM - 1) / kBM * (kBM / 64);
  return nk < kMaxSplits ? (nk < 1 ? 1 : nk) : kMaxSplits;
}

extern "C" int encoder_tail_bwd(const void* src, const void* attn, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* s1, const void* sb1, const void* s2,
                                const void* sb2, const void* dy, void* du1,
                                void* xb, void* h1, void* dh1, void* du2c,
                                void* part_vec, void* part_db1, void* part_dw, void* dw1,
                                void* dw2, void* vec, void* db1, int n, int d, int f,
                                float eps, void* stream) {
  if (d != kD || f <= 0 || f % 128 != 0 || f / kFC > kMaxChunks || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      row_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGemmSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = (n + kBM - 1) / kBM;
  const int n_pad = n_blk * kBM;
  row_pass_kernel<<<n_blk, kThreads, kRowSmem, s>>>(
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
  const int splits = encoder_tail_bwd_splits(n);
  float* pdw = static_cast<float*>(part_dw);
  const long long wsize = static_cast<long long>(kD) * f;
  dw_gemm_kernel<<<dim3(2 * (f / 128), splits), kThreads, kGemmSmem, s>>>(
      static_cast<const __nv_bfloat16*>(xb), static_cast<const __nv_bfloat16*>(h1),
      static_cast<const __nv_bfloat16*>(dh1), static_cast<const __nv_bfloat16*>(du2c),
      pdw, pdw + splits * wsize, n_pad, f);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  int e;
  if ((e = colsum(pdw, static_cast<float*>(dw1), splits, wsize, s)) != 0) return e;
  if ((e = colsum(pdw + splits * wsize, static_cast<float*>(dw2), splits, wsize, s)) != 0)
    return e;
  if ((e = colsum(static_cast<const float*>(part_vec), static_cast<float*>(vec), n_blk,
                  kNVec * kD, s)) != 0)
    return e;
  return colsum(static_cast<const float*>(part_db1), static_cast<float*>(db1), n_blk, f, s);
}
