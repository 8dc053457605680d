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
// What bounds it on the card: the two products, 4*N*256*F flops (105 GFLOP at
// the production N = 49,980, F = 2048: 0.106 ms at 989 TFLOP/s), and, in a
// plain composition, the [N, F] hidden, written and read back through device
// memory (205 MB in bf16 a call). The design keeps the hidden on chip and the
// tensor cores fed:
//
// - A block of three warpgroups owns 128 rows: one producer warpgroup and two
//   consumer warpgroups of 64 rows each (setmaxnreg: 56 registers for the
//   producer, whose 16 copies a step spilled at 40, and 224 for the consumers).
// - The producer streams the weights through a ring of four 32 KB slots, one
//   64-wide chunk a slot, W1 chunk j then W2 chunk j (cp.async into
//   128-byte-swizzled blocks, encoder_tail_common.cuh), up to three chunks
//   ahead of the math; full/empty mbarriers hand each slot over, so no step
//   stops the block. Both consumer warpgroups read every staged chunk.
// - The consumers compute x = LN1(src + attn) first (a warp a row, PyTorch's
//   order and roundings, ln1_row, as K2-bwd: the same bf16(x) and relu masks
//   as the plain version) into a bf16 A tile in shared memory, and keep each
//   row's mean and rstd.
// - Each chunk: h1c [64 x 64] = x W1c^T by wgmma m64n64k16 over K = 256 from
//   shared memory; the bias, the bf16 casts and the relu on the accumulator
//   registers; the result packed as bf16 into the register A fragment of
//   h2 [64 x 256] += h1c W2c^T, wgmma m64n256k16 (the accumulator fragment of
//   an m64n16 product is the register A fragment of a k-step, as FlashAttention
//   3 does for P), so the hidden never touches shared memory. The h2 product
//   of chunk j and the h1 product of chunk j + 1 are issued together, so the
//   tensor cores run both while the other warpgroup works on its epilogue (a
//   strict ping-pong order between the two warpgroups, enforced with named
//   barriers, measured slower on an H100: PERF.md).
// - The epilogue: x recomputed from a second read of src and attn with the
//   kept mean and rstd (the same code, so the same bits; ~102 MB of reads,
//   mostly from L2), h2 = bf16(bf16(acc) + b2), y = LN2(x + h2) on the
//   fragment (quad shuffles), written as f32.
//
// Shared memory (a block, bytes): bf16 x 2 x 32,768; ring 4 x 32,768; the
// barriers 64; mean1 and rstd1 1,024; s1, sb1, s2, sb2, b2 as f32 5,120; b1
// as bf16 up to 8,192 (F <= 4096); 1,024 of alignment slack: 212,032 of
// 232,448, so one block an SM. An f32 copy of x (128 KB) does not fit beside
// the ring, hence the recompute.
//
// What is left between this and the card's rate (not measured apart): the h1
// product's m64n64k16 steps read A and B from shared memory, 4 KB per 32
// cycles of tensor work, at the edge of shared memory's 128 bytes a cycle;
// every 128-row block streams all 2 MB of the weights from L2 (782 MB a call
// at N = 49,980), which a cluster of blocks sharing multicast loads would
// halve; and the LN1 prologue and LN2 epilogue of a block do not overlap the
// products of another.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "encoder_tail_common.cuh"
#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;
using namespace tail;  // kD = 256, kFC = 64, LN1, the chunk staging

constexpr int kBM = 128;          // rows a block: 64 a consumer warpgroup
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kConsumers = 256;
constexpr int kCWarps = kConsumers / 32;
constexpr int kSlots = 4;         // ring slots, one 32 KB weight chunk each
constexpr int kSlot = 32768;
constexpr int kAhead = 3;         // chunks the producer keeps in flight
constexpr int kMaxF = 4096;
constexpr int kPf = 2;            // LN2 pass: column pairs of the row streams loaded ahead
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");
static_assert(kAhead < kSlots, "the producer must release a slot before it waits on it");

// Shared-memory carve-up (byte offsets from a 1024-aligned base).
constexpr int kXaOff = 0;                                // bf16 x: 2 x [4 blocks of 64 x 64]
constexpr int kRingOff = kXaOff + 2 * 32768;             // kSlots weight chunks
constexpr int kBarOff = kRingOff + kSlots * kSlot;       // u64 full[kSlots], empty[kSlots]
constexpr int kStatOff = kBarOff + 2 * kSlots * 8;       // f32 mean1, rstd1 [kBM]
constexpr int kParOff = kStatOff + 2 * kBM * 4;          // f32 s1, sb1, s2, sb2, b2 [kD]
constexpr int kB1Off = kParOff + 5 * kD * 4;             // bf16 b1 [kMaxF]
constexpr int kSmem = kB1Off + kMaxF * 2 + 1024;         // + alignment slack
static_assert(kSmem <= 232448, "too much shared memory");

constexpr int kBarConsumers = 1;  // named barrier over both consumer warpgroups

template <bool kDump>
__global__ void __launch_bounds__(kThreads, 1)
encoder_tail_fwd_kernel(const float* __restrict__ src, const float* __restrict__ attn,
                        const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        const __nv_bfloat16* __restrict__ b2,
                        const float* __restrict__ s1, const float* __restrict__ sb1,
                        const float* __restrict__ s2, const float* __restrict__ sb2,
                        float* __restrict__ out, __nv_bfloat16* __restrict__ xb_out,
                        __nv_bfloat16* __restrict__ h1_out, int n, int f, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t sbase = smem_u32(smem);
  const uint32_t full0 = sbase + kBarOff, empty0 = full0 + kSlots * 8;
  const int tid = threadIdx.x;
  const int nc = f / kFC;
  const int n_steps = 2 * nc;  // W1 chunk j at step 2j, W2 chunk j at step 2j + 1
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full0 + 8 * s, 128);             // every producer thread, once a step
      mbar_init(empty0 + 8 * s, kConsumers);     // every consumer thread, once a step
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer: W1 chunk j, W2 chunk j, ... into the ring, kAhead in flight
    regs_dec<kProducerRegs>();
    for (int t = 0; t < n_steps + kAhead - 1; ++t) {
      if (t < n_steps) {
        const int s = t % kSlots;
        mbar_wait(empty0 + 8 * s, ((t / kSlots) & 1) ^ 1);
        const uint32_t slot = sbase + kRingOff + s * kSlot;
        if (t & 1)
          stage_w2_chunk<128>(slot, w2, f, (t >> 1) * kFC, tid);
        else
          stage_w1_chunk<128>(slot, w1, (t >> 1) * kFC, tid);
      }
      cp_async_commit();
      const int done = t - (kAhead - 1);  // the step whose copies have landed
      if (done >= 0) {
        cp_async_wait<kAhead - 1>();
        fence_proxy_async();  // this thread's cp.async writes, visible to wgmma
        mbar_arrive(full0 + 8 * (done % kSlots));
      }
    }
    return;
  }

  // ---- consumers ----------------------------------------------------------
  regs_inc<kConsumerRegs>();
  const int ctid = tid - 128;
  const int cwarp = ctid >> 5;
  const int lane = ctid & 31;
  const int wg = ctid >> 7;  // rows 64 wg .. 64 wg + 63 of the block
  float* mean1 = reinterpret_cast<float*>(smem + kStatOff);
  float* rstd1 = mean1 + kBM;
  float* par = reinterpret_cast<float*>(smem + kParOff);  // s1, sb1, s2, sb2, b2
  const volatile float* vpar = par;
  __nv_bfloat16* b1s = reinterpret_cast<__nv_bfloat16*>(smem + kB1Off);
  par[ctid] = s1[ctid];
  par[kD + ctid] = sb1[ctid];
  par[2 * kD + ctid] = s2[ctid];
  par[3 * kD + ctid] = sb2[ctid];
  par[4 * kD + ctid] = __bfloat162float(b2[ctid]);
  for (int i = ctid; i < f; i += kConsumers) b1s[i] = b1[i];

  // x = LN1(src + attn): consumer warp w takes rows 16 w .. 16 w + 15, its own
  // warpgroup's A tile and fragment rows
  for (int i = 0; i < kBM / kCWarps; ++i) {
    const int r = cwarp * (kBM / kCWarps) + i;
    const long long g = row0 + r;
    float mean, rstd;
    uint2 pk[2];
    ln1_row(src, attn, g, n, lane, s1, sb1, eps, mean, rstd, pk);
    if (lane == 0) {
      mean1[r] = mean;
      rstd1[r] = rstd;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = 128 * h + 4 * lane;
      *reinterpret_cast<uint2*>(smem + kXaOff + (r >> 6) * 32768 + x_tile_offset(r & 63, c0)) =
          pk[h];
      if (kDump && g < n) *reinterpret_cast<uint2*>(xb_out + g * kD + c0) = pk[h];
    }
  }
  fence_proxy_async();  // the A tile, visible to wgmma
  named_sync(kBarConsumers, kConsumers);

  const uint32_t xa = sbase + kXaOff + wg * 32768;
  const int q = lane & 3;                              // column pairs 8 jj + 2 q
  const int fr0 = 64 * wg + 16 * (cwarp & 3) + (lane >> 2);  // fragment rows fr0, fr0 + 8
  const long long g0 = row0 + fr0, g1 = g0 + 8;

  float acc[128];  // h2 before its cast: the [64 x 256] fragment
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float a1[32];    // the hidden chunk's [64 x 64] fragment

  // h1 of chunk 0 (step 0)
  mbar_wait(full0, 0);
#pragma unroll
  for (int i = 0; i < 32; ++i) a1[i] = 0.f;
  reg_fence(a1);
  wgmma_fence();
  mma_k<0, 16, 0, 0, 64, 64>(a1, desc_lo(xa, 16), desc_lo(sbase + kRingOff, 16));
  wgmma_commit();
  wgmma_wait0();
  reg_fence(a1);
  mbar_arrive(empty0);

  for (int j = 0; j < nc; ++j) {
    const int f0 = j * kFC;
    // ---- the chunk's epilogue: bias, casts, relu -> bf16 register A fragment
    uint32_t pa[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int c = 8 * jj + 2 * q;
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(b1s + f0 + c);
      const float bl = __low2float(bb), bh = __high2float(bb);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = fmaxf(round_bf16(round_bf16(a1[4 * jj + e]) + ((e & 1) ? bh : bl)), 0.f);
      pa[2 * jj] = pack_bf16(v[0], v[1]);      // row fr0, columns c, c + 1
      pa[2 * jj + 1] = pack_bf16(v[2], v[3]);  // row fr0 + 8
      if (kDump) {
        if (g0 < n) *reinterpret_cast<uint32_t*>(h1_out + g0 * f + f0 + c) = pa[2 * jj];
        if (g1 < n) *reinterpret_cast<uint32_t*>(h1_out + g1 * f + f0 + c) = pa[2 * jj + 1];
      }
    }

    // ---- h2 += h1c W2c^T (step 2j + 1), then h1 of chunk j + 1 (step 2j + 2)
    const int t2 = 2 * j + 1, s2s = t2 % kSlots;
    mbar_wait(full0 + 8 * s2s, (t2 / kSlots) & 1);
    const uint32_t w2slot = sbase + kRingOff + s2s * kSlot;
    reg_fence(acc);
    wgmma_fence();
    // W2 chunk K-major: [256 d][64 f], k-step kk 32 bytes along the row
    wgmma_n256_rs<0, 0>(acc, pa[0], pa[1], pa[2], pa[3], desc_lo(w2slot, 16));
    wgmma_n256_rs<0, 2>(acc, pa[4], pa[5], pa[6], pa[7], desc_lo(w2slot, 16));
    wgmma_n256_rs<0, 4>(acc, pa[8], pa[9], pa[10], pa[11], desc_lo(w2slot, 16));
    wgmma_n256_rs<0, 6>(acc, pa[12], pa[13], pa[14], pa[15], desc_lo(w2slot, 16));
    wgmma_commit();
    const bool next = j + 1 < nc;
    const int t1 = 2 * j + 2, s1s = t1 % kSlots;
    if (next) {
      mbar_wait(full0 + 8 * s1s, (t1 / kSlots) & 1);
#pragma unroll
      for (int i = 0; i < 32; ++i) a1[i] = 0.f;
      reg_fence(a1);
      wgmma_fence();
      mma_k<0, 16, 0, 0, 64, 64>(a1, desc_lo(opaque(xa), 16),
                                 desc_lo(sbase + kRingOff + s1s * kSlot, 16));
      wgmma_commit();
    }
    wgmma_wait0();
    reg_fence(acc);
    reg_fence(a1);
    mbar_arrive(empty0 + 8 * s2s);
    if (next) mbar_arrive(empty0 + 8 * s1s);
  }

  // ---- y = LN2(x + bf16(bf16(acc) + b2)), x recomputed from src and attn ----
  float mu1[2], rs1[2], sum[2] = {0.f, 0.f}, sq[2] = {0.f, 0.f};
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mu1[hr] = mean1[fr0 + 8 * hr];
    rs1[hr] = rstd1[fr0 + 8 * hr];
  }
  {
    float2 ps[kPf][2], pv[kPf][2];
#pragma unroll
    for (int k = 0; k < kPf; ++k) {
      ps[k][0] = load2(src, g0, 8 * k + 2 * q, n), ps[k][1] = load2(src, g1, 8 * k + 2 * q, n);
      pv[k][0] = load2(attn, g0, 8 * k + 2 * q, n), pv[k][1] = load2(attn, g1, 8 * k + 2 * q, n);
    }
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int c = 8 * jj + 2 * q, k = jj % kPf;
      const float2 sv[2] = {ps[k][0], ps[k][1]}, av[2] = {pv[k][0], pv[k][1]};
      if (jj + kPf < 32) {
        ps[k][0] = load2(src, g0, c + 8 * kPf, n), ps[k][1] = load2(src, g1, c + 8 * kPf, n);
        pv[k][0] = load2(attn, g0, c + 8 * kPf, n), pv[k][1] = load2(attn, g1, c + 8 * kPf, n);
      }
      const float sc0 = vpar[c], sc1 = vpar[c + 1];
      const float bi0 = vpar[kD + c], bi1 = vpar[kD + c + 1];
      const float bb0 = vpar[4 * kD + c], bb1 = vpar[4 * kD + c + 1];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const float x0 = ln_out(sv[hr].x + av[hr].x, mu1[hr], rs1[hr], sc0, bi0);
        const float x1 = ln_out(sv[hr].y + av[hr].y, mu1[hr], rs1[hr], sc1, bi1);
        float& u0 = acc[4 * jj + 2 * hr];
        float& u1 = acc[4 * jj + 2 * hr + 1];
        u0 = x0 + round_bf16(round_bf16(u0) + bb0);  // u2 = x + h2
        u1 = x1 + round_bf16(round_bf16(u1) + bb1);
        sum[hr] += u0 + u1;
        sq[hr] += u0 * u0 + u1 * u1;
      }
    }
  }
  float mean[2], rstd[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mean[hr] = quad_sum(sum[hr]) / kD;
    rstd[hr] = rsqrtf(quad_sum(sq[hr]) / kD - mean[hr] * mean[hr] + eps);
  }
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    const int c = 8 * jj + 2 * q;
    const float sc0 = vpar[2 * kD + c], sc1 = vpar[2 * kD + c + 1];
    const float bi0 = vpar[3 * kD + c], bi1 = vpar[3 * kD + c + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long g = hr ? g1 : g0;
      if (g < n)
        *reinterpret_cast<float2*>(out + g * kD + c) =
            make_float2((acc[4 * jj + 2 * hr] - mean[hr]) * rstd[hr] * sc0 + bi0,
                        (acc[4 * jj + 2 * hr + 1] - mean[hr]) * rstd[hr] * sc1 + bi1);
    }
  }
}

template <bool kDump>
int launch(const void* src, const void* attn, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* s1, const void* sb1, const void* s2, const void* sb2,
           void* out, void* xb_out, void* h1_out, int n, int d, int f, float eps,
           void* stream) {
  if (d != kD || f <= 0 || f % kFC != 0 || f > kMaxF || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      encoder_tail_fwd_kernel<kDump>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kBM - 1) / kBM;
  encoder_tail_fwd_kernel<kDump><<<blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<const float*>(attn),
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(s1), static_cast<const float*>(sb1),
      static_cast<const float*>(s2), static_cast<const float*>(sb2),
      static_cast<float*>(out), static_cast<__nv_bfloat16*>(xb_out),
      static_cast<__nv_bfloat16*>(h1_out), n, f, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device pointers; d must be 256 and f a multiple of 64, at
// most 4096. Returns cudaGetLastError() after the launch (or the attribute
// call's error).
extern "C" int encoder_tail_fwd(const void* src, const void* attn, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                const void* s1, const void* sb1, const void* s2,
                                const void* sb2, void* out, int n, int d, int f,
                                float eps, void* stream) {
  return launch<false>(src, attn, w1, b1, w2, b2, s1, sb1, s2, sb2, out, nullptr, nullptr, n, d,
                       f, eps, stream);
}

// The same kernel, which also writes bf16(x) [n, 256] and the bf16 hidden h1
// [n, f] (after the relu): what chip_smoke.py compares with the plain
// version's bf16(x) and relu masks. Its y is the same, bit for bit.
extern "C" int encoder_tail_fwd_transients(const void* src, const void* attn, const void* w1,
                                           const void* b1, const void* w2, const void* b2,
                                           const void* s1, const void* sb1, const void* s2,
                                           const void* sb2, void* out, void* xb, void* h1,
                                           int n, int d, int f, float eps, void* stream) {
  return launch<true>(src, attn, w1, b1, w2, b2, s1, sb1, s2, sb2, out, xb, h1, n, d, f, eps,
                      stream);
}
