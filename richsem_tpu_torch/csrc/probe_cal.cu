// Calibration probes of the card: CUDA-core rate, the tensor-core rate at the
// decoder's narrow shapes, a one-block-per-cell grid, and a tiled accumulate.
//
// Replaces the four Pallas probes of tools/bench_pallas_cal.py (each computes
// the function of the TPU kernel, not its block layout):
//
//   probe_vpu   <- run_vpu :52 (vpu_kernel :41)
//                  acc = 0; for i < reps: acc += max(0, 1 - |x - (y + i)|) * y
//                  in the input dtype, every op rounded (the f32 form uses
//                  __fmul_rn/__fadd_rn so nvcc contracts nothing into an FMA,
//                  one thread an element; the bf16 form works on packed bf16
//                  pairs, each operation rounded once to bf16, i rounded as
//                  JAX's i.astype(bf16): vpu_bf16_kernel below). Bound: 6 ops
//                  an element-rep on the CUDA cores, at the issue rate.
//   probe_mxu   <- run_mxu :67
//                  acc_f32 = 0; for i < reps: acc += bf16(a + bf16(i)) @ b
//                  a [k, s], b [s, d] bf16, f32 out [k, d]. The reps are
//                  independent products that are only summed, so they are
//                  split across blocks (split-K over the reps): a grid of
//                  64-row tiles x N-column tiles x R, R as many as fill the
//                  card in one wave, and the two warpgroups of a block take
//                  one rep range each. Each block walks s in 64-wide chunks,
//                  stages each chunk of a and b once and reuses it for all
//                  its reps; per rep the packed add forms bf16(a + bf16(i))
//                  as wgmma's register A operand (A never goes back to shared
//                  memory). The 2 R partials are summed in a fixed order by a
//                  second small kernel. Bound: the bf16 tensor-core rate
//                  (mxu_kernel below).
//   probe_grid  <- run_grid_overhead :92
//                  out = 2 x, one block of 256 threads (4 floats each) per
//                  [8, 128] cell. Bound: bytes (each block streams 8 KB, so
//                  the time a block is memory time, not a scheduling cost).
//   probe_repeat <- run_repeat :108
//                  acc = 0; for i < reps: acc += tile(x + i, wx, axis 1)
//                  x [rows, wy] -> [rows, wy * wx], out[r, c] sums x[r, c % wy]
//                  (pltpu.repeat tiles), each output its own chain of rounded
//                  adds. A thread V consecutive outputs of one source group
//                  (repeat_body below: 4 f32, 8 bf16 as packed pairs).
//
// Plain C interface; each function returns cudaGetLastError() after its launch.
// Needs sm_90a (wgmma).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper_wgmma.cuh"

namespace {

using namespace hopper;

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

// Packed bf16 pairs, each operation rounded once to nearest-even (the .rn
// forms: plain __hadd2/__hmul2 would let the code generator fuse a multiply
// and an add into one FMA). The same bits as the plain version's bf16
// operation, which is the f32 operation rounded to bf16: exact for a product
// of two bf16 values, and for a sum a single rounding to 24 bits, which then
// rounds to bf16 as the direct operation would (24 >= 2 * 8 + 2).
__device__ __forceinline__ uint32_t bf2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
// max(0, 1 - |d|): the sign bits cleared, then relu(|d| * -1 + 1), whose
// product is exact, so 1 - |d| is rounded once; relu gives +0 where it is
// negative, as max(0, .) does (1 - |d| is never -0).
__device__ __forceinline__ uint32_t bf2_hat(uint32_t d) {
  uint32_t h;
  asm("{\n.reg .b32 t;\nand.b32 t, %1, 0x7FFF7FFF;\nfma.rn.relu.bf16x2 %0, t, %2, %3;\n}\n"
      : "=r"(h)
      : "r"(d), "r"(0xBF80BF80u), "r"(0x3F803F80u));
  return h;
}

// A thread takes 16 consecutive elements as 8 bf16 pairs (two 16-byte loads
// an operand; the last thread of a ragged n loads and stores element by
// element, its missing elements zeros). Each pass forms bf16(i) once (one
// packed convert, both halves) and runs the 6 packed operations on the 8
// independent pairs: 5 on the FMA pipe and the sign mask, 3 instructions an
// element against the bound's 6 operations at 2 a packed instruction.
constexpr int kVpuPairs = 8;
constexpr int kVpuThreads = 128;

__global__ void __launch_bounds__(kVpuThreads)
vpu_bf16_kernel(const unsigned short* __restrict__ x, const unsigned short* __restrict__ y,
                unsigned short* __restrict__ out, long long n, int reps) {
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * (2 * kVpuPairs);
  if (base >= n) return;
  const bool whole = base + 2 * kVpuPairs <= n;
  uint32_t xv[kVpuPairs], yv[kVpuPairs], acc[kVpuPairs];
  if (whole) {
    const uint4* x4 = reinterpret_cast<const uint4*>(x + base);
    const uint4* y4 = reinterpret_cast<const uint4*>(y + base);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 a = __ldg(x4 + h), b = __ldg(y4 + h);
      xv[4 * h] = a.x, xv[4 * h + 1] = a.y, xv[4 * h + 2] = a.z, xv[4 * h + 3] = a.w;
      yv[4 * h] = b.x, yv[4 * h + 1] = b.y, yv[4 * h + 2] = b.z, yv[4 * h + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kVpuPairs; ++q) {
      const long long e = base + 2 * q;
      xv[q] = (e < n ? x[e] : 0u) | ((e + 1 < n ? x[e + 1] : 0u) << 16);
      yv[q] = (e < n ? y[e] : 0u) | ((e + 1 < n ? y[e + 1] : 0u) << 16);
    }
  }
#pragma unroll
  for (int q = 0; q < kVpuPairs; ++q) acc[q] = 0u;
#pragma unroll 4
  for (int i = 0; i < reps; ++i) {
    const float fi = static_cast<float>(i);
    const __nv_bfloat162 step = __floats2bfloat162_rn(fi, fi);  // bf16(i), both halves
    const uint32_t ii = *reinterpret_cast<const uint32_t*>(&step);
#pragma unroll
    for (int q = 0; q < kVpuPairs; ++q)
      acc[q] = bf2_add(acc[q], bf2_mul(bf2_hat(bf2_sub(xv[q], bf2_add(yv[q], ii))), yv[q]));
  }
  if (whole) {
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
    o4[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    o4[1] = make_uint4(acc[4], acc[5], acc[6], acc[7]);
  } else {
#pragma unroll
    for (int q = 0; q < kVpuPairs; ++q) {
      const long long e = base + 2 * q;
      if (e < n) out[e] = static_cast<unsigned short>(acc[q] & 0xFFFFu);
      if (e + 1 < n) out[e + 1] = static_cast<unsigned short>(acc[q] >> 16);
    }
  }
}

// ---- probe_mxu: the tensor-core rate --------------------------------------
// Grid (row tiles of 64) x (column tiles of N) x (R rep ranges), two
// warpgroups a block: warpgroup g of block z takes the reps of range 2 z + g
// of 2 R ([j reps / 2R, (j + 1) reps / 2R) for range j). For each 64-wide
// chunk of s, in order, the block stages its 64 rows of a and the chunk's
// rows of b by cp.async two chunks ahead (rows of a past k and s past s are
// zeros), transposes the b chunk into a K-major 128-byte-swizzled tile for
// wgmma, and each warpgroup loads its A fragments once. Then each warpgroup
// takes its reps in groups of G (2 at N = 128, 4 at N = 32; as many groups
// as the longer of the block's two ranges needs, a rep past its range adding
// zeros): it forms bf16(a + bf16(i)) for each with packed adds
// (add.rn.bf16x2: the exact sum rounded once, as the f32 add then the bf16
// rounding of the plain version, since 24 >= 2 * 8 + 2) into the register A
// operands, issues the group's 4 G m64nNk16 products as one wgmma group and
// waits for them. No A register is written while a product runs, and every
// loop runs the same count in both warpgroups (ptxas would serialise the
// products otherwise); the other warpgroup's products keep the tensor cores
// busy meanwhile. Every kFlush reps the accumulators are added into an f32
// carry with __fadd_rn and cleared, so no chain of tensor-core sums grows
// long. Each warpgroup writes its carry as the f32 partial [2 z + g, k, d];
// mxu_reduce_kernel sums the 2 R partials in a fixed order. No atomics: two
// calls give the same bits.
namespace mxu {

constexpr int kThreads = 256;           // two warpgroups
constexpr int kRows = 64;               // rows of a block's tile: one m64 product
constexpr int kChunk = 64;              // s a stage: four k-steps of 16
constexpr int kARow = kChunk * 2 + 16;  // bytes a staged row of a (padded)
constexpr int kFlush = 32;              // reps between flushes into the carry

// Reps a warpgroup forms and multiplies between two waits: registers hold
// G x 16 words of A beside the N / 2 accumulators and their carry.
__host__ __device__ constexpr int group_reps(int n) { return n == 128 ? 2 : 4; }

template <int N>
struct Layout {
  static constexpr int kBRow = N * 2 + 16;  // bytes a staged row of b (padded)
  static constexpr int kBk = N * 128;       // K-major B tile: N rows of 64 s
  static constexpr int kA = kRows * kARow;
  static constexpr int kB = kChunk * kBRow;
  static constexpr int kAOff = kBk;         // the K-major tile first (1024-aligned)
  static constexpr int kBOff = kAOff + 2 * kA;
  static constexpr int kBytes = kBOff + 2 * kB + 1024;  // + alignment slack
};

// Chunk c0 .. c0 + 63 of s into stage buf: 64 rows of a, 64 rows of b's N
// columns at col0; zeros past k and past s.
template <int N>
__device__ __forceinline__ void stage(unsigned char* sm, uint32_t sa, int buf,
                                      const __nv_bfloat16* __restrict__ a,
                                      const __nv_bfloat16* __restrict__ b, int k, int s, int d,
                                      int row0, int col0, int c0, int tid) {
  using L = Layout<N>;
#pragma unroll
  for (int i = 0; i < kRows * 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx >> 3, p = idx & 7;
    const int off = L::kAOff + buf * L::kA + r * kARow + p * 16;
    if (row0 + r < k && c0 + p * 8 < s)
      cp_async16(sa + off, a + static_cast<long long>(row0 + r) * s + c0 + p * 8);
    else
      *reinterpret_cast<uint4*>(sm + off) = make_uint4(0, 0, 0, 0);
  }
  constexpr int kPieces = N / 8;
#pragma unroll
  for (int i = 0; i < kChunk * kPieces / kThreads; ++i) {
    const int idx = tid + i * kThreads, r = idx / kPieces, p = idx % kPieces;
    const int off = L::kBOff + buf * L::kB + r * L::kBRow + p * 16;
    if (c0 + r < s)
      cp_async16(sa + off, b + static_cast<long long>(c0 + r) * d + col0 + p * 8);
    else
      *reinterpret_cast<uint4*>(sm + off) = make_uint4(0, 0, 0, 0);
  }
}

// The staged b chunk [64 s][N] into the K-major tile [N][64 s]: lane l packs
// s = 2l and 2l + 1 of a column into one 32-bit store; warp w takes columns
// 8 g .. 8 g + 7 for g = w, w + 8, ...
template <int N>
__device__ __forceinline__ void transpose_b(unsigned char* sm, int buf, int warp, int lane) {
  using L = Layout<N>;
  const unsigned char* src = sm + L::kBOff + buf * L::kB + 2 * lane * L::kBRow;
  const int kk = 2 * lane;
  for (int g = warp; g < N / 8; g += kThreads / 32) {
    const uint4 lo = *reinterpret_cast<const uint4*>(src + g * 16);
    const uint4 hi = *reinterpret_cast<const uint4*>(src + L::kBRow + g * 16);
    const uint32_t lw[4] = {lo.x, lo.y, lo.z, lo.w}, hw[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      *reinterpret_cast<uint32_t*>(sm + swz(8 * g + e, kk >> 3) + (kk & 7) * 2) =
          __byte_perm(lw[e >> 1], hw[e >> 1], (e & 1) ? 0x7632 : 0x5410);
  }
}

// x = bf16(a + bf16(i)), two bf16 at a time; zeros for a rep past the range
// (its products add exact zeros).
__device__ __forceinline__ void add_rep(uint32_t (&x)[16], const uint32_t (&afr)[16], int i,
                                        bool live) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(static_cast<float>(i)));
  const uint32_t ii = h | (h << 16);
#pragma unroll
  for (int j = 0; j < 16; ++j) {  // volatile: kept after the wait for the last products
    uint32_t v;
    asm volatile("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(v) : "r"(afr[j]), "r"(ii));
    x[j] = live ? v : 0u;
  }
}

// acc += A B over the chunk's four k-steps, A [64 x 64] in registers, B the
// K-major tile (a k-step 32 bytes along its rows).
template <int N>
__device__ __forceinline__ void products(float (&acc)[N / 2], const uint32_t (&x)[16],
                                         uint32_t b_lo) {
  if constexpr (N == 32) {
    wgmma_n32_rs<0, 0>(acc, x[0], x[1], x[2], x[3], b_lo);
    wgmma_n32_rs<0, 2>(acc, x[4], x[5], x[6], x[7], b_lo);
    wgmma_n32_rs<0, 4>(acc, x[8], x[9], x[10], x[11], b_lo);
    wgmma_n32_rs<0, 6>(acc, x[12], x[13], x[14], x[15], b_lo);
  } else {
    wgmma_n128_rs<0, 0>(acc, x[0], x[1], x[2], x[3], b_lo);
    wgmma_n128_rs<0, 2>(acc, x[4], x[5], x[6], x[7], b_lo);
    wgmma_n128_rs<0, 4>(acc, x[8], x[9], x[10], x[11], b_lo);
    wgmma_n128_rs<0, 6>(acc, x[12], x[13], x[14], x[15], b_lo);
  }
}

// The first rep of range j of `ranges`.
__device__ __forceinline__ int rep_start(int reps, int j, int ranges) {
  return static_cast<int>(static_cast<long long>(reps) * j / ranges);
}

template <int N>
__device__ __forceinline__ void flush(float (&acc)[N / 2], float (&carry)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    carry[j] = __fadd_rn(carry[j], acc[j]);
    acc[j] = 0.f;
  }
}

}  // namespace mxu

// a [k, s] and b [s, d] bf16 row-major; part [2 R, k, d] f32 with R =
// gridDim.z. s a multiple of 16, d of N.
template <int N>
__global__ void __launch_bounds__(mxu::kThreads, 1)
mxu_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
           float* __restrict__ part, int k, int s, int d, int reps) {
  using namespace mxu;
  using L = Layout<N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sa = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (sa - smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 3;
  const int row0 = blockIdx.x * kRows, col0 = blockIdx.y * N;
  const int ranges = 2 * gridDim.z, range = 2 * blockIdx.z + (tid >> 7);
  const int i0 = rep_start(reps, range, ranges), i1 = rep_start(reps, range + 1, ranges);
  // every loop below runs the same count in both warpgroups (ptxas serialises
  // products on a path it takes for divergent): the longer range's groups
  const int z0 = rep_start(reps, 2 * blockIdx.z, ranges);
  const int z1 = rep_start(reps, 2 * blockIdx.z + 1, ranges);
  const int z2 = rep_start(reps, 2 * blockIdx.z + 2, ranges);
  const int groups = (max(z1 - z0, z2 - z1) + group_reps(N) - 1) / group_reps(N);
  const int chunks = (s + kChunk - 1) / kChunk;
  const int fr = 16 * (warp & 3) + (lane >> 2);  // fragment rows fr, fr + 8
  const uint32_t b_lo = desc_lo(sa, 16);

  float acc[N / 2], carry[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = carry[j] = 0.f;
  constexpr int G = group_reps(N);
  uint32_t afr[16], x[G][16];

  stage<N>(sm, sa, 0, a, b, k, s, d, row0, col0, 0, tid);
  cp_async_commit();
  if (chunks > 1) stage<N>(sm, sa, 1, a, b, k, s, d, row0, col0, kChunk, tid);
  cp_async_commit();
  int since = 0;
  for (int c = 0; c < chunks; ++c) {
    const int buf = c & 1;
    cp_async_wait<1>();  // chunk c staged (chunk c + 1 may still be in flight)
    __syncthreads();     // ... for every thread; no product reads the K-major tile
    transpose_b<N>(sm, buf, warp, lane);
    // the A fragment of each k-step j (PTX ISA, "Register Fragments"): rows fr
    // and fr + 8, columns 16 j + 2 q (+1) and 16 j + 8 + 2 q (+1)
    const unsigned char* arow = sm + L::kAOff + buf * L::kA + fr * kARow + 4 * q;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      afr[4 * j] = *reinterpret_cast<const uint32_t*>(arow + 32 * j);
      afr[4 * j + 1] = *reinterpret_cast<const uint32_t*>(arow + 8 * kARow + 32 * j);
      afr[4 * j + 2] = *reinterpret_cast<const uint32_t*>(arow + 32 * j + 16);
      afr[4 * j + 3] = *reinterpret_cast<const uint32_t*>(arow + 8 * kARow + 32 * j + 16);
    }
    fence_proxy_async();  // the K-major tile, visible to wgmma
    __syncthreads();      // ... to every warp; stage buf is free again
    if (c + 2 < chunks) stage<N>(sm, sa, buf, a, b, k, s, d, row0, col0, (c + 2) * kChunk, tid);
    cp_async_commit();
    for (int t = 0; t < groups; ++t) {
#pragma unroll
      for (int g = 0; g < G; ++g) add_rep(x[g], afr, i0 + G * t + g, i0 + G * t + g < i1);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int g = 0; g < G; ++g) products<N>(acc, x[g], b_lo);
      wgmma_commit();
      wgmma_wait0();
      reg_fence(acc);
      since += G;
      if (since >= kFlush) {
        flush<N>(acc, carry);
        since = 0;
      }
    }
  }
  flush<N>(acc, carry);

  // the accumulator fragment: rows fr, fr + 8; columns 8 j + 2 q (+1)
  const int r = row0 + fr;
  float* out = part + static_cast<long long>(range) * k * d + col0 + 2 * q;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    if (r < k)
      *reinterpret_cast<float2*>(out + static_cast<long long>(r) * d + 8 * j) =
          make_float2(carry[4 * j], carry[4 * j + 1]);
    if (r + 8 < k)
      *reinterpret_cast<float2*>(out + static_cast<long long>(r + 8) * d + 8 * j) =
          make_float2(carry[4 * j + 2], carry[4 * j + 3]);
  }
}

// out[e] = sum over j of part[j, e] in a fixed order: thread y of 8 sums
// j = y, y + 8, ... in order, then the 8 sums are added in order.
__global__ void mxu_reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int n,
                                  int ranges) {
  __shared__ float sums[8][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < n)
    for (int j = threadIdx.y; j < ranges; j += 8)
      acc = __fadd_rn(acc, part[static_cast<long long>(j) * n + e]);
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < n) {
    float total = sums[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 8; ++y) total = __fadd_rn(total, sums[y][threadIdx.x]);
    out[e] = total;
  }
}

template <int N>
int launch_mxu(const __nv_bfloat16* a, const __nv_bfloat16* b, float* part, int k, int s, int d,
               int reps, int splits, cudaStream_t st) {
  const int smem = mxu::Layout<N>::kBytes;
  cudaError_t err =
      cudaFuncSetAttribute(mxu_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + mxu::kRows - 1) / mxu::kRows, d / N, splits);
  mxu_kernel<N><<<grid, mxu::kThreads, smem, st>>>(a, b, part, k, s, d, reps);
  return static_cast<int>(cudaGetLastError());
}

// x, out [n_cells, 8, 128] f32: one block a cell, 256 threads x 4 floats.
__global__ void __launch_bounds__(256)
grid_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const long long base = static_cast<long long>(blockIdx.x) * 1024 + threadIdx.x * 4;
  const float4 v = *reinterpret_cast<const float4*>(x + base);
  *reinterpret_cast<float4*>(out + base) =
      make_float4(2.f * v.x, 2.f * v.y, 2.f * v.z, 2.f * v.w);
}

// ---- probe_repeat: out[r, c] = sum over i < reps of (x[r, c mod wy] + i) ----
// Every output keeps its own chain, acc = acc + (x + i), each add rounded
// (f32 __fadd_rn; bf16 add.rn.bf16x2 on packed pairs, both adds, the bits of
// the plain version's bf16 adds). A thread takes V consecutive outputs of one
// wy-wide source group (4 f32, a float4; 8 bf16, four packed pairs, 16 B),
// so its V chains read V different sources and no two are one computation.
// Block (wy / V, by, bz): x the vector in the group, y the copy, z the row,
// so thread (g, k, z) of block (bx, by) writes row bx * bz + z, columns
// (by * blockDim.y + k) * wy + g * V ... + V - 1 (no division), a warp 32
// consecutive vectors. The pass values i (bf16(i), both halves, for bf16)
// are staged in shared memory, kSteps a chunk, read 4 at a time. Each output
// costs two adds a pass against the bound's one (x + i is counted once a
// source), so about half the bound's issue rate is the ceiling.
constexpr int kSteps = 256;

struct RepeatF32 {
  static constexpr int kV = 4;
  using Elem = float;
  using Step = float;
  using Vec = float4;
  struct Acc {
    float v[4];
  };
  __device__ static Step step(int i) { return static_cast<float>(i); }
  __device__ static Acc split(const Vec& x) { return {{x.x, x.y, x.z, x.w}}; }
  __device__ static Vec join(const Acc& a) { return make_float4(a.v[0], a.v[1], a.v[2], a.v[3]); }
  __device__ static void add(Acc& acc, const Acc& x, Step s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc.v[q] = __fadd_rn(acc.v[q], __fadd_rn(x.v[q], s));
  }
};

struct RepeatBf16 {
  static constexpr int kV = 8;
  using Elem = __nv_bfloat16;
  using Step = uint32_t;  // bf16(i) in both halves
  using Vec = uint4;
  struct Acc {
    uint32_t v[4];
  };
  __device__ static Step step(int i) {
    const float fi = static_cast<float>(i);
    const __nv_bfloat162 s = __floats2bfloat162_rn(fi, fi);
    return *reinterpret_cast<const uint32_t*>(&s);
  }
  __device__ static Acc split(const Vec& x) { return {{x.x, x.y, x.z, x.w}}; }
  __device__ static Vec join(const Acc& a) { return make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]); }
  __device__ static void add(Acc& acc, const Acc& x, Step s) {
#pragma unroll
    for (int q = 0; q < 4; ++q) acc.v[q] = bf2_add(acc.v[q], bf2_add(x.v[q], s));
  }
};

template <class R>
__device__ __forceinline__ void repeat_body(const typename R::Elem* __restrict__ x,
                                            typename R::Elem* __restrict__ out, int rows, int wy,
                                            int wx, int reps) {
  __shared__ __align__(16) typename R::Step steps[kSteps];
  const int tid = (threadIdx.z * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int threads = blockDim.x * blockDim.y * blockDim.z;
  const int r = blockIdx.x * blockDim.z + threadIdx.z;
  const int copy = blockIdx.y * blockDim.y + threadIdx.y;
  const int src = threadIdx.x * R::kV;  // column in the source group
  const bool live = r < rows && copy < wx;
  typename R::Acc xv = {}, acc = {};
  if (live)
    xv = R::split(*reinterpret_cast<const typename R::Vec*>(x + static_cast<long long>(r) * wy +
                                                             src));
  for (int i0 = 0; i0 < reps; i0 += kSteps) {
    const int n = min(kSteps, reps - i0);
    __syncthreads();  // the last chunk's reads are done
    for (int t = tid; t < n; t += threads) steps[t] = R::step(i0 + t);
    __syncthreads();
    if (!live) continue;
    int t = 0;
    for (; t + 4 <= n; t += 4) {
      typename R::Step s4[4];
      *reinterpret_cast<uint4*>(s4) = *reinterpret_cast<const uint4*>(steps + t);
#pragma unroll
      for (int u = 0; u < 4; ++u) R::add(acc, xv, s4[u]);
    }
    for (; t < n; ++t) R::add(acc, xv, steps[t]);
  }
  if (live)
    *reinterpret_cast<typename R::Vec*>(out + static_cast<long long>(r) * wy * wx +
                                        copy * wy + src) = R::join(acc);
}

// One kernel body (repeat_body), an entry a dtype: the profile names them.
__global__ void __launch_bounds__(512)
repeat_f32_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int wy, int wx,
                  int reps) {
  repeat_body<RepeatF32>(x, out, rows, wy, wx, reps);
}

__global__ void __launch_bounds__(512)
repeat_bf16_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                   int rows, int wy, int wx, int reps) {
  repeat_body<RepeatBf16>(x, out, rows, wy, wx, reps);
}

unsigned blocks_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace

extern "C" int probe_vpu(const void* x, const void* y, void* out, long long n, int reps,
                         int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)  // x, y, out 16-byte aligned
    vpu_bf16_kernel<<<blocks_for((n + 2 * kVpuPairs - 1) / (2 * kVpuPairs), kVpuThreads),
                      kVpuThreads, 0, st>>>(static_cast<const unsigned short*>(x),
                                            static_cast<const unsigned short*>(y),
                                            static_cast<unsigned short*>(out), n, reps);
  else
    vpu_f32_kernel<<<blocks_for(n, 256), 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), static_cast<float*>(out),
        n, reps);
  return static_cast<int>(cudaGetLastError());
}

// part: [2 splits, k, d] f32 scratch. N = 128 where it divides d, else 32.
extern "C" int probe_mxu(const void* a, const void* b, void* part, void* out, int k, int s, int d,
                         int reps, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* av = static_cast<const __nv_bfloat16*>(a);
  const auto* bv = static_cast<const __nv_bfloat16*>(b);
  float* pv = static_cast<float*>(part);
  const int err = d % 128 == 0 ? launch_mxu<128>(av, bv, pv, k, s, d, reps, splits, st)
                                : launch_mxu<32>(av, bv, pv, k, s, d, reps, splits, st);
  if (err != 0) return err;
  const int n = k * d;
  mxu_reduce_kernel<<<blocks_for(n, 32), dim3(32, 8), 0, st>>>(pv, static_cast<float*>(out), n,
                                                            2 * splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_grid(const void* x, void* out, int n_cells, void* stream) {
  grid_kernel<<<n_cells, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x [rows, wy] 16-byte aligned, wy a multiple of V (4 f32, 8 bf16); the block
// (wy / V, by, bz) from tools/bench_cal.py:repeat_block, the grid
// (ceil(rows / bz), ceil(wx / by)).
extern "C" int probe_repeat(const void* x, void* out, int rows, int wy, int wx, int reps,
                            int is_bf16, int by, int bz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = is_bf16 ? RepeatBf16::kV : RepeatF32::kV;
  const dim3 block(wy / v, by, bz), grid((rows + bz - 1) / bz, (wx + by - 1) / by);
  if (is_bf16)
    repeat_bf16_kernel<<<grid, block, 0, st>>>(static_cast<const __nv_bfloat16*>(x),
                                               static_cast<__nv_bfloat16*>(out), rows, wy, wx,
                                               reps);
  else
    repeat_f32_kernel<<<grid, block, 0, st>>>(static_cast<const float*>(x),
                                              static_cast<float*>(out), rows, wy, wx, reps);
  return static_cast<int>(cudaGetLastError());
}
