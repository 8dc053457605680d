// The per-cell cost probe of the windowed deformable-attention design, and the
// column tiling that pltpu.repeat does.
//
// Replaces the Pallas probes of tools/bench_cell.py:
//
//   probe_cell <- run_cell :93 (cell_kernel :46), modes "2d" and "flat" (two
//                 Mosaic layouts of one function; one kernel serves both).
//                 For each of `reps` passes, it = the pass index as f32:
//                   for each level v with window (wy, wx):
//                     hy[mk, p, gy] = max(0, a - a * |y + it - gy|)     f32
//                     hx[mk, p, gx] = max(0, 1 - |x - gx|)              f32
//                     basis[mk, gy, gx] = bf16(sum_p hy * hx)           p in order
//                     acc[m, k, :] += basis[m, k] . win_v[m, :]         f32 accumulate
//                   carry += acc
//                 y, x, a [M*K, L*P] f32; win_v [M, D, wy, wx] bf16; out [M, K, D] f32.
//                 One block (four warps) per (m, 16 rows of K). The block stages
//                 its m's windows once, column-major, zero-padded to a multiple
//                 of 16 taps; per pass and level it builds the hats in shared
//                 memory with _rn arithmetic (no FMA contraction, as the JAX
//                 kernel writes them), then the bf16 basis tile, and two warps
//                 contract it with the window on tensor cores (WMMA, f32
//                 accumulate) into a fresh fragment that is added to the pass's
//                 sum, as the JAX kernel adds each level's dot. Bound: the f32
//                 hat and basis arithmetic on the CUDA cores.
//   probe_tile <- check_repeat_semantics :117: out[r, c] = x[r, c % w], the
//                 column tiling that pltpu.repeat does; a thread a source
//                 element, writing its `times` copies. Bound: bytes (at the
//                 probe's 8 x 8 input, the launch itself).
//
// Plain C interface; each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kLevels = 4;
constexpr int kP = 4;       // points per level
constexpr int kD = 32;      // channels (two 16-column tiles)
constexpr int kRows = 16;   // rows of K per block
constexpr int kMaxSide = 32;

struct Levels {
  const __nv_bfloat16* win[kLevels];
  int wy[kLevels], wx[kLevels];
  int pad[kLevels];  // wy * wx rounded up to 16
  int off[kLevels];  // element offset of the level's staged window
  int n_levels, max_pad;
};

__global__ void __launch_bounds__(128, 1)
cell_kernel(const float* __restrict__ yr, const float* __restrict__ xr,
            const float* __restrict__ aw, Levels lv, float* __restrict__ out, int K,
            int reps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m = blockIdx.y, k0 = blockIdx.x * kRows;
  const int lp = lv.n_levels * kP;
  const int lda = lv.max_pad + 8;
  // carve-up: staged windows | basis tile | hats y | hats x | output tile
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  int total_w = 0;
  for (int v = 0; v < lv.n_levels; ++v) total_w += kD * lv.pad[v];
  __nv_bfloat16* as = ws + total_w;
  float* hy = reinterpret_cast<float*>(as + kRows * lda);
  float* hx = hy + kRows * kP * kMaxSide;
  float* ot = hx + kRows * kP * kMaxSide;

  for (int v = 0; v < lv.n_levels; ++v) {
    const int n = lv.wy[v] * lv.wx[v], pad = lv.pad[v];
    const __nv_bfloat16* src = lv.win[v] + static_cast<long long>(m) * kD * n;
    for (int e = tid; e < kD * pad; e += blockDim.x) {
      const int dcol = e / pad, kk = e % pad;
      ws[lv.off[v] + e] = kk < n ? src[dcol * n + kk] : __float2bfloat16(0.f);
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> carry, pass, lvl;
  wmma::fill_fragment(carry, 0.f);
  const int wc = (warp & 1) * 16;
  for (int rep = 0; rep < reps; ++rep) {
    const float it = static_cast<float>(rep);
    wmma::fill_fragment(pass, 0.f);
    for (int v = 0; v < lv.n_levels; ++v) {
      const int wy = lv.wy[v], wx = lv.wx[v], n = wy * wx, pad = lv.pad[v];
      __syncthreads();  // the previous level is done with the hats and the basis
      for (int e = tid; e < kRows * kP * kMaxSide; e += blockDim.x) {
        const int r = e / (kP * kMaxSide), p = (e / kMaxSide) % kP, g = e % kMaxSide;
        const int k = k0 + r;
        float vy = 0.f, vx = 0.f;
        if (k < K) {
          const long long at = (static_cast<long long>(m) * K + k) * lp + v * kP + p;
          const float gf = static_cast<float>(g);
          const float a = aw[at];
          if (g < wy)
            vy = fmaxf(0.f, __fsub_rn(a, __fmul_rn(a, fabsf(__fsub_rn(__fadd_rn(yr[at], it),
                                                                       gf)))));
          if (g < wx) vx = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(xr[at], gf))));
        }
        hy[e] = vy;
        hx[e] = vx;
      }
      __syncthreads();
      for (int e = tid; e < kRows * pad; e += blockDim.x) {
        const int r = e / pad, kk = e % pad;
        float b = 0.f;
        if (kk < n) {
          const int gy = kk / wx, gx = kk % wx;
          const float* hyr = hy + r * kP * kMaxSide + gy;
          const float* hxr = hx + r * kP * kMaxSide + gx;
#pragma unroll
          for (int p = 0; p < kP; ++p)
            b = __fadd_rn(b, __fmul_rn(hyr[p * kMaxSide], hxr[p * kMaxSide]));
        }
        as[r * lda + kk] = __float2bfloat16(b);
      }
      __syncthreads();
      if (warp < 2) {
        wmma::fill_fragment(lvl, 0.f);
        const __nv_bfloat16* wv = ws + lv.off[v] + wc * pad;
        for (int kk = 0; kk < pad; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, as + kk, lda);
          wmma::load_matrix_sync(fb, wv + kk, pad);
          wmma::mma_sync(lvl, fa, fb, lvl);
        }
#pragma unroll
        for (int e = 0; e < pass.num_elements; ++e) pass.x[e] = __fadd_rn(pass.x[e], lvl.x[e]);
      }
    }
    if (warp < 2) {
#pragma unroll
      for (int e = 0; e < carry.num_elements; ++e) carry.x[e] = __fadd_rn(carry.x[e], pass.x[e]);
    }
  }
  if (warp < 2) wmma::store_matrix_sync(ot + wc, carry, kD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kRows * kD; e += blockDim.x) {
    const int k = k0 + e / kD;
    if (k < K) out[(static_cast<long long>(m) * K + k) * kD + e % kD] = ot[e];
  }
}

// One thread a source element x[r, c], which it writes to out[r, j w + c]
// for j < times: no division or modulo. Threads of a warp take 32 columns;
// the 8 rows of a block step over the rows by the grid's height.
__global__ void __launch_bounds__(256)
tile_kernel(const float* __restrict__ x, float* __restrict__ out, int rows, int w, int times) {
  const int c = blockIdx.x * 32 + threadIdx.x;
  if (c >= w) return;
  for (int r = blockIdx.y * 8 + threadIdx.y; r < rows; r += gridDim.y * 8) {
    const float v = x[static_cast<long long>(r) * w + c];
    float* o = out + static_cast<long long>(r) * w * times + c;
    for (int j = 0; j < times; ++j) o[static_cast<long long>(j) * w] = v;
  }
}

}  // namespace

// wy, wx: host arrays of n_levels (<= 4) window sides (<= 32 each); wins: the
// n_levels window pointers. M*K rows; D must be 32.
extern "C" int probe_cell(const void* yr, const void* xr, const void* aw, const void* const* wins,
                          const int* wy, const int* wx, int n_levels, void* out, int M, int K,
                          int reps, void* stream) {
  if (n_levels < 1 || n_levels > kLevels) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.n_levels = n_levels;
  int off = 0, max_pad = 16;
  for (int v = 0; v < n_levels; ++v) {
    if (wy[v] > kMaxSide || wx[v] > kMaxSide) return static_cast<int>(cudaErrorInvalidValue);
    lv.win[v] = static_cast<const __nv_bfloat16*>(wins[v]);
    lv.wy[v] = wy[v];
    lv.wx[v] = wx[v];
    lv.pad[v] = (wy[v] * wx[v] + 15) / 16 * 16;
    lv.off[v] = off;
    off += kD * lv.pad[v];
    max_pad = lv.pad[v] > max_pad ? lv.pad[v] : max_pad;
  }
  lv.max_pad = max_pad;
  const size_t smem = static_cast<size_t>(off) * 2 + static_cast<size_t>(kRows) * (max_pad + 8) * 2 +
                      2 * static_cast<size_t>(kRows) * kP * kMaxSide * 4 +
                      static_cast<size_t>(kRows) * kD * 4;
  cudaError_t err = cudaFuncSetAttribute(cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((K + kRows - 1) / kRows, M);
  cell_kernel<<<grid, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yr), static_cast<const float*>(xr),
      static_cast<const float*>(aw), lv, static_cast<float*>(out), K, reps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_tile(const void* x, void* out, int rows, int w, int times, void* stream) {
  const dim3 grid((w + 31) / 32, (rows + 7) / 8 < 65535 ? (rows + 7) / 8 : 65535);
  tile_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, w, times);
  return static_cast<int>(cudaGetLastError());
}
