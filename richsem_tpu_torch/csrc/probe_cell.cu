// The per-cell cost probe of the windowed deformable-attention design, and the
// column tiling that pltpu.repeat does.
//
// Replaces the Pallas probes of tools/bench_cell.py:
//
//   probe_cell <- run_cell :93 (cell_kernel :48), modes "2d" and "flat" (two
//                 Mosaic layouts of one function; one kernel serves both).
//                 For each of `reps` passes, it = the pass index as f32:
//                   for each level v with window (wy, wx):
//                     hy[mk, p, gy] = max(0, a - a * |y + it - gy|)     f32
//                     hx[mk, p, gx] = max(0, 1 - |x - gx|)              f32
//                     basis[mk, gy, gx] = bf16(sum_p hy * hx)           p in order
//                     acc[m, k, :] += basis[m, k] . win_v[m, :]         f32 accumulate
//                   carry += acc
//                 y, x, a [M*K, L*P] f32; win_v [M, D, wy, wx] bf16; out [M, K, D] f32.
//                 Bound: the f32 hat and basis arithmetic on the CUDA cores, each
//                 operation rounded on its own (no FMA), at the issue rate; the
//                 contraction on the tensor cores is about a quarter of it.
//                 cell_kernel below says how it is split; cell_reduce_kernel
//                 sums the pass ranges' partials in a fixed order.
//   probe_tile <- check_repeat_semantics :117: out[r, c] = x[r, c % w], the
//                 column tiling that pltpu.repeat does; a thread a source
//                 element, writing its `times` copies. Bound: bytes (at the
//                 probe's 8 x 8 input, the launch itself).
//
// Plain C interface; each function returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kLevels = 4;
constexpr int kP = 4;          // points per level
constexpr int kD = 32;         // channels: four n8 product tiles
constexpr int kTile = 16;      // rows of K a warp: one m16 product tile
constexpr int kMaxWarps = 12;  // warps a block
constexpr int kMaxSide = 32;
// bytes of a row's hy in shared memory: [gy][p] f32, 16 bytes a gy, padded by
// one 16-byte slot so that eight rows at one gy fall on distinct banks
constexpr int kHyRow = kMaxSide * kP * 4 + 16;

struct Levels {
  const unsigned short* win[kLevels];  // bf16 bits
  int wy[kLevels], wx[kLevels];
  int n_levels;
  int kmax;  // the largest level's staged columns, 16 ceil(wy / 4) ceil(wx / 4)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The staged column of window tap (gy, gx) at a level with C = ceil(wx / 4)
// x-groups. Column chunk 16 (C (gy / 4) + gx / 4) holds the 4 x 4 taps of one
// y-group and one x-group, ordered so that the m16n8k16 A fragment of lane
// (g, t) (columns 2t, 2t + 1, 2t + 8, 2t + 9; PTX ISA, "Matrix Fragments for
// mma.m16n8k16") holds gy % 4 = 0, 1, 2, 3 at the one x tap gx % 4 = t.
__device__ __forceinline__ int tap_col(int gy, int gx, int c_groups) {
  return 16 * (c_groups * (gy >> 2) + (gx >> 2)) + 2 * (gx & 3) + (gy & 1) + 8 * ((gy >> 1) & 1);
}

// c += a b, m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

// The first pass of range j of `ranges`.
__device__ __forceinline__ int pass_start(int reps, int j, int ranges) {
  return static_cast<int>(static_cast<long long>(reps) * j / ranges);
}

// Level v's window of channel row m into the block's shared memory: channel d
// at byte d * wstride, tap (gy, gx) at column tap_col (zeros past wy and wx).
// Warp w takes the rows (d, gy pair) w, w + warps, ...; lane gx writes the
// pair's two taps as one 32-bit word (columns tap_col and tap_col + 1).
__device__ __forceinline__ void stage_window(unsigned char* ws, int wstride, const Levels& lv,
                                             int v, int m, int warp, int warps, int lane) {
  const int wy = lv.wy[v], wx = lv.wx[v], c_groups = (wx + 3) >> 2;
  const int pairs = 2 * ((wy + 3) >> 2);
  if (lane >= 4 * c_groups) return;
  const unsigned short* src = lv.win[v] + static_cast<long long>(m) * kD * wy * wx;
  for (int q = warp; q < kD * pairs; q += warps) {
    const int d = q / pairs, gy = 2 * (q - d * pairs);
    uint32_t lo = 0, hi = 0;
    if (lane < wx) {
      if (gy < wy) lo = src[(d * wy + gy) * wx + lane];
      if (gy + 1 < wy) hi = src[(d * wy + gy + 1) * wx + lane];
    }
    *reinterpret_cast<uint32_t*>(ws + d * wstride + 2 * tap_col(gy, lane, c_groups)) =
        lo | (hi << 16);
  }
}

// One level of one warp's 16 rows over its passes [i0, i1), C = ceil(wx / 4).
// Lane (g, t) = (lane / 4, lane % 4) owns rows g and g + 8 and the x taps
// gx = 4 c + t: their hx, computed once, stay in registers for every pass.
// Each pass the warp first writes hy [16 rows][4 ceil(wy / 4) gy][4 p] into
// its shared-memory slice (lane (r, h) = (lane % 16, lane / 16) the gy of
// parity h of row r); then, for each y-group, a lane reads the 4 gy x 4 p hy
// of its two rows (eight 16-byte loads, shared with the other lanes of its
// quad) and, for each x-group, forms its 2 rows x 4 gy basis values (4
// products summed in order, each operation rounded on its own), packs them
// into the A fragment and multiplies with the chunk's window (two ldmatrix,
// four m16n8k16 products into the f32 accumulators).
template <int C>
__device__ __forceinline__ void level(const float* __restrict__ yr, const float* __restrict__ xr,
                                      const float* __restrict__ aw, uint32_t b_lane, int wstride,
                                      unsigned char* hys, long long row0, int rows, int lp,
                                      int col, int wy, int wx, int i0, int i1, int lane,
                                      float (&acc)[4][4]) {
  const int g = lane >> 2, t = lane & 3, n_gy = 4 * ((wy + 3) >> 2);
  float hx[2][C][kP];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float4 x4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g + 8 * r < rows)
      x4 = __ldg(reinterpret_cast<const float4*>(xr + (row0 + g + 8 * r) * lp + col));
    const float xs[kP] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int gx = 4 * c + t;
      const float gf = static_cast<float>(gx);
#pragma unroll
      for (int p = 0; p < kP; ++p)
        hx[r][c][p] = gx < wx ? fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(xs[p], gf)))) : 0.f;
    }
  }
  // the hy writer: row pr, the gy of parity h; zeros past the row's K
  const int pr = lane & 15, h = lane >> 4;
  float4 y4 = make_float4(0.f, 0.f, 0.f, 0.f), a4 = y4;
  if (pr < rows) {
    y4 = __ldg(reinterpret_cast<const float4*>(yr + (row0 + pr) * lp + col));
    a4 = __ldg(reinterpret_cast<const float4*>(aw + (row0 + pr) * lp + col));
  }
  const float ys[kP] = {y4.x, y4.y, y4.z, y4.w}, as[kP] = {a4.x, a4.y, a4.z, a4.w};
  unsigned char* hy_w = hys + pr * kHyRow;
  const unsigned char* hy_r = hys + g * kHyRow;

  for (int i = i0; i < i1; ++i) {
    const float it = static_cast<float>(i);
    float yi[kP];
#pragma unroll
    for (int p = 0; p < kP; ++p) yi[p] = __fadd_rn(ys[p], it);
    __syncwarp();  // every lane has read the previous pass's hy
    float gf = static_cast<float>(h);
    for (int gy = h; gy < n_gy; gy += 2, gf += 2.f) {
      float o[kP];
#pragma unroll
      for (int p = 0; p < kP; ++p)
        o[p] = gy < wy ? fmaxf(0.f, __fsub_rn(as[p], __fmul_rn(as[p], fabsf(__fsub_rn(yi[p], gf)))))
                       : 0.f;
      *reinterpret_cast<float4*>(hy_w + gy * 16) = make_float4(o[0], o[1], o[2], o[3]);
    }
    __syncwarp();
    uint32_t b_addr = b_lane;
    for (int ig = 0; ig < n_gy; ig += 4) {
      float4 hv[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          hv[r][e] = *reinterpret_cast<const float4*>(hy_r + 8 * r * kHyRow + (ig + e) * 16);
#pragma unroll
      for (int c = 0; c < C; ++c, b_addr += 32) {
        float b[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float s = __fmul_rn(hv[r][e].x, hx[r][c][0]);
            s = __fadd_rn(s, __fmul_rn(hv[r][e].y, hx[r][c][1]));
            s = __fadd_rn(s, __fmul_rn(hv[r][e].z, hx[r][c][2]));
            b[r][e] = __fadd_rn(s, __fmul_rn(hv[r][e].w, hx[r][c][3]));
          }
        const uint32_t a0 = pack_bf16(b[0][0], b[0][1]), a1 = pack_bf16(b[1][0], b[1][1]);
        const uint32_t a2 = pack_bf16(b[0][2], b[0][3]), a3 = pack_bf16(b[1][2], b[1][3]);
        uint32_t w0, w1, w2, w3, w4, w5, w6, w7;
        ldsm_x4(b_addr, w0, w1, w2, w3);                // channels 0-15
        ldsm_x4(b_addr + 16 * wstride, w4, w5, w6, w7);  // channels 16-31
        mma_bf16(acc[0], a0, a1, a2, a3, w0, w1);
        mma_bf16(acc[1], a0, a1, a2, a3, w2, w3);
        mma_bf16(acc[2], a0, a1, a2, a3, w4, w5);
        mma_bf16(acc[3], a0, a1, a2, a3, w6, w7);
      }
    }
  }
}

// Grid (blocks along K) x M x R pass ranges; `warps` warps a block. Warp w of
// block (x, m, z) takes rows 16 (x warps + w) .. + 15 of channel row m
// (nothing if they start past K) over the passes of range z, [z reps / R,
// (z + 1) reps / R): the passes are independent sums, so they are split
// across blocks as run_mxu splits its reps. For each level in order the
// block stages the level's window of m once, in the permuted column order of
// tap_col (two block barriers a level); then each warp runs `level` alone
// (warp barriers only), all levels into one set of f32 accumulators. The
// warp writes them as the f32 partial [z, m K + k, D]; cell_reduce_kernel
// sums the R partials in order. No atomics: two calls give the same bits.
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
cell_kernel(const float* __restrict__ yr, const float* __restrict__ xr,
            const float* __restrict__ aw, Levels lv, float* __restrict__ part, int K, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const int m = blockIdx.y, range = blockIdx.z, ranges = gridDim.z;
  const int k0 = (blockIdx.x * warps + warp) * kTile, rows = min(kTile, K - k0);
  const int i0 = pass_start(reps, range, ranges), i1 = pass_start(reps, range + 1, ranges);
  const int lp = lv.n_levels * kP;
  const int wstride = (lv.kmax + 8) * 2;  // an odd number of 16-byte slots: no bank conflicts
  unsigned char* ws = smem;
  unsigned char* hys = smem + kD * wstride + warp * kTile * kHyRow;
  const long long row0 = static_cast<long long>(m) * K + k0;
  // this lane's ldmatrix row: matrix lane / 8 of the x4 (channels 0-7 or
  // 8-15, columns 0-7 or 8-15 of the chunk), its row lane % 8
  const uint32_t b_lane = static_cast<uint32_t>(__cvta_generic_to_shared(ws)) +
                          (((lane >> 4) << 3) + (lane & 7)) * wstride + ((lane >> 3) & 1) * 16;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int v = 0; v < lv.n_levels; ++v) {
    __syncthreads();  // every warp is done with the previous level's window
    stage_window(ws, wstride, lv, v, m, warp, warps, lane);
    __syncthreads();
    if (rows <= 0) continue;
    const int wy = lv.wy[v], wx = lv.wx[v], col = v * kP;
#define CELL_LEVEL(C)                                                                           \
  case C:                                                                                       \
    level<C>(yr, xr, aw, b_lane, wstride, hys, row0, rows, lp, col, wy, wx, i0, i1, lane, acc); \
    break;
    switch ((wx + 3) >> 2) {
      CELL_LEVEL(1) CELL_LEVEL(2) CELL_LEVEL(3) CELL_LEVEL(4)
      CELL_LEVEL(5) CELL_LEVEL(6) CELL_LEVEL(7) CELL_LEVEL(8)
    }
#undef CELL_LEVEL
  }
  if (rows <= 0) return;
  // the accumulator fragment: rows g and g + 8, columns 8 j + 2 t (+1)
  const int g = lane >> 2, t = lane & 3;
  float* out = part + (static_cast<long long>(range) * gridDim.y * K + row0) * kD + 2 * t;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (g < rows) *reinterpret_cast<float2*>(out + g * kD + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    if (g + 8 < rows)
      *reinterpret_cast<float2*>(out + (g + 8) * kD + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
}

// out[e] = sum over j of part[j, e], j = 0, 1, ... in order; four floats a thread.
__global__ void cell_reduce_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                   int n4, int ranges) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n4) return;
  const float4* p = part + e;
  float4 s = *p;
#pragma unroll 1
  for (int j = 1; j < ranges; ++j) {
    p += n4;
    const float4 v = *p;
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  out[e] = s;
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

// wy, wx: host arrays of n_levels (<= 4) window sides (1 .. 32 each); wins: the
// n_levels window pointers. M*K rows; D must be 32. part: [ranges, M*K, 32]
// f32 scratch; warps (<= 12) x groups x 16 rows must cover K.
extern "C" int probe_cell(const void* yr, const void* xr, const void* aw, const void* const* wins,
                          const int* wy, const int* wx, int n_levels, void* part, void* out, int M,
                          int K, int reps, int warps, int groups, int ranges, void* stream) {
  if (n_levels < 1 || n_levels > kLevels || warps < 1 || warps > kMaxWarps || ranges < 1 ||
      M < 1 || K < 1 || groups * warps * kTile < K ||
      static_cast<long long>(M) * K * kD / 4 * ranges >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.n_levels = n_levels;
  lv.kmax = 16;
  for (int v = 0; v < n_levels; ++v) {
    if (wy[v] < 1 || wx[v] < 1 || wy[v] > kMaxSide || wx[v] > kMaxSide)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.win[v] = static_cast<const unsigned short*>(wins[v]);
    lv.wy[v] = wy[v];
    lv.wx[v] = wx[v];
    const int cols = 16 * ((wy[v] + 3) / 4) * ((wx[v] + 3) / 4);
    lv.kmax = cols > lv.kmax ? cols : lv.kmax;
  }
  const int smem = kD * (lv.kmax + 8) * 2 + warps * kTile * kHyRow;
  cudaError_t err =
      cudaFuncSetAttribute(cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cell_kernel<<<dim3(groups, M, ranges), warps * 32, smem, st>>>(
      static_cast<const float*>(yr), static_cast<const float*>(xr),
      static_cast<const float*>(aw), lv, static_cast<float*>(part), K, reps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n4 = M * K * kD / 4;
  cell_reduce_kernel<<<(n4 + 255) / 256, 256, 0, st>>>(
      static_cast<const float4*>(part), static_cast<float4*>(out), n4, ranges);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_tile(const void* x, void* out, int rows, int w, int times, void* stream) {
  const dim3 grid((w + 31) / 32, (rows + 7) / 8 < 65535 ? (rows + 7) / 8 : 65535);
  tile_kernel<<<grid, dim3(32, 8), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows, w, times);
  return static_cast<int>(cudaGetLastError());
}
