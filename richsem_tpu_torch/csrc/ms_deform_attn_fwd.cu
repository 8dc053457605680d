// K1: multi-scale deformable attention forward, exact zero-padded bilinear gather.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_pallas2.py:_fwd_kernel
// (the windowed hat-basis Pallas kernel behind ms_deform_attn_pallas2). That
// kernel reads one static window per 16x16 query tile and is exact only for taps
// within `margin` of the tile, which the model's offset clamp guarantees; it was
// shaped by the TPU's lack of vector gathers. Hopper gathers natively, so this
// kernel computes the reference CUDA sampler's function directly, with no
// window:
//
//   out[b,q,m,:] = sum_{l,p} aw[b,q,m,l,p] * bilinear0(V_l[b,:,:,m,:], loc[b,q,m,l,p])
//
// with pixel = loc * size - 0.5 and zero contribution from out-of-bounds taps.
// One kernel therefore serves both callers: the clamped encoder (Q = S) and the
// unclamped decoder (Q = 900 or 1,100, box references).
//
// Layouts (row-major, as the JAX package's public functions have them):
//   value [B, S, M, 32] (bf16 or f32), loc [B, Q, M, L, P, 2] f32 (x, y),
//   aw [B, Q, M, L, P] f32 -> out [B, Q, M*32] in the value's dtype.
//
// What bounds it on the card: at the encoder's shapes (B2, S = Q = 24,990, M8,
// L4, P4) a call has 6.40 M taps, 25.6 M corner rows of 64 bytes (bf16) to
// gather, nearly all from L2 (the 25.6 MB value fits in the 50 MB L2), against
// ~100 MB of device-memory traffic for loc, aw, value and out. Each tap is a
// short dependent chain (location -> corner addresses -> four row reads ->
// products), so the kernel is bound by the taps in flight, the instructions a
// tap costs and L2's gather rate, far from the bytes bound of the call.
//
// Design (K1-bwd's split, as measured on an H100 in PERF.md):
// - A warp serves two (b, q, m) rows, one per half-warp, in row-major order, so
//   that neighbouring queries share L2. One coalesced load a warp brings both
//   rows' 16 taps: 256 bytes of loc and 128 of aw. The lane that loads a tap
//   computes its level and pixel coordinate, pixel = loc * size - 0.5 rounded
//   as msda_common.cuh rounds it for K1-bwd (so the forward and the backward
//   use the same corners), and shuffles hand (level, x, y, aw) to the lane
//   group that samples it.
// - Four lanes serve a tap, eight channels each (one 16-byte bf16 load a
//   corner; 8 lanes x 4 channels with 8-byte loads measured 1.38x as long on an
//   H100, PERF.md). A group computes the tap's corners once (its lanes
//   together), not once a channel.
// - Every corner load is issued unconditionally from a clamped, in-bounds
//   address with its weight zeroed when the corner (or the tap) is out, so a
//   batch of taps (16 channels' worth a lane) has all its loads in flight
//   before the first product.
// - Each lane sums its taps in f32 in order; the row's lane groups then meet in
//   a fixed shuffle tree (xor 4, then xor 8), and the first group
//   writes the row's 64 (bf16) or 128 (f32) output bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"

namespace {

using namespace msda;  // Levels, Chans, store_out, the tap geometry; kD = 32

constexpr int kThreads = 256;  // 8 warps: 16 rows a block
constexpr int kLanes = kFwdLanes;  // lanes a tap: 4
constexpr int kC = kFwdChans;      // channels a lane: 8

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ aw, T* __restrict__ out, long long n_rows, int S,
                int Q, int M, int P, Levels lv) {
  constexpr int kGroups = 16 / kLanes;  // lane groups a row (a half-warp)
  constexpr int kRounds = kLanes;       // taps a group takes from a 16-tap chunk
  constexpr int kBatch = 16 / kC;       // taps whose loads are issued together
  static_assert(kRounds % kBatch == 0, "batches split the rounds");
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (2 * warp >= n_rows) return;  // uniform across the warp
  const long long row = 2 * warp + (lane >> 4);  // (b, q, m), row-major
  const bool live = row < n_rows;
  const long long r = live ? row : n_rows - 1;  // a spare half-warp reads the last row
  const int hl = lane & 15, grp = hl / kLanes, k = hl % kLanes;
  const int m = static_cast<int>(r % M);
  const long long b = r / M / Q;
  const int lp_n = lv.n * P;
  const long long tok = static_cast<long long>(M) * kD;  // elements a token
  const T* vrow = value + b * S * tok + static_cast<long long>(m) * kD + k * kC;

  float acc[kC];
#pragma unroll
  for (int j = 0; j < kC; ++j) acc[j] = 0.f;
  for (int t0 = 0; t0 < lp_n; t0 += 16) {
    // Lane l loads tap t0 + (l & 15) of its half-warp's row and computes its
    // level and pixel coordinate; a tap past the row's taps or with every
    // corner out keeps weight 0 and the in-bounds pixel (0, 0).
    const int tl = t0 + hl;
    int tap_l = 0;
    float tap_x = 0.f, tap_y = 0.f, tap_a = 0.f;
    if (tl < lp_n) {
      const float2 xy = *reinterpret_cast<const float2*>(loc + (r * lp_n + tl) * 2);
      const float a = aw[r * lp_n + tl];
      tap_l = tl / P;
      const int h = lv.h[tap_l], w = lv.w[tap_l];
      const float x = pixel(xy.x, w), y = pixel(xy.y, h);
      if (inside(x, y, h, w)) tap_x = x, tap_y = y, tap_a = a;
    }
#pragma unroll
    for (int r0 = 0; r0 < kRounds; r0 += kBatch) {
      Chans<T> v[kBatch][4];
      float cw[kBatch][4];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int ti = (r0 + i) * kGroups + grp;  // the group's tap in the chunk
        const int src_lane = (lane & 16) | ti;
        const int l = __shfl_sync(0xffffffffu, tap_l, src_lane);
        const float x = __shfl_sync(0xffffffffu, tap_x, src_lane);
        const float y = __shfl_sync(0xffffffffu, tap_y, src_lane);
        const float wa = __shfl_sync(0xffffffffu, tap_a, src_lane);
        const int h = lv.h[l], w = lv.w[l];
        const Corners c = corners(x, y, h, w);
        const T* vl = vrow + lv.start[l] * tok;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cx = min(max(c.x0 + (e & 1), 0), w - 1);
          const int cy = min(max(c.y0 + (e >> 1), 0), h - 1);
          v[i][e].load(vl + (static_cast<long long>(cy) * w + cx) * tok);
          cw[i][e] = c.in[e] ? wa * c.wk[e] : 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int j = 0; j < kC; ++j) acc[j] = fmaf(cw[i][e], v[i][e].at(j), acc[j]);
    }
  }
  // the row's lane groups in a fixed order: xor 4, then xor 8
#pragma unroll
  for (int s = kLanes; s < 16; s <<= 1)
#pragma unroll
    for (int j = 0; j < kC; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], s);
  if (live && grp == 0) store_out(out + row * kD + k * kC, acc);
}

template <typename T>
int launch(const void* value, const void* loc, const void* aw, void* out, int B, int S, int Q,
           int M, int D, int L, int P, const int* shapes, cudaStream_t stream) {
  Levels lv;
  if (D != kD || !make_levels(lv, L, shapes, S)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = static_cast<long long>(B) * Q * M;
  if (n_rows == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (n_rows + 2 * (kThreads / 32) - 1) / (2 * (kThreads / 32));
  msda_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<T*>(out), n_rows, S, Q, M, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; D must be 32.
// Returns cudaGetLastError() after the launch.
extern "C" int msda_fwd(const void* value, const void* loc, const void* aw,
                        void* out, int B, int S, int Q, int M, int D, int L, int P,
                        const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
}
