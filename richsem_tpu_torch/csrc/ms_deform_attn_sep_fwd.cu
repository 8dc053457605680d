// K3: separable deformable attention of the decoder, forward.
//
// Replaces the TPU kernel richsem_tpu/ops/ms_deform_attn_sep_pallas.py:_fwd_kernel
// (behind _fwd_impl, the dec_msda_impl="sep_pallas" sampler). That kernel writes
// the bilinear sampler as two hat bases per level and contracts them as dense
// products, [ck, W] x [W, H*D] then a 0/1 reduction matrix over y, because the
// MXU is the TPU's fast unit. Only two x-taps and two y-taps of each hat are
// nonzero, and adding the zeros of the dense product is exact, so this kernel
// gathers those four corners per (b, q, m, l, p), as K1 does, and rounds where
// the TPU kernel rounds (cdt = bf16 for a bf16 value, else f32):
//
//   x = loc_x * W - 0.5, y = loc_y * H - 0.5       (no FMA contraction)
//   hxw_i = cdt(max(0, 1 - |x - i|) * aw)          for the in-range taps i in {x0, x0+1}
//   r_j   = hxw_x0 * V[j, x0] + hxw_x1 * V[j, x1]   f32, for the in-range taps j in {y0, y0+1}
//   rh_j  = cdt(r_j * max(0, 1 - |y - j|))
//   out[b, q, m, :] = cdt(sum_p f32(sum_l sum_j rh_j))
//
// so that it agrees with the plain dense version up to the order of f32 sums.
// The rounding of rh_j is per channel, so the four corners cannot fold into
// four weights as in K1: each lane forms r_j and rh_j for its own channels.
// r_j keeps __fmul_rn / __fadd_rn: for an f32 value an FMA would round once
// where the TPU kernel rounds twice.
//
// Layouts (row-major, as the JAX package's public functions have them):
//   value [B, S, M, 32] (bf16 or f32), loc [B, Q, M, L, P, 2] f32 (x, y),
//   aw [B, Q, M, L, P] f32 -> out [B, Q, M*32] in the value's dtype.
//
// What bounds it on the card: at the decoder's shapes (B2, Q = 1,100 with the
// 200 DN queries, M8, L4, P4) a call has 281,600 taps, whose 1,126,400 corner
// rows of 64 B (bf16) make 72 MB of gathers, almost all from L2 (the 25.6 MB
// value fits the 50 MB L2), against 30 MB of device memory (value, loc and aw
// read once, out written once): its bound is the bytes. Each tap is a short
// dependent chain (location -> corner addresses -> four row reads ->
// products), so what the kernel can do about it is keep many loads in flight
// and spend few instructions a tap.
//
// Design (K1's, ms_deform_attn_fwd.cu):
// - A warp serves two (b, q, m) rows, one per half-warp, in row-major order.
//   One coalesced load a warp brings both rows' 16 taps of loc and aw. When
//   the rows are odd in number, the last warp's spare half-warp reads the last
//   row's addresses with every tap zeroed and writes nothing.
// - The lane that loads a tap computes its geometry once (msda_common.cuh:
//   sep_tap, shared with K3-bwd): the clamped token of the first corner and
//   the steps to the others, the two rounded hxw and the two hat(y, j), with
//   every factor of an out-of-range corner or tap set to 0. Six shuffles hand
//   them to the tap's lane group.
// - Four lanes serve a tap, eight channels each (Chans: one 16-byte load a
//   corner in bf16, two in f32).
// - Every corner load is issued unconditionally, from a clamped in-bounds
//   address, for a batch of two taps before the first product; an
//   out-of-range corner or tap gives zero through its zero weights.
// - Each lane sums its taps' rh_j in f32 in order; the row's lane groups then
//   meet in a fixed shuffle tree (xor 4, then xor 8), and the first group
//   writes the row.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "msda_common.cuh"

namespace {

using namespace msda;  // Levels, Chans, store_out, SepTap, sep_tap; kD = 32

constexpr int kThreads = 256;      // 8 warps: 16 rows a block
constexpr int kLanes = kFwdLanes;  // lanes a tap: 4
constexpr int kC = kFwdChans;      // channels a lane: 8

template <typename T>
__global__ void __launch_bounds__(kThreads)
msda_sep_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                    const float* __restrict__ aw, T* __restrict__ out, long long n_rows,
                    int S, int Q, int M, int P, Levels lv) {
  constexpr int kGroups = 16 / kLanes;  // lane groups a row (a half-warp)
  constexpr int kRounds = kLanes;       // taps a group takes from a 16-tap chunk
  constexpr int kBatch = 16 / kC;       // taps whose loads are issued together
  static_assert(kRounds % kBatch == 0, "batches split the rounds");
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (2 * warp >= n_rows) return;  // uniform across the warp
  const long long row = 2 * warp + (lane >> 4);  // (b, q, m), row-major
  const bool live = row < n_rows;
  const long long r = live ? row : n_rows - 1;  // a spare half-warp's taps are zero
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
    // geometry (msda_common.cuh:sep_tap). A tap past the row's taps, or of a
    // spare half-warp, keeps the token 0 and zero factors.
    const int tl = t0 + hl;
    SepTap tap;
    if (live && tl < lp_n)
      tap = sep_tap<T>(*reinterpret_cast<const float2*>(loc + (r * lp_n + tl) * 2),
                       aw[r * lp_n + tl], tl / P, lv);
#pragma unroll
    for (int r0 = 0; r0 < kRounds; r0 += kBatch) {
      Chans<T> v[kBatch][4];
      float w0[kBatch], w1[kBatch], h0[kBatch], h1[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int ti = (r0 + i) * kGroups + grp;  // the group's tap in the chunk
        const int src_lane = (lane & 16) | ti;
        const int t = __shfl_sync(0xffffffffu, tap.tok, src_lane);
        const int step = __shfl_sync(0xffffffffu, tap.step, src_lane);
        w0[i] = __shfl_sync(0xffffffffu, tap.hxw[0], src_lane);
        w1[i] = __shfl_sync(0xffffffffu, tap.hxw[1], src_lane);
        h0[i] = __shfl_sync(0xffffffffu, tap.hy[0], src_lane);
        h1[i] = __shfl_sync(0xffffffffu, tap.hy[1], src_lane);
        const int sx = step & 1, sy = step >> 1;
        const T* c00 = vrow + static_cast<long long>(t) * tok;
        v[i][0].load(c00);
        v[i][1].load(c00 + sx * tok);
        v[i][2].load(c00 + static_cast<long long>(sy) * tok);
        v[i][3].load(c00 + static_cast<long long>(sy + sx) * tok);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i)
#pragma unroll
        for (int j = 0; j < kC; ++j) {
          // r_j of rows y0 and y0 + 1, then rh_j, in the TPU kernel's roundings
          const float ry0 = __fadd_rn(__fmul_rn(w0[i], v[i][0].at(j)),
                                      __fmul_rn(w1[i], v[i][1].at(j)));
          const float ry1 = __fadd_rn(__fmul_rn(w0[i], v[i][2].at(j)),
                                      __fmul_rn(w1[i], v[i][3].at(j)));
          acc[j] += round_cdt<T>(__fmul_rn(ry0, h0[i]));
          acc[j] += round_cdt<T>(__fmul_rn(ry1, h1[i]));
        }
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
  msda_sep_fwd_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const float*>(aw), static_cast<T*>(out), n_rows, S, Q, M, P, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// shapes: host array of L (h, w) pairs; D must be 32.
// Returns cudaGetLastError() after the launch.
extern "C" int msda_sep_fwd(const void* value, const void* loc, const void* aw,
                            void* out, int B, int S, int Q, int M, int D, int L, int P,
                            const int* shapes, int value_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_is_bf16)
    return launch<__nv_bfloat16>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
  return launch<float>(value, loc, aw, out, B, S, Q, M, D, L, P, shapes, s);
}
