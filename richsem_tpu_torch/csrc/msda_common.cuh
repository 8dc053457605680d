// Parts shared by the four deformable-attention kernels, K1
// (ms_deform_attn_fwd.cu), K1-bwd (ms_deform_attn_bwd.cu), K3
// (ms_deform_attn_sep_fwd.cu) and K3-bwd (ms_deform_attn_sep_bwd.cu): the
// pyramid's levels, the vector loads and stores of a value row's channels, and
// the geometry of one tap, so that every kernel places a tap on the same four
// corners as the plain versions; and the separable sampler's hats and rounding.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace msda {

constexpr int kMaxLevels = 8;
constexpr int kD = 32;  // channels a head: the kernels take this head dim only
constexpr int kFwdLanes = 4;                 // lanes a tap in the forward kernels (K1, K3)
constexpr int kFwdChans = kD / kFwdLanes;    // channels a lane there: 8

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  long long start[kMaxLevels];
};

// Levels from the host array of L (h, w) pairs; false unless 1 <= L <= 8 and
// the levels hold S tokens.
inline bool make_levels(Levels& lv, int L, const int* shapes, int S) {
  if (L < 1 || L > kMaxLevels) return false;
  lv.n = L;
  long long start = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = shapes[2 * l];
    lv.w[l] = shapes[2 * l + 1];
    lv.start[l] = start;
    start += static_cast<long long>(lv.h[l]) * lv.w[l];
  }
  return start == S;
}

// Four consecutive channels as f32: one 8-byte (bf16) or 16-byte (f32) load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}

// kFwdChans channels of one value row, as loaded: one 16-byte load (two for
// f32), converted to f32 where the products need them.
template <typename T>
struct Chans {
  static constexpr int kWords = kFwdChans * static_cast<int>(sizeof(T)) / 4;
  uint32_t r[kWords];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(p) + i);
      r[4 * i] = t.x; r[4 * i + 1] = t.y; r[4 * i + 2] = t.z; r[4 * i + 3] = t.w;
    }
  }
  __device__ __forceinline__ float at(int i) const {
    if constexpr (sizeof(T) == 4)
      return __uint_as_float(r[i]);
    else
      return __uint_as_float((i & 1) ? (r[i >> 1] & 0xffff0000u) : (r[i >> 1] << 16));
  }
};

// A lane's kFwdChans output channels, rounded once to the output's type.
__device__ __forceinline__ void store_out(float* p, const float (&v)[kFwdChans]) {
#pragma unroll
  for (int i = 0; i < kFwdChans; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float (&v)[kFwdChans]) {
#pragma unroll
  for (int i = 0; i < kFwdChans; i += 4) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[i], v[i + 1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[i + 2], v[i + 3]);
    uint2 t;
    t.x = *reinterpret_cast<const uint32_t*>(&lo);
    t.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p + i) = t;
  }
}

// A tap's pixel coordinate, loc * size - 0.5, rounded as PyTorch rounds it (no
// fused multiply-add): the bilinear corners jump at integer pixels, so a
// sample one ulp across one must fall on the same side as in the plain version.
__device__ __forceinline__ float pixel(float loc, int size) {
  return __fsub_rn(__fmul_rn(loc, static_cast<float>(size)), 0.5f);
}

// Whether any corner of the tap at (x, y) lies inside an h x w level: taps at
// x <= -1 or x >= w (likewise y) carry zero weight, and skipping them keeps
// the integer casts in range.
__device__ __forceinline__ bool inside(float x, float y, int h, int w) {
  return x > -1.f && x < w && y > -1.f && y < h;
}

// The four corners of a tap that is inside(): corner k = (x0 + (k & 1),
// y0 + (k >> 1)), its bilinear weight wk[k] and whether it is in bounds.
struct Corners {
  int x0, y0;
  float dx, dy;
  bool in[4];
  float wk[4];
};

__device__ __forceinline__ Corners corners(float x, float y, int h, int w) {
  Corners c;
  const float xf = floorf(x), yf = floorf(y);
  c.dx = x - xf;
  c.dy = y - yf;
  c.x0 = static_cast<int>(xf);
  c.y0 = static_cast<int>(yf);
  c.in[0] = c.y0 >= 0 && c.x0 >= 0;
  c.in[1] = c.y0 >= 0 && c.x0 + 1 < w;
  c.in[2] = c.y0 + 1 < h && c.x0 >= 0;
  c.in[3] = c.y0 + 1 < h && c.x0 + 1 < w;
  c.wk[0] = (1.f - c.dy) * (1.f - c.dx);
  c.wk[1] = (1.f - c.dy) * c.dx;
  c.wk[2] = c.dy * (1.f - c.dx);
  c.wk[3] = c.dy * c.dx;
  return c;
}

// A sum over the eight lanes that serve a tap in the backward kernels (K1-bwd,
// K3-bwd): lanes 8g .. 8g + 7, in a fixed tree (xor 1, 2, 4).
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// The separable sampler (K3, K3-bwd) rounds to its compute type where the TPU
// kernel does: bf16 for a bf16 value, nowhere for f32.
template <typename T> __device__ __forceinline__ float round_cdt(float v);
template <> __device__ __forceinline__ float round_cdt<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_cdt<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// max(0, 1 - |c - i|), the TPU kernel's _hat, with no contraction.
__device__ __forceinline__ float hat(float c, int i) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(c, static_cast<float>(i)))));
}

// Its derivative as the TPU kernel's _dhat has it: -sign(c - i) for
// |c - i| < 1, else 0 (so 0 at c = i and at |c - i| = 1).
__device__ __forceinline__ float dhat(float c, int i) {
  const float diff = __fsub_rn(c, static_cast<float>(i));
  if (!(fabsf(diff) < 1.f) || diff == 0.f) return 0.f;
  return diff > 0.f ? -1.f : 1.f;
}

// One tap of the separable sampler (K3, K3-bwd), computed once by the lane
// that loads it, so that the forward and the backward agree on it bit for bit:
// the token of corner (x0, y0) clamped into the level, the steps to x0 + 1 (0
// or 1) and to y0 + 1 (0 or w) packed as step_y * 2 + step_x, and the corners'
// factors: hxw_i = cdt(hat(x, i) * aw), hat(y, j), and for the backward
// hat(x, i), dhat(x, i) and dhat(y, j). Every factor of an out-of-range corner
// is 0 (the TPU kernel's dense basis has no row there, though dhat is nonzero
// one pixel outside); a tap with no corner inside keeps token 0 and zeros.
struct SepTap {
  int tok = 0, step = 0;
  float hxw[2] = {0.f, 0.f};
  float hx[2] = {0.f, 0.f}, dx[2] = {0.f, 0.f};
  float hy[2] = {0.f, 0.f}, dy[2] = {0.f, 0.f};
};

template <typename T>
__device__ __forceinline__ SepTap sep_tap(float2 loc, float a, int l, const Levels& lv) {
  SepTap t;
  const int h = lv.h[l], w = lv.w[l];
  const float x = pixel(loc.x, w), y = pixel(loc.y, h);
  if (!inside(x, y, h, w)) return t;
  const int x0 = static_cast<int>(floorf(x)), y0 = static_cast<int>(floorf(y));
  const bool xin[2] = {x0 >= 0, x0 + 1 < w}, yin[2] = {y0 >= 0, y0 + 1 < h};
  t.tok = static_cast<int>(lv.start[l]) + max(y0, 0) * w + max(x0, 0);
  t.step = ((yin[0] && yin[1]) ? w : 0) * 2 + ((xin[0] && xin[1]) ? 1 : 0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (xin[i]) {
      t.hx[i] = hat(x, x0 + i);
      t.dx[i] = dhat(x, x0 + i);
      t.hxw[i] = round_cdt<T>(__fmul_rn(t.hx[i], a));
    }
    if (yin[i]) {
      t.hy[i] = hat(y, y0 + i);
      t.dy[i] = dhat(y, y0 + i);
    }
  }
  return t;
}

}  // namespace msda
