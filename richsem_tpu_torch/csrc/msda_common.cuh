// Parts shared by K1 (ms_deform_attn_fwd.cu) and K1-bwd (ms_deform_attn_bwd.cu):
// the pyramid's levels, the vector loads of a value row's channels, and the
// geometry of one tap, so that the forward and the backward place every tap
// on the same four corners as the plain version.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace msda {

constexpr int kMaxLevels = 8;
constexpr int kD = 32;  // channels a head: the kernels take this head dim only

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

}  // namespace msda
