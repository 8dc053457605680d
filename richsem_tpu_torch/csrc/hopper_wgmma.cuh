// Hopper building blocks shared by the hand-written kernels: cp.async staging
// into 128-byte-swizzled shared-memory tiles, wgmma shared-memory descriptors,
// and warpgroup matrix products (wgmma.mma_async, bf16 in, f32 accumulators).
//
// Tile layout. Every operand tile is a set of blocks of R rows x 64 bf16 (128
// bytes a row), each block 1024-byte aligned; the 16-byte chunk c of row r sits
// at r * 128 + ((c ^ (r % 8)) * 16), the 128-byte swizzle that wgmma's layout
// type 1 (B128) reads. A K-major operand (K contiguous) keeps 64 K values a row;
// an MN-major one (M or N contiguous) keeps 64 M or N values a row, one row a K.
//
// Descriptors (PTX ISA, "Matrix Descriptor Format"): start address, leading
// byte offset (LBO) and stride byte offset (SBO), each >> 4, and the layout
// type in bits 62-63. B128 K-major: 8-row groups SBO = 1024 bytes apart, LBO
// unused; a k-step of 16 moves the start by 32 bytes inside the 128-byte row.
// B128 MN-major: 8-K-row groups SBO = 1024 bytes apart, 64-wide M/N blocks LBO
// apart; a k-step of 16 moves the start by 16 rows = 2048 bytes. The products
// take the low descriptor word of each operand in a register and add the k-step
// offset inside the instruction's asm, so no descriptor is held in registers.
//
// Needs sm_90a (wgmma).

#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r inside a swizzled block.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Generic-proxy writes to shared memory (st.shared, cp.async) made visible to
// the async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The value of x, opaque to the compiler: what is derived from it is computed
// where it is used, not kept live in registers across a loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  uint32_t y;
  asm volatile("mov.b32 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Low word of a B128 descriptor: start address and leading byte offset, >> 4.
// The high word is the same for every operand here: SBO = 1024 bytes, layout
// type B128 (bit 62).
__device__ __forceinline__ uint32_t desc_lo(uint32_t saddr, uint32_t lbo) {
  return ((saddr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product (issue it before the first wgmma and after
// the wait).
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator fragment of an m64nN product (PTX ISA, "Register Fragments"):
// thread t of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 and 8 more,
// and for each 8-column block j the columns 8j + 2 (t % 4) + {0, 1}:
// d[4j + e] is (row0, col 8j + 2(t%4) + e), d[4j + 2 + e] is (row0 + 8, same).

// D[64 x N] += A[64 x 16] B[16 x N]: bf16 operands in shared memory, f32
// accumulators in registers (N / 2 a thread). a_lo, b_lo: desc_lo of the
// operands; OA, OB: offsets added to them (in 16-byte units, compile time), so
// that a walk over k keeps one register a operand. TA / TB: 0 if the operand
// is K-major, 1 if MN-major (the transpose bits).
template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "add.s32 la, %32, %34;\nadd.s32 lb, %33, %35;\n"
      "mov.b32 hi, %36;\nmov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, %38, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a_lo), "r"(b_lo), "n"(OA), "n"(OB), "n"(kDescHi), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "add.s32 la, %64, %66;\nadd.s32 lb, %65, %67;\n"
      "mov.b32 hi, %68;\nmov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, %70, %71;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a_lo), "r"(b_lo), "n"(OA), "n"(OB), "n"(kDescHi), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB, int OA, int OB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 la, lb, hi;\n.reg .b64 da, db;\n"
      "add.s32 la, %128, %130;\nadd.s32 lb, %129, %131;\n"
      "mov.b32 hi, %132;\nmov.b64 da, {la, hi};\nmov.b64 db, {lb, hi};\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "da, db, p, 1, 1, %134, %135;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a_lo), "r"(b_lo), "n"(OA), "n"(OB), "n"(kDescHi), "r"(1), "n"(TA), "n"(TB));
}

// Byte offset of k-step k (16 deep) in an operand tile: K-major in blocks of
// R rows x 64 (R > 0), or MN-major (R = 0: 16 rows of 128 bytes a step).
template <int R>
__host__ __device__ constexpr int koff(int k) {
  return R > 0 ? (k >> 2) * R * 128 + (k & 3) * 32 : k * 2048;
}

// D += A B over k-steps K0 .. K1 - 1, A tiles laid out as koff<RA>, B as koff<RB>.
template <int K0, int K1, int TA, int TB, int RA, int RB, int N>
__device__ __forceinline__ void mma_k(float (&d)[N], uint32_t a_lo, uint32_t b_lo) {
  if constexpr (K0 < K1) {
    constexpr int oa = koff<RA>(K0) >> 4, ob = koff<RB>(K0) >> 4;
    if constexpr (N == 32) wgmma_n64<TA, TB, oa, ob>(d, a_lo, b_lo);
    if constexpr (N == 64) wgmma_n128<TA, TB, oa, ob>(d, a_lo, b_lo);
    if constexpr (N == 128) wgmma_n256<TA, TB, oa, ob>(d, a_lo, b_lo);
    mma_k<K0 + 1, K1, TA, TB, RA, RB, N>(d, a_lo, b_lo);
  }
}

}  // namespace hopper
