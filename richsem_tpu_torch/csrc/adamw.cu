// K5 and K6: the optimizer's global norm and AdamW update, multi-tensor.
//
// Replace the JAX package's optimizer, which XLA fuses into the jitted train
// step: the global norm of richsem_tpu/train/optim.py (optax.global_norm in
// clip_by_global_norm and in fused_adamw :124) and the update of every leaf,
// in either of its forms: the optax chain (:178-184, the default) or
// fused_adamw (:99-149, cfg.fused_adamw). One launch covers every leaf: each
// leaf is cut into chunks of kChunk elements and a block takes one chunk.
//
// K5, the norm (sumsq_kernel, then sumsq_finish_kernel):
//   each block squares its chunk's f32 gradient elements, each square rounded
//   in f32 (as g.float().square()), and sums them in float64: every thread
//   over the elements tid, tid + kThreads, ... in order, then a shuffle tree
//   over a warp's lanes (offsets 16, 8, 4, 2, 1) and the warps' sums in warp
//   order; the chunk's float64 partial goes to partials[chunk]. The finish, one
//   block, adds the partials in index order (so two calls agree bit for bit),
//   and writes gnorm = float32(sqrt(sum)) and the fused form's clip factor,
//   gnorm < max_norm ? 1 : max_norm / gnorm, to clip_state[0..1].
//
// K6, the update (adamw_kernel<Order>), per element, every operation rounded
// on its own (__fmul_rn and friends: nvcc would contract a*b+c into an FMA):
//   clip, chain: g = gnorm < max_norm ? g : (g / gnorm) * max_norm
//               (optax.clip_by_global_norm: a division, then a product);
//         fused: g = g * clip;
//   m = (1-b1)*g + b1*m,  v = (1-b2)*(g*g) + b2*v           (both forms);
//   adam = (m / c1) / (sqrt(v / c2) + eps),  u = adam + wd*p;
//   chain: u = u*s where the group scale s != 1, then p = p - u*lr;
//   fused: p = p + ((-s)*lr) * u.
// lr, c1 = 1 - b1^t and c2 = 1 - b2^t come from a device tensor (AdamW.hyper)
// and gnorm/clip from K5's output, so a CUDA graph replays the launch with
// each step's values. A null gradient is a zero one.
//
// The leaf tables (pointers, element counts, first chunks, group scales) are
// kernel parameters, __grid_constant__ structs copied at the launch: a CUDA
// graph records them with the launch, and no host-to-device copy is needed.
// Since CUDA 12.1 a kernel takes up to 32,764 bytes of parameters on sm_70
// and newer; a table that does not fit is split over several launches by the
// caller (ops/adamw.py:plan), each with the chunk index of its first block.
// A block finds its leaf by a binary search over the table's first chunks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kChunk = 65536;      // elements a block
constexpr int kThreads = 512;      // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kNormLeaves = 1024;  // entries of one K5 launch's table
constexpr int kAdamwLeaves = 512;  // entries of one K6 launch's table
constexpr int kFinishThreads = 256;  // K5's finish: one block
constexpr int kFinishTile = 2048;    // partials staged at a time

struct NormTable {
  const float* g[kNormLeaves];
  int count[kNormLeaves];
  int first[kNormLeaves + 1];  // first chunk of each leaf; first[n_leaves] = the chunks
  int n_leaves;
};

struct AdamwTable {
  const float* g[kAdamwLeaves];  // null: a zero gradient
  float* m[kAdamwLeaves];
  float* v[kAdamwLeaves];
  float* p[kAdamwLeaves];
  int count[kAdamwLeaves];
  int first[kAdamwLeaves + 1];
  float scale[kAdamwLeaves];
  int n_leaves;
};

// The constants of one optimizer, f32 as JAX's weak types make them.
struct AdamwConsts {
  float b1, one_minus_b1, b2, one_minus_b2, eps, weight_decay, max_norm;
};

static_assert(sizeof(NormTable) + sizeof(double*) <= 32764, "K5's parameters");
static_assert(sizeof(AdamwTable) + 2 * sizeof(float*) + sizeof(AdamwConsts) <= 32764,
              "K6's parameters");

enum class Order : int { kChain = 0, kFused = 1 };

// The largest i < n with first[i] <= chunk: the leaf that holds the chunk.
__device__ __forceinline__ int find_leaf(const int* first, int n, int chunk) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const __grid_constant__ NormTable t, double* __restrict__ partials) {
  __shared__ double warp_sums[kWarps];
  const int chunk = blockIdx.x;
  const int leaf = find_leaf(t.first, t.n_leaves, chunk);
  const long long start = static_cast<long long>(chunk - t.first[leaf]) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), t.count[leaf] - start));
  const float* g = t.g[leaf] + start;
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = g[i];
    acc = __dadd_rn(acc, static_cast<double>(__fmul_rn(x, x)));
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s = __dadd_rn(s, warp_sums[w]);
    partials[chunk] = s;
  }
}

// One block: the partials staged through shared memory a tile at a time by
// every thread, added in index order by thread 0.
__global__ void __launch_bounds__(kFinishThreads)
sumsq_finish_kernel(const double* __restrict__ partials, int n, float max_norm,
                    float* __restrict__ clip_state) {
  __shared__ double tile[kFinishTile];
  double s = 0.0;
  for (int base = 0; base < n; base += kFinishTile) {
    const int m = min(kFinishTile, n - base);
    for (int i = threadIdx.x; i < m; i += kFinishThreads) tile[i] = partials[base + i];
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 8
      for (int i = 0; i < m; ++i) s = __dadd_rn(s, tile[i]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float gnorm = __double2float_rn(__dsqrt_rn(s));
    clip_state[0] = gnorm;
    clip_state[1] = gnorm < max_norm ? 1.0f : __fdiv_rn(max_norm, gnorm);
  }
}

template <Order kOrder>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ AdamwTable t, const float* __restrict__ hyper,
             const float* __restrict__ clip_state, AdamwConsts c) {
  const int chunk = blockIdx.x;
  const int leaf = find_leaf(t.first, t.n_leaves, chunk);
  const long long start = static_cast<long long>(chunk - t.first[leaf]) * kChunk;
  const int n = static_cast<int>(min(static_cast<long long>(kChunk), t.count[leaf] - start));
  const float lr = hyper[0], c1 = hyper[1], c2 = hyper[2];
  const float gnorm = clip_state[0], clip = clip_state[1];
  const bool keep = gnorm < c.max_norm;  // the chain's trigger: no clip
  const float s = t.scale[leaf];
  const float neg_s_lr = __fmul_rn(-s, lr);
  const float* g = t.g[leaf] == nullptr ? nullptr : t.g[leaf] + start;
  float* m = t.m[leaf] + start;
  float* v = t.v[leaf] + start;
  float* p = t.p[leaf] + start;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    float gi = g == nullptr ? 0.0f : g[i];
    if (kOrder == Order::kChain) {
      if (!keep) gi = __fmul_rn(__fdiv_rn(gi, gnorm), c.max_norm);
    } else {
      gi = __fmul_rn(gi, clip);
    }
    const float mi = __fadd_rn(__fmul_rn(c.one_minus_b1, gi), __fmul_rn(c.b1, m[i]));
    const float vi =
        __fadd_rn(__fmul_rn(c.one_minus_b2, __fmul_rn(gi, gi)), __fmul_rn(c.b2, v[i]));
    const float adam =
        __fdiv_rn(__fdiv_rn(mi, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, c2)), c.eps));
    const float pi = p[i];
    const float u = __fadd_rn(adam, __fmul_rn(c.weight_decay, pi));
    float pn;
    if (kOrder == Order::kChain) {
      const float us = s != 1.0f ? __fmul_rn(u, s) : u;
      pn = __fsub_rn(pi, __fmul_rn(us, lr));
    } else {
      pn = __fadd_rn(pi, __fmul_rn(neg_s_lr, u));
    }
    m[i] = mi;
    v[i] = vi;
    p[i] = pn;
  }
}

}  // namespace

// The layout the caller must mirror: kChunk, kThreads, kNormLeaves,
// kAdamwLeaves, sizeof(NormTable), sizeof(AdamwTable), sizeof(AdamwConsts).
extern "C" void adamw_abi(long long* out) {
  out[0] = kChunk;
  out[1] = kThreads;
  out[2] = kNormLeaves;
  out[3] = kAdamwLeaves;
  out[4] = sizeof(NormTable);
  out[5] = sizeof(AdamwTable);
  out[6] = sizeof(AdamwConsts);
}

// The tables and constants come as untyped host pointers: a function whose
// signature names a type of the unnamed namespace is not exported.

// K5's blocks over one table (a NormTable): partials[0 .. n_chunks) (the
// caller offsets the pointer by the table's first chunk).
extern "C" int sumsq(const void* table, int n_chunks, void* partials, void* stream) {
  sumsq_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const NormTable*>(table), static_cast<double*>(partials));
  return cudaGetLastError();
}

// K5's finish over n partials -> clip_state [2] f32 (gnorm, clip).
extern "C" int sumsq_finish(const void* partials, int n, float max_norm, void* clip_state,
                            void* stream) {
  sumsq_finish_kernel<<<1, kFinishThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partials), n, max_norm, static_cast<float*>(clip_state));
  return cudaGetLastError();
}

// K6 over one table (an AdamwTable, with AdamwConsts); order 0 the chain,
// 1 fused_adamw.
extern "C" int adamw(const void* table, int n_chunks, const void* hyper, const void* clip_state,
                     const void* consts, int order, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamwTable& t = *static_cast<const AdamwTable*>(table);
  const AdamwConsts& c = *static_cast<const AdamwConsts*>(consts);
  const float* h = static_cast<const float*>(hyper);
  const float* cs = static_cast<const float*>(clip_state);
  if (order == 0)
    adamw_kernel<Order::kChain><<<n_chunks, kThreads, 0, s>>>(t, h, cs, c);
  else
    adamw_kernel<Order::kFused><<<n_chunks, kThreads, 0, s>>>(t, h, cs, c);
  return cudaGetLastError();
}
