// K7: greedy NMS keep masks, one thread block an image.
//
// Replaces the device loop of richsem_tpu/ops/nms.py:nms_mask (the N-step
// lax.fori_loop at :35, vmapped over the batch by models/postprocess.py:41-45)
// and gives its mask bit for bit on the same f32 boxes and scores:
//
//   order = stable argsort(-scores)           (equal scores in index order)
//   iou   = box_iou of the sorted boxes       (utils/boxes.py, f32)
//   for i in 0 .. N-1: if keep[i]: keep[j] = 0 for every j > i with iou[i, j] > thr
//   keep is scattered back to the original order.
//
// The IoU rounds as box_iou does, each operation on its own (no FMA
// contraction, which could move a pair across the threshold):
//   area  = max(x2 - x1, 0) * max(y2 - y1, 0)
//   inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0)
//   iou   = inter / (((area_i + area_j) - inter) + 1e-8)
//
// The block: (1) each thread ranks its scores against all N in shared memory,
// rank = #{s_j > s_i} + #{j < i, s_j == s_i}, which is the stable order; (2)
// the sorted boxes and their areas go to shared memory; (3) a thread a row i
// writes the bits of j > i whose IoU is above the threshold, ceil(N / 32)
// words a row; (4) warp 0 runs the sweep, lane w holding word w of the keep
// mask: step i reads bit i by a shuffle from its lane and, if it is set,
// clears row i's bits (N dependent steps, a shuffle and a shared-memory read
// each); (5) the block writes keep [N] (0 or 1 bytes) in the original order.
// N <= 1024 (32 words a row: a lane each); shared memory 28 N + 4 N ceil(N/32)
// bytes (ops/nms.py:smem_bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 1024;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__device__ __forceinline__ float iou_of(float4 a, float aa, float4 b, float ab) {
  float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  float inter = __fmul_rn(w, h);
  float uni = __fsub_rn(__fadd_rn(aa, ab), inter);
  return __fdiv_rn(inter, __fadd_rn(uni, 1e-8f));
}

__global__ void __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           uint8_t* __restrict__ keep, int n, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (n + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);           // [n] sorted boxes
  float* score = reinterpret_cast<float*>(sbox + n);        // [n] scores, original order
  float* area = score + n;                                  // [n] sorted areas
  int* order = reinterpret_cast<int*>(area + n);            // [n] original index of rank r
  uint32_t* bits = reinterpret_cast<uint32_t*>(order + n);  // [n][words]
  __shared__ uint32_t kept[32];

  const int img = blockIdx.x;
  boxes += (size_t)img * n;
  scores += (size_t)img * n;
  keep += (size_t)img * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) score[i] = scores[i];
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float s = score[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float t = score[j];
      rank += (t > s) || (t == s && j < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const float4 b = boxes[order[r]];
    sbox[r] = b;
    area[r] = area_of(b);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float4 bi = sbox[i];
    const float ai = area[i];
    uint32_t* row = bits + (size_t)i * words;
    for (int w = 0; w < words; ++w) {
      uint32_t word = 0;
      if (w * 32 + 31 > i) {
        for (int k = 0; k < 32; ++k) {
          const int j = w * 32 + k;
          if (j > i && j < n && iou_of(bi, ai, sbox[j], area[j]) > thr) word |= 1u << k;
        }
      }
      row[w] = word;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    uint32_t mine = 0;
    if (lane < words) {
      const int left = n - lane * 32;
      mine = left >= 32 ? 0xffffffffu : ((1u << left) - 1u);
    }
    for (int i = 0; i < n; ++i) {
      const uint32_t owner = __shfl_sync(0xffffffffu, mine, i >> 5);
      if ((owner >> (i & 31)) & 1u) {  // the same on every lane
        if (lane < words) mine &= ~bits[(size_t)i * words + lane];
      }
    }
    kept[lane] = mine;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n; r += blockDim.x)
    keep[order[r]] = (kept[r >> 5] >> (r & 31)) & 1u;
}

// The sweep's loop body alone, on one warp: `steps` dependent steps of a
// shuffle, a test of the bit and a shared-memory read of the row's word, over
// rows of zeros (every box stays kept, so every step reads). Its cycles and
// nanoseconds (clock64 and %globaltimer around the loop) give the per-step
// latency floor that bounds K7's sweep: N steps that depend on each other.
__global__ void sweep_floor_kernel(int steps, unsigned long long* out, uint32_t* sink) {
  __shared__ uint32_t rows[32 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 32 * 32; i += 32) rows[i] = 0;
  __syncwarp();
  uint32_t mine = 0xffffffffu;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int i = 0; i < steps; ++i) {
    const uint32_t owner = __shfl_sync(0xffffffffu, mine, (i >> 5) & 31);
    if ((owner >> (i & 31)) & 1u) mine &= ~rows[(i & 31) * 32 + lane];
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  sink[lane] = mine;
  if (lane == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = g1 - g0;
  }
}

}  // namespace

// out[0] cycles, out[1] ns of `steps` sweep steps on one warp; sink [32] words.
extern "C" int nms_sweep_floor(int steps, unsigned long long* out, uint32_t* sink, void* stream) {
  sweep_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, out, sink);
  return (int)cudaGetLastError();
}

extern "C" int nms_smem_bytes(int n) { return 28 * n + 4 * n * ((n + 31) / 32); }

// boxes [b, n, 4] f32 xyxy, scores [b, n] f32, keep [b, n] bytes (0 or 1).
extern "C" int nms_keep(const float* boxes, const float* scores, uint8_t* keep, int b, int n,
                        float thr, void* stream) {
  if (n < 1 || n > kMaxN || b < 1) return (int)cudaErrorInvalidValue;
  const int smem = nms_smem_bytes(n);
  if (smem > 48 * 1024) {  // past the default: N > 384
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<b, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, keep, n, thr);
  return (int)cudaGetLastError();
}
