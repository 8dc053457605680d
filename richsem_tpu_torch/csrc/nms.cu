// K7: greedy NMS keep masks, one thread-block cluster an image.
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
// Bound: the bytes and operations are tiny (0.000032 ms at bs2 x 300); what
// costs time is latency: the greedy decisions depend on each other. A block
// an image ran on 2 of 132 SMs at bs2, with one thread a row of IoUs and N
// dependent steps in its sweep. The design spreads the independent work over
// a cluster and cuts the dependent chain to ceil(N / 32) steps:
//
// (1) kCluster blocks an image, one cluster. Every block loads the N scores;
//     the cluster's warps split the rows, four rows a warp at a time: lane l
//     compares scores l, l + 32, ... with the four, branch-free, and a warp
//     sum gives rank = #{s_j > s_i} + #{j < i, s_j == s_i} (the stable
//     order); lanes 0 .. kCluster-1 write the box, its area and its index at
//     that rank into every block's shared memory (DSMEM).
// (2) The warps split the rows again (dealt back and forth, so that long and
//     short rows even out); for row i and each word w >= i / 32, lane k
//     decides iou(i, 32 w + k) > thr and a ballot forms the 32-bit word of
//     the later boxes the row removes; lane w keeps word w and the row is
//     stored into the leading block's bit matrix through DSMEM. A cluster
//     barrier (release / acquire) makes the matrix visible to the leader.
//     The decision is that of the rounded quotient, but the division is
//     skipped where the intersection lies clearly above or below thr times
//     the rounded denominator (iou_above): for nearly every pair, and for
//     every pair that does not intersect.
// (3) The leader's warp 0 sweeps the words, lane v holding word v of the keep
//     mask. Block w (boxes 32 w .. 32 w + 31): lane l holds the diagonal word
//     of row 32 w + l; the block's candidates (its boxes not yet removed) are
//     resolved in registers, for k = 0 .. 31: if box k is still a candidate
//     it removes the bits of its diagonal word (32 shuffles that do not
//     depend on the candidates, and a test and an AND-NOT that do); then
//     every lane v > w removes the words bits[32 w + k][v] of the kept k (32
//     independent shared-memory loads). ceil(N / 32) dependent block steps,
//     the decisions taken in the same greedy order, so the same mask.
// (4) The leader writes keep [N] (0 or 1 bytes) in the original order.
//
// N <= 1024 (32 words a row: a lane each). Every block of a cluster launch has
// the same dynamic shared memory, 28 N + 4 N ceil(N / 32) bytes
// (ops/nms.py:smem_bytes); the bit matrix is used in the leader only.
//
// Optional stamps [5][2]: %globaltimer ns and clock64 cycles at the start and
// after the rank, IoU, sweep and scatter passes, from thread 0 of image 0's
// leader (null on the main path).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;  // portable cluster size
constexpr int kThreads = 512;
constexpr int kWarps = kCluster * kThreads / 32;  // the cluster's warps
constexpr int kMaxN = 1024;
constexpr uint32_t kFull = 0xffffffffu;

__device__ __forceinline__ float area_of(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// box_iou(a, b) > thr, bit for bit, each operation rounded on its own. For
// 2^-98 <= thr <= FLT_MAX (`fast`) the division is skipped when the
// intersection lies outside thr * d times (1 -+ 2^-20), d the rounded
// denominator: the products' rounding errors stay below 2^-22 of it, so the
// quotient lies more than half an ulp of thr away from thr and rounds to the
// same side. A NaN falls through to the division.
__device__ __forceinline__ bool iou_above(float4 a, float aa, float4 b, float ab, float thr,
                                          bool fast) {
  float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  float inter = __fmul_rn(w, h);
  float d = __fadd_rn(__fsub_rn(__fadd_rn(aa, ab), inter), 1e-8f);
  if (fast) {
    const float p = __fmul_rn(thr, d);
    if (inter > __fmul_rn(p, 1.00000095367431640625f)) return true;   // 1 + 2^-20
    if (inter < __fmul_rn(p, 0.99999904632568359375f)) return false;  // 1 - 2^-20
  }
  return __fdiv_rn(inter, d) > thr;
}

__device__ __forceinline__ void stamp(long long* stamps, int k) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  stamps[2 * k] = (long long)ns;
  stamps[2 * k + 1] = clock64();
}

// One block step of the sweep on one warp. `kept`: this lane's word of the
// keep mask; `diag`: the diagonal word of row 32 w + lane; `col`: the bit
// matrix at row 32 w, column lane (rows `words` apart). -> the lane's word
// after block w is decided.
__device__ __forceinline__ uint32_t sweep_block(uint32_t kept, int w, int words, uint32_t diag,
                                                const uint32_t* col, int lane) {
  uint32_t cand = __shfl_sync(kFull, kept, w);
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    const uint32_t rk = __shfl_sync(kFull, diag, k);
    if ((cand >> k) & 1u) cand &= ~rk;
  }
  if (lane == w) return cand;
  if (lane > w && lane < words) {
    uint32_t r0 = 0, r1 = 0, r2 = 0, r3 = 0;
#pragma unroll
    for (int k = 0; k < 32; k += 4) {
      r0 |= col[(k + 0) * words] & (0u - ((cand >> (k + 0)) & 1u));
      r1 |= col[(k + 1) * words] & (0u - ((cand >> (k + 1)) & 1u));
      r2 |= col[(k + 2) * words] & (0u - ((cand >> (k + 2)) & 1u));
      r3 |= col[(k + 3) * words] & (0u - ((cand >> (k + 3)) & 1u));
    }
    return kept & ~((r0 | r1) | (r2 | r3));
  }
  return kept;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nms_kernel(const float4* __restrict__ boxes, const float* __restrict__ scores,
           uint8_t* __restrict__ keep, int n, float thr, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (n + 31) / 32;
  float4* sbox = reinterpret_cast<float4*>(smem);           // [n] sorted boxes
  float* score = reinterpret_cast<float*>(sbox + n);        // [n] scores, original order
  float* area = score + n;                                  // [n] sorted areas
  int* order = reinterpret_cast<int*>(area + n);            // [n] original index of rank r
  uint32_t* bits = reinterpret_cast<uint32_t*>(order + n);  // [n][words], the leader's
  __shared__ uint32_t kept_words[32];

  cg::cluster_group cluster = cg::this_cluster();
  const unsigned crank = cluster.block_rank();
  const int img = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int gw = (int)crank * (kThreads / 32) + (threadIdx.x >> 5);  // warp in the cluster
  boxes += (size_t)img * n;
  scores += (size_t)img * n;
  keep += (size_t)img * n;
  const bool stamping = stamps != nullptr && img == 0 && crank == 0 && threadIdx.x == 0;
  if (stamping) stamp(stamps, 0);

  for (int i = threadIdx.x; i < n; i += kThreads) score[i] = scores[i];
  cluster.sync();  // the scores loaded, and every block of the cluster running
  constexpr int kRows = 4;  // rows a warp ranks at once
  for (int i0 = gw; i0 < n; i0 += kRows * kWarps) {
    float s[kRows];
    int row[kRows], rank[kRows];
    float4 box[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      row[r] = i0 + r * kWarps;
      const int i = min(row[r], n - 1);
      s[r] = score[i];
      rank[r] = 0;
      if (lane < kCluster) box[r] = boxes[i];
    }
    for (int j = lane; j < n; j += 32) {
      const float t = score[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        rank[r] += (int)(t > s[r]) | ((int)(t == s[r]) & (int)(j < row[r]));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      rank[r] = (int)__reduce_add_sync(kFull, (unsigned)rank[r]);
      if (row[r] < n && lane < kCluster) {
        cluster.map_shared_rank(sbox, lane)[rank[r]] = box[r];
        cluster.map_shared_rank(area, lane)[rank[r]] = area_of(box[r]);
        cluster.map_shared_rank(order, lane)[rank[r]] = row[r];
      }
    }
  }
  cluster.sync();
  if (stamping) stamp(stamps, 1);

  uint32_t* lead_bits = cluster.map_shared_rank(bits, 0);
  // thr * d stays normal (d >= 1e-8 > 2^-27): the margins hold; NaN fails both
  const bool fast = thr >= 0x1p-98f && thr <= 3.40282347e38f;
  for (int p = 0; p * kWarps < n; ++p) {
    const int i = p * kWarps + ((p & 1) ? kWarps - 1 - gw : gw);
    if (i >= n) continue;
    const float4 bi = sbox[i];
    const float ai = area[i];
    uint32_t mine = 0;  // lane w: word w of row i
#pragma unroll 2  // deeper, ptxas spills around the division's slow-path call
    for (int w = i >> 5; w < words; ++w) {
      const int j = 32 * w + lane;
      bool hit = false;
      if (j > i && j < n) hit = iou_above(bi, ai, sbox[j], area[j], thr, fast);
      const uint32_t word = __ballot_sync(kFull, hit);
      if (lane == w) mine = word;
    }
    if (lane >= (i >> 5) && lane < words) lead_bits[(size_t)i * words + lane] = mine;
  }
  cluster.sync();  // the bit matrix complete in the leader; the others are done
  if (crank != 0) return;
  if (stamping) stamp(stamps, 2);

  if (threadIdx.x < 32) {
    uint32_t kept = 0;
    if (lane < words) {
      const int left = n - lane * 32;
      kept = left >= 32 ? kFull : ((1u << left) - 1u);
    }
    for (int w = 0; w < words; ++w) {
      const int row = 32 * w + lane;
      const uint32_t diag = row < n ? bits[(size_t)row * words + w] : 0u;
      kept = sweep_block(kept, w, words, diag, bits + (size_t)(32 * w) * words + lane, lane);
    }
    kept_words[lane] = kept;
  }
  __syncthreads();
  if (stamping) stamp(stamps, 3);
  for (int r = threadIdx.x; r < n; r += kThreads)
    keep[order[r]] = (kept_words[r >> 5] >> (r & 31)) & 1u;
  if (stamps != nullptr) {
    __syncthreads();
    if (stamping) stamp(stamps, 4);
  }
}

// One block step of the sweep alone, on one warp: `steps` dependent steps of
// sweep_block over a 32 x 32 word matrix of zeros (every box stays kept, so
// lanes 1-31 each load and mask their 32 words; `stride` is 0, read at run
// time so that the loads stay in the loop). Its cycles and nanoseconds
// (clock64 and %globaltimer around the loop) give the per-block latency that
// bounds K7's sweep: ceil(N / 32) block steps that depend on each other.
__global__ void block_floor_kernel(int steps, int stride, unsigned long long* out,
                                   uint32_t* sink) {
  __shared__ uint32_t rows[32 * 32];
  const int lane = threadIdx.x;
  for (int i = lane; i < 32 * 32; i += 32) rows[i] = 0;
  __syncwarp();
  uint32_t kept = kFull;
  unsigned long long g0, g1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) {
    const int w = (s * stride) & 31;
    kept = sweep_block(kept, w, 32, rows[(32 * w + lane) * 32 + w], rows + 32 * w * 32 + lane,
                       lane);
  }
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
  sink[lane] = kept;
  if (lane == 0) {
    out[0] = (unsigned long long)(c1 - c0);
    out[1] = g1 - g0;
  }
}

}  // namespace

// out[0] cycles, out[1] ns of `steps` sweep block steps on one warp; sink [32].
extern "C" int nms_block_floor(int steps, unsigned long long* out, uint32_t* sink,
                               void* stream) {
  block_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, 0, out, sink);
  return (int)cudaGetLastError();
}

extern "C" int nms_smem_bytes(int n) { return 28 * n + 4 * n * ((n + 31) / 32); }

// boxes [b, n, 4] f32 xyxy, scores [b, n] f32, keep [b, n] bytes (0 or 1);
// stamps null, or [5][2] int64 (see the header).
extern "C" int nms_keep(const float* boxes, const float* scores, uint8_t* keep, int b, int n,
                        float thr, long long* stamps, void* stream) {
  if (n < 1 || n > kMaxN || b < 1) return (int)cudaErrorInvalidValue;
  const int smem = nms_smem_bytes(n);
  if (smem > 48 * 1024) {  // past the default: N > 384
    const cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_kernel<<<b * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(boxes), scores, keep, n, thr, stamps);
  return (int)cudaGetLastError();
}
