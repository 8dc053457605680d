// K4: the set matcher's auction assignment, one thread block a problem.
//
// Replaces the device loop of richsem_tpu/ops/lap.py:auction_assignment: the
// lax.while_loop (:193) with its cond (:169-173) and body (:175-190), the
// bidding step (:92-136) and the greedy fallback (:206-213), which the JAX
// train step runs inside jit. The port's plain version
// (richsem_tpu_torch/ops/lap.py:_auction) runs the same rounds from the host
// and reads a flag from the card every round; this kernel runs the whole loop
// in one launch and gives the same assignment, bit for bit, on the same f32
// costs:
//
//   persons p (GT slots, [P], a validity mask) bid for objects o (queries, [O]);
//   benefit = -cost (negate) or the input itself, read only on valid rows;
//   scale = max(max |benefit| over valid rows, 1e-6), eps = eps_rel * scale;
//   each round, every valid unassigned person (a bidder) takes
//     v = benefit[p, :] - price, v1 = max v, best = first argmax,
//     v2 = max of v over every object but best (-1e30 if there is none),
//     bid = (price[best] + (v1 - v2)) + eps      (in that order, no FMA);
//   each object goes to its largest bid, among equal bids to the lowest person;
//   its price becomes that bid and its holder, if any, is evicted;
//   an attempt that stalls (it >= min(max_iters, 4 n_valid + 64), or 32 rounds
//   without a new best count of assigned persons) restarts from zero prices
//   with eps * 64, unless eps > scale / 64 already, which ends the loop;
//   whoever is left unassigned takes the first argmax of its benefit over the
//   objects not held at the loop's end, each on its own (two may collide, as
//   in lap.py:109-112 and JAX :209-213).
//
// Resolution without a [P, O] plane: each bid is one 64-bit atomicMax in shared
// memory on its object's key, the bid's f32 bits mapped to an order-preserving
// unsigned word (negative floats too) in the high half and ~person in the low
// half, so the largest bid wins and, among equal bids, the lowest person; the
// result does not depend on the order of the atomics. A key of 0 is no bid.
//
// What bounds it on the card: nothing of bytes or operations. At the flagship
// shapes (B 2, P 300 slots with 16 valid, O 900 queries) the valid rows are
// 115 KB and a round's work a few hundred thousand operations; the rounds are
// sequential, so the time is the chain of rounds, each a pass over the
// bidders' rows (from L2 after the first) and three block-wide barriers.
// Design: one block of 512 threads a problem; price [O], the keys [O] and the
// persons' state [P] in shared memory; a warp a bidder, each lane a strided
// slice of the row with a running (v1, first index, v2), merged by a shuffle
// tree; a thread a person resolves; the bidder lists are compacted so that a
// round reads only the rows of its bidders. The control values are the same in
// every thread, so the loop needs no broadcast. Nothing is read on the host:
// the kernel writes obj_of [B, P] (int64, -1 for invalid persons) and, for
// each problem, its rounds and its bids (the sum over rounds of the bidders).

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // lap.py's _NEG_INF
constexpr unsigned int kMinusInfBits = 0xff800000u;
constexpr float kTheta = 64.0f;
constexpr int kStallWindow = 32;

__device__ __forceinline__ unsigned long long bid_key(float bid, int person) {
  const unsigned int u = __float_as_uint(bid);
  const unsigned int hi = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(hi) << 32) | static_cast<unsigned int>(~person);
}

__device__ __forceinline__ int key_person(unsigned long long k) {
  return static_cast<int>(~static_cast<unsigned int>(k));
}

// (m1, i1): the largest value and its first index; m2: the largest of the rest.
__device__ __forceinline__ void merge_top2(float& m1, int& i1, float& m2) {
  for (int off = 16; off > 0; off >>= 1) {
    const float om1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const int oi1 = __shfl_xor_sync(0xffffffffu, i1, off);
    const float om2 = __shfl_xor_sync(0xffffffffu, m2, off);
    if (om1 > m1 || (om1 == m1 && oi1 < i1)) {
      m2 = fmaxf(om2, m1);
      m1 = om1;
      i1 = oi1;
    } else {
      m2 = fmaxf(m2, om1);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ cost, const bool* __restrict__ valid,
               long long* __restrict__ obj_out, int* __restrict__ stats, int P, int O,
               int negate, int max_iters, float eps_rel) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* key = smem;                           // [O] the round's best bid
  float* price = reinterpret_cast<float*>(key + O);         // [O]
  int* obj = reinterpret_cast<int*>(price + O);             // [P] object held, -1 none
  int* best = obj + P;                                      // [P] object bid for
  float* bidv = reinterpret_cast<float*>(best + P);         // [P] the bid
  int* list0 = reinterpret_cast<int*>(bidv + P);            // [P] bidders (two lists,
  int* list1 = list0 + P;                                   //  this round's and the next)
  int* vlist = list1 + P;                                   // [P] valid persons
  unsigned char* vflag = reinterpret_cast<unsigned char*>(vlist + P);  // [P]
  __shared__ int s_count[3];  // valid persons; assigned after a round; next bidders
  __shared__ float s_red[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* C = cost + static_cast<size_t>(blockIdx.x) * P * O;
  const bool* V = valid + static_cast<size_t>(blockIdx.x) * P;
  auto benefit = [negate](float c) { return negate ? -c : c; };

  if (tid < 3) s_count[tid] = 0;
  for (int o = tid; o < O; o += kThreads) {
    key[o] = 0ull;
    price[o] = 0.f;
  }
  __syncthreads();
  for (int p = tid; p < P; p += kThreads) {
    obj[p] = -1;
    vflag[p] = V[p];
    if (V[p]) {
      const int i = atomicAdd(&s_count[0], 1);
      vlist[i] = p;
      list0[i] = p;
    }
  }
  __syncthreads();
  const int n_valid = s_count[0];

  // scale = max(max |benefit| over the valid rows, 1e-6)
  float m = 0.f;
  for (int i = warp; i < n_valid; i += kWarps) {
    const float* row = C + static_cast<size_t>(vlist[i]) * O;
    for (int o = lane; o < O; o += 32) m = fmaxf(m, fabsf(row[o]));
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) s_red[warp] = m;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_red[w]);
  const float scale = fmaxf(m, 1e-6f);
  const float eps_coarsest = __fdiv_rn(scale, kTheta);

  float eps = __fmul_rn(eps_rel, scale);
  const int cap = min(max_iters, 4 * n_valid + 64);
  int it = 0, best_n = 0, last_prog = 0, n_now = 0, rounds = 0, bids = 0;
  int n_bid = n_valid;
  int par = 0;  // list1 holds this round's bidders, else list0
  while (true) {
    int* cur = par ? list1 : list0;
    int* nxt = par ? list0 : list1;
    const bool stalled = it >= cap || it - last_prog >= kStallWindow;
    if (!(n_now < n_valid && (!stalled || eps <= eps_coarsest))) break;
    ++rounds;
    if (stalled) {  // restart from zero prices with a 64x coarser epsilon
      eps = __fmul_rn(eps, kTheta);
      it = best_n = last_prog = 0;
      for (int o = tid; o < O; o += kThreads) price[o] = 0.f;
      for (int p = tid; p < P; p += kThreads) obj[p] = -1;
      for (int i = tid; i < n_valid; i += kThreads) cur[i] = vlist[i];
      n_bid = n_valid;
    }
    if (tid == 0) s_count[1] = s_count[2] = 0;
    __syncthreads();

    // bids: a warp a bidder
    for (int i = warp; i < n_bid; i += kWarps) {
      const int p = cur[i];
      const float* row = C + static_cast<size_t>(p) * O;
      float m1 = __uint_as_float(kMinusInfBits), m2 = kNeg;
      int i1 = INT_MAX;
      for (int o = lane; o < O; o += 32) {
        const float v = __fsub_rn(benefit(row[o]), price[o]);
        if (v > m1) {
          m2 = fmaxf(m2, m1);
          m1 = v;
          i1 = o;
        } else {
          m2 = fmaxf(m2, v);
        }
      }
      merge_top2(m1, i1, m2);
      if (lane == 0) {
        const float bid = __fadd_rn(__fadd_rn(price[i1], __fsub_rn(m1, m2)), eps);
        best[p] = i1;
        bidv[p] = bid;
        atomicMax(&key[i1], bid_key(bid, p));
      }
    }
    __syncthreads();

    // resolution: a thread a person; winners take their object and set its
    // price, holders of a contested object are evicted
    int mine = 0;
    for (int q = tid; q < P; q += kThreads) {
      if (!vflag[q]) continue;
      int o = obj[q];
      if (o < 0) {
        const int ob = best[q];
        if (key_person(key[ob]) == q && bidv[q] > kNeg / 2) {
          obj[q] = o = ob;
          price[ob] = bidv[q];
        }
      } else {
        const unsigned long long k = key[o];
        if (k != 0ull && bidv[key_person(k)] > kNeg / 2) obj[q] = o = -1;
      }
      if (o >= 0) ++mine;
      else nxt[atomicAdd(&s_count[2], 1)] = q;
    }
    if (mine) atomicAdd(&s_count[1], mine);
    __syncthreads();

    for (int i = tid; i < n_bid; i += kThreads) key[best[cur[i]]] = 0ull;
    bids += n_bid;
    n_now = s_count[1];
    n_bid = s_count[2];
    ++it;
    if (n_now > best_n) {
      best_n = n_now;
      last_prog = it;
    }
    par ^= 1;
    __syncthreads();
  }

  int* cur = par ? list1 : list0;  // the valid persons still unassigned
  // greedy fallback: the keys (all 0 here) mark the objects held
  for (int q = tid; q < P; q += kThreads)
    if (obj[q] >= 0) key[obj[q]] = 1ull;
  __syncthreads();
  for (int i = warp; i < n_bid; i += kWarps) {
    const int p = cur[i];
    const float* row = C + static_cast<size_t>(p) * O;
    float m1 = __uint_as_float(kMinusInfBits), m2 = kNeg;
    int i1 = INT_MAX;
    for (int o = lane; o < O; o += 32) {
      const float v = key[o] ? kNeg : benefit(row[o]);
      if (v > m1) {
        m1 = v;
        i1 = o;
      }
    }
    merge_top2(m1, i1, m2);
    if (lane == 0) obj[p] = i1;
  }
  __syncthreads();
  for (int q = tid; q < P; q += kThreads)
    obj_out[static_cast<size_t>(blockIdx.x) * P + q] = obj[q];
  if (tid == 0) {
    stats[2 * blockIdx.x] = rounds;
    stats[2 * blockIdx.x + 1] = bids;
  }
}

// Shared memory a block needs for P persons and O objects (ops/lap.py:smem_bytes
// checks the same count before a launch).
size_t smem_bytes(int P, int O) {
  return static_cast<size_t>(O) * (sizeof(unsigned long long) + sizeof(float)) +
         static_cast<size_t>(P) * (6 * sizeof(int) + 1);
}

}  // namespace

// cost [B, P, O] f32 (benefit = -cost when negate, else cost itself),
// valid [B, P] bool -> obj_of [B, P] int64, stats [B, 2] int32 (rounds, bids).
extern "C" int auction(const void* cost, const void* valid, void* obj_of, void* stats, int B,
                       int P, int O, int negate, int max_iters, float eps_rel, void* stream) {
  const size_t smem = smem_bytes(P, O);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  auction_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<const bool*>(valid),
      static_cast<long long*>(obj_of), static_cast<int*>(stats), P, O, negate,
      max_iters, eps_rel);
  return cudaGetLastError();
}
