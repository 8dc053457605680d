// K4: the set matcher's auction assignment, one thread block a problem.
//
// Replaces the device loop of richsem_tpu/ops/lap.py:auction_assignment: the
// lax.while_loop (:193) with its cond (:169-173) and body (:175-190), the
// bidding step (:92-136) and the greedy fallback (:206-213), which the JAX
// train step runs inside jit. The port's plain version
// (richsem_tpu_torch/ops/lap.py:_auction) runs the same rounds from the host
// and reads a flag from the card every round; this kernel runs the whole loop
// in one launch and gives the same assignment, bit for bit, on the same f32
// costs, in the same rounds:
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
// The valid persons are numbered j = 0 .. n_valid - 1 in person order (a
// ballot compaction), and the loop works on j: a lower j is a lower person.
// Each bid is one 64-bit atomicMax in shared memory on its object's key, the
// bid's f32 bits mapped to an order-preserving unsigned word (negative floats
// too) in the high half and ~j in the low half, so the largest bid wins and,
// among equal bids, the lowest person; the result does not depend on the
// order of the atomics. A key of 0 is no bid.
//
// What bounds it on the card: nothing of bytes or operations. At the flagship
// shapes (B 2, P 300 slots with 16 valid, O 900 queries) the valid rows are
// 115 KB and a round's work a few hundred thousand operations; the rounds are
// sequential, so the time is the chain of rounds, each a latency: a warp's
// scan of its bidder's row (a lone warp issues far below one instruction a
// cycle), the warp's reductions, the 64-bit atomicMax (a compare-and-swap
// loop), two block barriers and the resolution's dependent shared-memory
// reads. The design:
//
// * Rows read from global memory through the read-only path (__ldg): the
//   block's shared memory holds only its state (ops/lap.py:smem_bytes), so L1
//   keeps the bidders' rows across rounds. Staging the valid rows in shared
//   memory instead measured 0.96 against 1.01 us a round on a flagship
//   matching (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 15), too
//   little to keep a second path for.
// * A warp a bidder: each lane keeps four running (v1, first index, v2), one
//   per component of the float4s it reads (one where O % 4 != 0), without a
//   branch (maxima and a select, so that no compare-and-select chain runs
//   through the row), merged in the lane and then across the warp by three
//   redux.sync: the largest order-mapped v1 (-0 taken as +0, so equal floats
//   give equal words), the lowest index that holds it, the largest of the
//   rest.
// * Resolution by bidder: a thread a bidder (bidder i on lane i / 16 of the
//   warp that bid it) reads its object's key; the winner takes the object,
//   sets its price and evicts holder[obj]; losers and the evicted form the
//   next round's bidders (one atomicAdd each). The work is O(bidders), not
//   O(P), and the assigned count is n_valid minus the next list's length.
// * Two block barriers a round: the keys, the bidders' objects and the next
//   list's counter are double-buffered by round parity, so the last round's
//   keys are cleared, and this round's counter zeroed, inside the bid pass
//   (by the last warp, after its bids).
// * A round of one bidder (most of a flagship matching's rounds after the
//   first few) needs no key: all 16 warps scan a slice of its row each, warp
//   0 merges their top-2 after the first barrier, and its lane 0 bids and
//   takes the object at once.
//
// Nothing is read on the host: the kernel writes obj_of [B, P] (int64, -1 for
// invalid persons) and, for each problem, its rounds and its bids (the sum
// over rounds of the bidders).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;  // lap.py's _NEG_INF
constexpr unsigned int kMinusInfBits = 0xff800000u;
constexpr float kTheta = 64.0f;
constexpr int kStallWindow = 32;

// Order-preserving map of a float to an unsigned word (negative floats
// reversed), and its inverse.
__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long bid_key(float bid, int j) {
  return (static_cast<unsigned long long>(order_bits(bid)) << 32) | static_cast<unsigned int>(~j);
}

__device__ __forceinline__ int key_person(unsigned long long k) {
  return static_cast<int>(~static_cast<unsigned int>(k));
}

// One value v at index o into a running (m1, first index i1, m2), without a
// branch: m1 and m2 are maxima (one instruction each on the chain, where a
// compare that selects m1 would put the compare's latency on it), m2 takes
// min(v, m1), which is the old m1 when v wins and v otherwise, and i1 moves
// only on a strictly larger v.
__device__ __forceinline__ void top2_add(float v, int o, float& m1, int& i1, float& m2) {
  i1 = v > m1 ? o : i1;
  m2 = fmaxf(m2, fminf(v, m1));
  m1 = fmaxf(m1, v);
}

// Two running (m1, i1, m2) over disjoint indices into one: the larger m1 and,
// on a tie, the lower index; m2 the largest of the two m2 and the smaller m1.
__device__ __forceinline__ void top2_merge(float& m1, int& i1, float& m2, float om1, int oi1,
                                           float om2) {
  i1 = om1 > m1 ? oi1 : (om1 == m1 ? min(i1, oi1) : i1);
  m2 = fmaxf(fmaxf(m2, om2), fminf(m1, om1));
  m1 = fmaxf(m1, om1);
}

// The warp's (v1, first index, v2) from its lanes' (m1, i1, m2): the lane
// holding the lowest index of the largest m1 gives its m2, the others their
// m1. O >= 1, so some lane holds an index.
__device__ __forceinline__ void warp_top2(float& m1, int& i1, float& m2) {
  const unsigned int k1 = order_bits(__fadd_rn(m1, 0.f));  // -0 + 0 = +0
  const unsigned int kmax = __reduce_max_sync(0xffffffffu, k1);
  const unsigned int first =
      __reduce_min_sync(0xffffffffu, k1 == kmax ? static_cast<unsigned int>(i1) : UINT_MAX);
  const unsigned int k2 = __reduce_max_sync(
      0xffffffffu, order_bits(static_cast<unsigned int>(i1) == first ? m2 : m1));
  m1 = order_float(kmax);
  i1 = static_cast<int>(first);
  m2 = order_float(k2);
}

// The warp's first argmax of its lanes' (m1, i1).
__device__ __forceinline__ int warp_first_max(float m1, int i1) {
  const unsigned int k1 = order_bits(__fadd_rn(m1, 0.f));
  const unsigned int kmax = __reduce_max_sync(0xffffffffu, k1);
  return static_cast<int>(
      __reduce_min_sync(0xffffffffu, k1 == kmax ? static_cast<unsigned int>(i1) : UINT_MAX));
}

// The benefit of a cost element: its sign bit flipped when negating (exact,
// as -c).
__device__ __forceinline__ float benefit(float c, unsigned int flip) {
  return __uint_as_float(__float_as_uint(c) ^ flip);
}

// A lane's running (m1, i1, m2) of v = benefit(row) - price over its objects:
// with vec, float4 t = lane, lane + kStep, ... (four runs, one a component,
// then merged); else o = lane, lane + kStep, ... (kStep 32 for a warp's scan,
// 512 for the block's, lane then the thread's index)
template <int kStep = 32>
__device__ __forceinline__ void lane_top2(const float* row, const float* price, int O, bool vec,
                                          unsigned int flip, int lane, float& m1, int& i1,
                                          float& m2) {
  m1 = __uint_as_float(kMinusInfBits);
  m2 = kNeg;
  i1 = INT_MAX;
  if (vec) {
    float a1[3], a2[3];
    int ai[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      a1[a] = m1;
      a2[a] = kNeg;
      ai[a] = INT_MAX;
    }
    const float4* p4 = reinterpret_cast<const float4*>(price);
#pragma unroll 2
    for (int t = lane; t < (O >> 2); t += kStep) {
      const float4 r = __ldg(reinterpret_cast<const float4*>(row) + t), p = p4[t];
      top2_add(__fsub_rn(benefit(r.x, flip), p.x), 4 * t, m1, i1, m2);
      top2_add(__fsub_rn(benefit(r.y, flip), p.y), 4 * t + 1, a1[0], ai[0], a2[0]);
      top2_add(__fsub_rn(benefit(r.z, flip), p.z), 4 * t + 2, a1[1], ai[1], a2[1]);
      top2_add(__fsub_rn(benefit(r.w, flip), p.w), 4 * t + 3, a1[2], ai[2], a2[2]);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) top2_merge(m1, i1, m2, a1[a], ai[a], a2[a]);
  } else {
    for (int o = lane; o < O; o += kStep)
      top2_add(__fsub_rn(benefit(__ldg(row + o), flip), price[o]), o, m1, i1, m2);
  }
}

// The greedy fallback's first argmax of a row over the objects not held.
__device__ __forceinline__ int free_argmax(const float* row, const int* holder, int O,
                                           unsigned int flip, int lane) {
  float m1 = __uint_as_float(kMinusInfBits);
  int i1 = INT_MAX;
  for (int o = lane; o < O; o += 32) {
    const float v = holder[o] >= 0 ? kNeg : benefit(__ldg(row + o), flip);
    if (v > m1) {
      m1 = v;
      i1 = o;
    }
  }
  return warp_first_max(m1, i1);
}

// Shared memory a block needs for P persons and O objects (ops/lap.py:smem_bytes
// checks the same count before a launch).
__host__ __device__ constexpr size_t smem_bytes(int P, int O) {
  return static_cast<size_t>(O) * (2 * sizeof(unsigned long long) + 2 * sizeof(float)) +
         static_cast<size_t>(P) * 7 * sizeof(int) + (3 * kWarps + 2) * sizeof(int);
}

__global__ void __launch_bounds__(kThreads, 1)
auction_kernel(const float* __restrict__ cost, const bool* __restrict__ valid,
               long long* __restrict__ obj_out, int* __restrict__ stats, int P, int O,
               int negate, int max_iters, float eps_rel) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [2][O] by parity
  float* price = reinterpret_cast<float*>(key + 2 * O);  // [O]
  int* holder = reinterpret_cast<int*>(price + O);        // [O] j holding o, -1 none
  int* vlist = holder + O;                                // [P] person of j
  int* objv = vlist + P;                                  // [P] object j holds, -1 none
  int* list = objv + P;                                   // [2][P] bidders by parity
  int* bobj = list + 2 * P;                               // [2][P] a bidder's object, by parity
  float* bval = reinterpret_cast<float*>(bobj + 2 * P);   // [P] a bidder's bid
  int* s_wcnt = reinterpret_cast<int*>(bval + P);         // [kWarps] set-up; a warp's i1
  float* s_red = reinterpret_cast<float*>(s_wcnt + kWarps);  // [kWarps] set-up; a warp's m1
  float* s_m2 = s_red + kWarps;                           // [kWarps] a warp's m2
  int* s_cnt = reinterpret_cast<int*>(s_m2 + kWarps);     // [2] next bidders, by parity

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* C = cost + static_cast<size_t>(blockIdx.x) * P * O;
  const bool* V = valid + static_cast<size_t>(blockIdx.x) * P;
  const unsigned int flip = negate ? 0x80000000u : 0u;

  for (int o = tid; o < O; o += kThreads) {
    key[o] = key[O + o] = 0ull;
    price[o] = 0.f;
    holder[o] = -1;
  }
  // the valid persons in person order: a ballot a warp, 512 persons a pass
  int n_valid = 0;
  for (int base = 0; base < P; base += kThreads) {
    const int p = base + tid;
    const bool v = p < P && V[p];
    const unsigned int bal = __ballot_sync(0xffffffffu, v);
    if (lane == 0) s_wcnt[warp] = __popc(bal);
    __syncthreads();
    int at = n_valid + __popc(bal & ((1u << lane) - 1u));
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_wcnt[w];
      if (w < warp) at += c;
      n_valid += c;
    }
    if (v) {
      vlist[at] = p;
      objv[at] = -1;
      list[at] = at;
    }
    __syncthreads();  // s_wcnt is taken again
  }
  const bool vec = (O & 3) == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;

  // scale = max(max |benefit| over valid rows, 1e-6), a warp a row
  float m = 0.f;
  for (int j = warp; j < n_valid; j += kWarps) {
    const float* src = C + static_cast<size_t>(vlist[j]) * O;
    if (vec) {
      for (int t = lane; t < (O >> 2); t += 32) {
        const float4 c = __ldg(reinterpret_cast<const float4*>(src) + t);
        m = fmaxf(fmaxf(m, fmaxf(fabsf(c.x), fabsf(c.y))), fmaxf(fabsf(c.z), fabsf(c.w)));
      }
    } else {
      for (int o = lane; o < O; o += 32) m = fmaxf(m, fabsf(__ldg(src + o)));
    }
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  if (lane == 0) s_red[warp] = m;
  if (tid < 2) s_cnt[tid] = 0;
  __syncthreads();
  m = 0.f;
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, s_red[w]);
  const float scale = fmaxf(m, 1e-6f);
  const float eps_coarsest = __fdiv_rn(scale, kTheta);

  float eps = __fmul_rn(eps_rel, scale);
  const int cap = min(max_iters, 4 * n_valid + 64);
  int it = 0, best_n = 0, last_prog = 0, n_now = 0, rounds = 0, bids = 0;
  int n_bid = n_valid, n_prev = 0;
  int par = 0;  // this round's buffers: key, list, bobj, s_cnt [par]
  while (true) {
    const bool stalled = it >= cap || it - last_prog >= kStallWindow;
    if (!(n_now < n_valid && (!stalled || eps <= eps_coarsest))) break;
    ++rounds;
    int* cur = list + par * P;
    if (stalled) {  // restart from zero prices with a 64x coarser epsilon
      eps = __fmul_rn(eps, kTheta);
      it = best_n = last_prog = 0;
      for (int o = tid; o < O; o += kThreads) {
        price[o] = 0.f;
        holder[o] = -1;
      }
      for (int j = tid; j < n_valid; j += kThreads) {
        objv[j] = -1;
        cur[j] = j;
      }
      n_bid = n_valid;
      __syncthreads();
    }
    unsigned long long* kc = key + par * O;
    int* bc = bobj + par * P;
    int* nxt = list + (par ^ 1) * P;
    const bool alone = n_bid == 1;  // no other bid to resolve against: no key

    // bids, a warp a bidder; meanwhile the last warp clears the last round's
    // keys and zeroes this round's counter (their last readers passed two
    // barriers ago). A lone bidder's row is scanned by all warps, each a
    // slice, and warp 0 merges their top-2 after the first barrier and
    // resolves at once: it takes its object, when its bid is valid.
    if (alone) {
      const int j = cur[0];
      float m1, m2;
      int i1;
      lane_top2<kThreads>(C + static_cast<size_t>(vlist[j]) * O, price, O, vec, flip, tid, m1,
                          i1, m2);
      warp_top2(m1, i1, m2);
      if (lane == 0) {
        s_red[warp] = m1;
        s_wcnt[warp] = i1;
        s_m2[warp] = m2;
      }
      __syncthreads();
      if (warp == 0) {
        m1 = lane < kWarps ? s_red[lane] : __uint_as_float(kMinusInfBits);
        i1 = lane < kWarps ? s_wcnt[lane] : INT_MAX;
        m2 = lane < kWarps ? s_m2[lane] : kNeg;
        warp_top2(m1, i1, m2);
        if (lane == 0) {
          const float bid = __fadd_rn(__fadd_rn(price[i1], __fsub_rn(m1, m2)), eps);
          int push = j;
          if (bid > kNeg / 2) {
            push = holder[i1];
            holder[i1] = j;
            objv[j] = i1;
            price[i1] = bid;
            if (push >= 0) objv[push] = -1;
          }
          if (push >= 0) nxt[0] = push;
          s_cnt[par] = push >= 0;
        }
      }
    } else {
      for (int i = warp; i < n_bid; i += kWarps) {
        const int j = cur[i];
        float m1, m2;
        int i1;
        lane_top2(C + static_cast<size_t>(vlist[j]) * O, price, O, vec, flip, lane, m1, i1, m2);
        warp_top2(m1, i1, m2);
        if (lane == 0) {
          const float bid = __fadd_rn(__fadd_rn(price[i1], __fsub_rn(m1, m2)), eps);
          bc[i] = i1;
          bval[i] = bid;
          atomicMax(&kc[i1], bid_key(bid, j));
        }
      }
    }
    if (warp == kWarps - 1) {
      unsigned long long* kp = key + (par ^ 1) * O;
      const int* bp = bobj + (par ^ 1) * P;
      for (int i = lane; i < n_prev; i += 32) kp[bp[i]] = 0ull;
      if (lane == 0 && !alone) s_cnt[par] = 0;
    }
    __syncthreads();

    // resolution, a thread a bidder (bidder i on lane i / 16 of warp i % 16,
    // the warp that bid it, so that a round's few bidders sit in as many
    // warps): the key's person takes its object (a valid bid), sets its price
    // and evicts the holder; losers and the evicted are the next round's
    // bidders, each pushed with one atomicAdd
    if (!alone) {
      for (int i = warp + kWarps * lane; i < n_bid; i += kThreads) {
        const int j = cur[i], o = bc[i];
        const float b = bval[i];
        int push = j;
        if (key_person(kc[o]) == j && b > kNeg / 2) {
          push = holder[o];
          holder[o] = j;
          objv[j] = o;
          price[o] = b;
          if (push >= 0) objv[push] = -1;
        }
        if (push >= 0) nxt[atomicAdd(&s_cnt[par], 1)] = push;
      }
      __syncthreads();
    }

    bids += n_bid;
    n_prev = alone ? 0 : n_bid;
    n_bid = s_cnt[par];
    n_now = n_valid - n_bid;
    ++it;
    if (n_now > best_n) {
      best_n = n_now;
      last_prog = it;
    }
    par ^= 1;
  }

  // greedy fallback for the valid persons still unassigned (list[par])
  const int* left = list + par * P;
  for (int i = warp; i < n_bid; i += kWarps) {
    const int j = left[i];
    const int o = free_argmax(C + static_cast<size_t>(vlist[j]) * O, holder, O, flip, lane);
    if (lane == 0) objv[j] = o;
  }
  __syncthreads();
  long long* out = obj_out + static_cast<size_t>(blockIdx.x) * P;
  for (int q = tid; q < P; q += kThreads)
    if (!V[q]) out[q] = -1;
  for (int j = tid; j < n_valid; j += kThreads) out[vlist[j]] = objv[j];
  if (tid == 0) {
    stats[2 * blockIdx.x] = rounds;
    stats[2 * blockIdx.x + 1] = bids;
  }
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
      static_cast<long long*>(obj_of), static_cast<int*>(stats), P, O, negate, max_iters,
      eps_rel);
  return cudaGetLastError();
}
