"""How K4 (``richsem_tpu_torch/csrc/auction.cu``) splits the auction, emulated
on the CPU and held to the JAX ``auction_assignment`` (jitted on the CPU) and
to the port's plain ``_auction``, bit for bit on the assignment and with the
same rounds.

The emulation does what one thread block does for one problem. The valid
persons are numbered j in person order, and the rounds read their rows from
the cost. A bidder's row is cut among 32 lanes: where O % 4 == 0 (and the
cost is 16-byte aligned) lane l reads float4s t = l, l + 32, ... and keeps
four running (v1, first index, v2), one a component, merged in the lane;
otherwise lane l takes objects l, l + 32, ...
Both run without a branch: v1 and v2 as maxima (v2 takes min(v, v1)), the
index moving only on a strictly larger v; a merge takes the larger v1 and, on
a tie, the lower index, and v2 the largest of both v2 and the smaller v1.
The lanes merge by the kernel's three reductions over order-mapped words
(the largest v1 with -0 as +0, the lowest index that holds it, the largest of
the rest). The bid is (price + (v1 - v2)) + eps in float32; each bid becomes a
64-bit key (the float's bits mapped to an order-preserving word, negative
floats too, over ~j) applied by max in a shuffled order. Resolution runs a
thread a bidder: the key's person takes its object and evicts the holder of
``holder[obj]``; losers and the evicted form the next list, each pushed by one
atomicAdd, in a shuffled order. The keys, the bidders' objects and the
next list's counter are double-buffered by round parity: the last round's
keys are cleared in this round's bid pass, and the emulation checks that
this round's keys are all clear before its bids. A round of one bidder
writes no key: the block's 512 threads scan its row (float4s t = l, l + 512,
..., four runs each), each warp reduces its lanes, warp 0 reduces the 16
warps' results, and the bidder takes its object at once when its bid is
valid. The greedy fallback reads
the holders and lets two persons take one object.

Cases: ``tests/test_torch_lap.py``'s, P 300 with 16 valid and every row valid
at O 900, a row of O 30 (120 bytes, no float4), a misaligned cost, a single
object and odd widths, a negative bid reached through negative prices on a
hand-built state (one round against the plain version's round), signed zeros
tied across lanes, and a problem with no valid person. Last, the CUDA
wrapper's refusals, reached on a meta tensor that reports a CUDA device,
before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.ops.lap import auction_assignment as jax_auction
from richsem_tpu.ops.lap import batched_min_cost_assignment as jax_batched
from richsem_tpu_torch.ops import lap

NEG = np.float32(-1e30)
THETA = np.float32(64.0)
INT_MAX = 2**31 - 1
UINT_MAX = 2**32 - 1
LANES = 32


def order_bits(f) -> np.ndarray:
    """The kernel's order-preserving map of float32 to uint32 (negative floats
    reversed), elementwise."""
    u = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def order_float(k) -> np.ndarray:
    k = np.asarray(k, np.uint64)
    u = np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF)
    return u.astype(np.uint32).view(np.float32)


def order_key(bid: np.float32, j: int) -> int:
    """The kernel's 64-bit key: the bid's order-mapped bits over ~j (the
    lowest j, the lowest person, wins a tie)."""
    return (int(order_bits(bid)) << 32) | (~j & 0xFFFFFFFF)


def key_person(k: int) -> int:
    return ~k & 0xFFFFFFFF


def lane_runs(o: int, vec: bool, threads: int = LANES) -> np.ndarray:
    """[runs, steps] object indices (-1 past the end): the runs a thread keeps,
    run r of thread r % threads (a warp's 32 lanes, or the block's 512 threads
    for a lone bidder). With vec, thread l's four runs are the components of
    its float4s t = l, l + threads, ...; else one run, o = l, l + threads, ..."""
    if vec:
        t = np.arange(threads)[:, None] + threads * np.arange(-(-(o // 4) // threads))[None]
        idx = np.stack([4 * t + a for a in range(4)])  # [4, threads, steps]
        idx = np.where(t[None] < o // 4, idx, -1)
        return idx.reshape(4 * threads, -1)
    idx = np.arange(threads)[:, None] + threads * np.arange(-(-o // threads))[None]
    return np.where(idx < o, idx, -1)


def redux(a1, ai, a2, second=True):
    """The kernel's three reductions over the last axis (32 lanes): the
    largest order-mapped v1 (-0 as +0), the lowest index holding it, the
    largest of the winner's v2 and the others' v1."""
    k1 = order_bits(a1 + np.float32(0))  # -0 + 0 = +0
    kmax = k1.max(-1)
    first = np.where(k1 == kmax[..., None], ai, UINT_MAX).min(-1)
    k2 = order_bits(np.where(ai == first[..., None], a2, a1)).max(-1)
    v2 = order_float(k2) if second else np.full(kmax.shape, NEG, np.float32)
    return order_float(kmax), first, v2


def warp_top2(v: np.ndarray, vec: bool, second: bool = True, threads: int = LANES):
    """v [n, O] f32 -> the (v1, first index, v2) the kernel forms: each run's
    top2_add in index order, a thread's runs merged, the three reductions of
    each warp, and for the block's scan (512 threads) the same reductions
    over the 16 warps' results in warp 0 (lanes past 16 holding nothing)."""
    n, o = v.shape
    runs = lane_runs(o, vec, threads)
    r = runs.shape[0]
    m1 = np.full((n, r), -np.inf, np.float32)
    m2 = np.full((n, r), NEG, np.float32)
    i1 = np.full((n, r), INT_MAX, np.int64)
    for s in range(runs.shape[1]):
        idx = runs[:, s]
        live = idx >= 0
        x = np.where(live[None], v[:, np.maximum(idx, 0)], -np.inf).astype(np.float32)
        i1 = np.where(live[None] & (x > m1), idx[None], i1)  # top2_add, without a branch
        m2 = np.where(live[None], np.maximum(m2, np.minimum(x, m1)), m2)
        m1 = np.where(live[None], np.maximum(m1, x), m1)
    m1, i1, m2 = (a.reshape(n, -1, threads) for a in (m1, i1, m2))
    a1, ai, a2 = m1[:, 0], i1[:, 0], m2[:, 0]
    for a in range(1, m1.shape[1]):  # top2_merge
        o1, oi, o2 = m1[:, a], i1[:, a], m2[:, a]
        ai = np.where(o1 > a1, oi, np.where(o1 == a1, np.minimum(ai, oi), ai))
        a2 = np.maximum(np.maximum(a2, o2), np.minimum(a1, o1))
        a1 = np.maximum(a1, o1)
    if threads == LANES:
        return redux(a1, ai, a2, second)
    w1, wi, w2 = redux(*(a.reshape(n, -1, LANES) for a in (a1, ai, a2)))  # [n, 16] a warp each
    pad = LANES - w1.shape[1]
    w1 = np.concatenate([w1, np.full((n, pad), -np.inf, np.float32)], 1)
    wi = np.concatenate([wi.astype(np.int64), np.full((n, pad), INT_MAX, np.int64)], 1)
    w2 = np.concatenate([w2, np.full((n, pad), NEG, np.float32)], 1)
    return redux(w1, wi, w2, second)


class Block:
    """One problem as one thread block holds it."""

    def __init__(self, benefit, valid, rng, aligned=True):
        self.benefit = np.asarray(benefit, np.float32)
        p, o = self.benefit.shape
        self.vlist = np.nonzero(valid)[0]  # the ballot compaction: person order
        self.n_valid = len(self.vlist)
        self.vec = o % 4 == 0 and aligned
        self.rng = rng
        self.price = np.zeros(o, np.float32)
        self.holder = np.full(o, -1, np.int64)
        self.objv = np.full(self.n_valid, -1, np.int64)
        self.key = np.zeros((2, o), np.uint64)
        self.list = np.zeros((2, max(p, 1)), np.int64)
        self.list[0, :self.n_valid] = np.arange(self.n_valid)
        self.bobj = np.zeros((2, max(p, 1)), np.int64)
        self.cnt = [0, 0]
        self.par, self.n_prev = 0, 0

    def row(self, js):
        return self.benefit[self.vlist[js]]

    def restart(self):
        self.price[:] = 0
        self.holder[:] = -1
        self.objv[:] = -1
        self.list[self.par, :self.n_valid] = np.arange(self.n_valid)
        return self.n_valid

    def round(self, n_bid, eps) -> int:
        """One round, two barriers -> the next round's bidder count."""
        par = self.par
        # bid pass: the last round's keys cleared, this round's counter zeroed
        self.key[par ^ 1, self.bobj[par ^ 1, :self.n_prev]] = 0
        self.cnt[par] = 0
        assert not self.key[par].any(), "a key of an earlier round was left"
        cur = self.list[par, :n_bid].copy()
        v = self.row(cur) - self.price[None, :]
        v1, best, v2 = warp_top2(v, self.vec, threads=512 if n_bid == 1 else LANES)
        bid = (self.price[best] + (v1 - v2)) + np.float32(eps)
        assert bid.dtype == np.float32
        if n_bid == 1:  # a lone bidder takes its object at once, and writes no key
            j, o, push = int(cur[0]), int(best[0]), int(cur[0])
            if bid[0] > NEG / 2:
                push = int(self.holder[o])
                self.holder[o], self.objv[j], self.price[o] = j, o, bid[0]
                if push >= 0:
                    self.objv[push] = -1
            self.list[par ^ 1, 0] = push
            self.cnt[par] = int(push >= 0)
            self.n_prev, self.par = 0, par ^ 1
            return self.cnt[par]
        self.bobj[par, :n_bid] = best
        for i in self.rng.permutation(n_bid):  # the atomics' order is open
            k = max(int(self.key[par, best[i]]), order_key(bid[i], int(cur[i])))
            self.key[par, best[i]] = np.uint64(k)
        # resolution, a thread a bidder; each push's atomicAdd lands in an open order
        nxt = []
        for i in range(n_bid):
            j, o = int(cur[i]), int(best[i])
            if key_person(int(self.key[par, o])) == j and bid[i] > NEG / 2:
                old = int(self.holder[o])
                self.holder[o], self.objv[j], self.price[o] = j, o, bid[i]
                if old >= 0:
                    self.objv[old] = -1
                    nxt.append(old)
            else:
                nxt.append(j)
        nxt = [nxt[k] for k in self.rng.permutation(len(nxt))]
        self.list[par ^ 1, :len(nxt)] = nxt
        self.cnt[par] += len(nxt)
        self.n_prev, self.par = n_bid, par ^ 1
        return self.cnt[par]

    def fallback(self, n_bid):
        left = self.list[self.par, :n_bid]
        if len(left):
            free = np.where(self.holder[None] >= 0, NEG, self.row(left))
            _, o, _ = warp_top2(free, vec=False, second=False)
            self.objv[left] = o  # each on its own: two may take one object

    def obj_of(self):
        out = np.full(self.benefit.shape[0], -1, np.int64)
        out[self.vlist] = self.objv
        return out


def emulate(benefit, valid, max_iters=3000, eps_rel=1e-4, seed=0, aligned=True):
    """One problem as one thread block runs it -> (obj_of [P], rounds, bids,
    restarts)."""
    benefit = np.asarray(benefit, np.float32)
    blk = Block(benefit, valid, np.random.default_rng(seed), aligned)
    n_valid = blk.n_valid
    rows = blk.row(np.arange(n_valid))
    m = np.abs(rows).max() if n_valid else np.float32(0)
    scale = np.maximum(np.float32(m), np.float32(1e-6))
    eps = np.float32(eps_rel) * scale
    coarsest = scale / THETA
    cap = min(max_iters, 4 * n_valid + 64)
    it = best_n = last_prog = n_now = rounds = bids = restarts = 0
    n_bid = n_valid
    while True:
        stalled = it >= cap or it - last_prog >= 32
        if not (n_now < n_valid and (not stalled or eps <= coarsest)):
            break
        rounds += 1
        if stalled:
            restarts += 1
            eps = eps * THETA
            it = best_n = last_prog = 0
            n_bid = blk.restart()
        bids += n_bid
        n_bid = blk.round(n_bid, eps)
        n_now = n_valid - n_bid
        assert n_now == int((blk.objv >= 0).sum())  # the next list is every unassigned one
        it += 1
        if n_now > best_n:
            best_n, last_prog = n_now, it
    blk.fallback(n_bid)
    return blk.obj_of(), rounds, bids, restarts


def plain(benefit, valid, max_iters=3000):
    obj, rounds = lap._auction(torch.from_numpy(benefit)[None], torch.from_numpy(valid)[None],
                               max_iters, 1e-4)
    return obj[0].numpy(), rounds


def jax_single(benefit, valid, max_iters=3000):
    obj, _ = jax_auction(jnp.asarray(benefit), jnp.asarray(valid), max_iters=max_iters)
    return np.asarray(obj)


@pytest.mark.parametrize("seed,p,o", [(0, 12, 50), (1, 30, 90), (2, 5, 300)])
def test_lap_cases_batched(seed, p, o):
    """``tests/test_torch_lap.py``'s batches: the plain batch counts its
    largest problem's rounds, as K4's wrapper adds them to its counter."""
    rng = np.random.default_rng(seed)
    cost = rng.standard_normal((4, p, o)).astype(np.float32)
    valid = np.arange(p)[None, :] < np.asarray([p, p // 2, 1, 0])[:, None]
    ref = np.asarray(jax_batched(jnp.asarray(cost), jnp.asarray(valid)))
    got = [emulate(-cost[i], valid[i], seed=i) for i in range(4)]
    out, rounds = lap._auction(torch.from_numpy(-cost), torch.from_numpy(valid), 3000, 1e-4)
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), ref)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert rounds == max(g[1] for g in got)
    assert got[3][1] == 0 and (got[3][0] == -1).all()


def test_price_war_tied_rows():
    """Near-identical rows run the restart with a 64x coarser epsilon."""
    rng = np.random.default_rng(3)
    p, o = 40, 200
    base = rng.standard_normal((1, o)).astype(np.float32)
    cost = np.tile(base, (p, 1)) + 1e-5 * rng.standard_normal((p, o)).astype(np.float32)
    valid = np.ones(p, bool)
    obj, rounds, _, restarts = emulate(-cost, valid)
    ref_obj, ref_rounds = plain(-cost, valid)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds and restarts >= 1


def test_iteration_cap_greedy_fallback_collides():
    """A cap of 3 leaves the fallback work to do; the stragglers take the same
    best free object, each on its own. (No object 0 among the held ones, as
    ``tests/test_torch_lap.py`` explains.)"""
    p, o = 20, 60
    cost = np.zeros((p, o), np.float32)
    cost[:, 3::7] = -1.0
    valid = np.ones(p, bool)
    valid[-3:] = False
    obj, rounds, _, _ = emulate(-cost, valid, max_iters=3)
    ref_obj, ref_rounds = plain(-cost, valid, max_iters=3)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid, max_iters=3))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds
    held = obj[valid]
    assert len(set(held.tolist())) < len(held)  # collisions, as JAX has them
    assert (obj[~valid] == -1).all()


@pytest.mark.parametrize("n_valid", [16, 300], ids=["16-valid", "all-valid"])
def test_flagship_shapes(n_valid):
    """P 300 GT slots, O 900 queries: the bench's 16 valid, and every row."""
    rng = np.random.default_rng(n_valid)
    cost = rng.standard_normal((300, 900)).astype(np.float32)
    valid = np.arange(300) < n_valid
    obj, rounds, bids, _ = emulate(-cost, valid)
    ref_obj, ref_rounds = plain(-cost, valid)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds and bids >= n_valid
    assert len(set(obj[valid].tolist())) == n_valid


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "misaligned"])
def test_rows_not_a_multiple_of_16_bytes(aligned):
    """O 30: a row is 120 bytes, so no lane takes float4s; with O 32 a
    misaligned cost falls back to one run a lane too. P 20 with 17 valid, as
    phase 15 of chip_smoke.py runs it."""
    rng = np.random.default_rng(7)
    for o in (30, 32):
        cost = rng.standard_normal((20, o)).astype(np.float32)
        valid = np.arange(20) < 17
        obj, rounds, _, _ = emulate(-cost, valid, aligned=aligned)
        ref_obj, ref_rounds = plain(-cost, valid)
        np.testing.assert_array_equal(obj, jax_single(-cost, valid))
        np.testing.assert_array_equal(obj, ref_obj)
        assert rounds == ref_rounds


def test_negative_bids_on_a_hand_built_state():
    """Prices below zero make every bid negative; tied rows make bidders meet
    on one object, so the key's map of negative floats decides the winner.
    One round against the plain version's round on the same state."""
    rng = np.random.default_rng(5)
    p, o = 24, 70
    benefit = np.tile(rng.standard_normal((1, o)), (p, 1)).astype(np.float32)
    benefit[::2] += 1e-3 * rng.standard_normal((p // 2, o)).astype(np.float32)
    valid = np.ones(p, bool)
    valid[5] = False
    obj = np.full(p, -1, np.int64)
    obj[[1, 4, 7]] = [10, 11, 12]
    price = (-50.0 - rng.uniform(0, 5, o)).astype(np.float32)
    eps = np.float32(1e-3)
    want_obj, want_price = lap._bid_round(
        torch.from_numpy(np.where(valid[:, None], benefit, NEG))[None],
        torch.from_numpy(valid & (obj < 0))[None], torch.from_numpy(obj)[None],
        torch.from_numpy(price)[None], torch.tensor([eps]))
    cur = np.nonzero(valid & (obj < 0))[0]
    v1, best, v2 = warp_top2(benefit[cur] - price[None], vec=False)
    bids = (price[best] + (v1 - v2)) + eps
    assert (bids < 0).all() and len(set(best.tolist())) < len(cur)
    for seed in range(3):
        blk = Block(benefit, valid, np.random.default_rng(seed))
        jv = {q: j for j, q in enumerate(blk.vlist.tolist())}
        for q in (1, 4, 7):  # the hand-built holders
            blk.objv[jv[q]], blk.holder[obj[q]] = obj[q], jv[q]
        blk.price[:] = price
        unassigned = np.nonzero(blk.objv < 0)[0]
        blk.list[0, :len(unassigned)] = unassigned
        blk.round(len(unassigned), eps)
        np.testing.assert_array_equal(blk.obj_of(), want_obj[0].numpy())
        np.testing.assert_array_equal(blk.price, want_price[0].numpy())


def test_signed_zeros_tie_across_lanes():
    """-0 in lane 0 and +0 in lane 1 tie: the first index wins, as the plain
    version's argmax takes it, and v2 = v1 (the word map alone would order
    +0 above -0)."""
    v = np.zeros((1, 64), np.float32)
    v[0, 0] = -0.0
    v[0, 2:] = -1.0
    for vec in (False, True):
        for threads in (LANES, 512):  # a warp's scan, and the block's for a lone bidder
            v1, best, v2 = warp_top2(v, vec, threads=threads)
            assert best[0] == 0 and v1[0] == 0 and v2[0] == 0
    assert int(torch.tensor(v).argmax(1)) == 0


def test_order_key_orders_floats_and_breaks_ties_by_person():
    vals = np.asarray([-np.inf, -1e30, -3.5, -1e-20, 0.0, 1e-20, 2.0, 1e30, np.inf],
                      np.float32)
    keys = [order_key(v, 7) for v in vals]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert order_key(np.float32(-2.0), 3) > order_key(np.float32(-2.0), 4)
    assert all(key_person(order_key(np.float32(1.5), q)) == q for q in (0, 299))
    np.testing.assert_array_equal(order_float(order_bits(vals)), vals)


def test_no_valid_person():
    cost = np.random.default_rng(6).standard_normal((7, 30)).astype(np.float32)
    valid = np.zeros(7, bool)
    obj, rounds, bids, restarts = emulate(-cost, valid)
    ref_obj, ref_rounds = plain(-cost, valid)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds == bids == restarts == 0 and (obj == -1).all()


@pytest.mark.parametrize("p,n_valid,o", [(3, 2, 1), (9, 5, 3), (40, 33, 513)],
                         ids=["one-object", "O3", "O513"])
def test_few_objects_and_odd_widths(p, n_valid, o):
    """One object (v2 is -1e30 for every bidder, so two bidders meet on it
    until the cap, and the fallback lets the loser collide), three objects,
    and rows of 513 floats, correlated so that a restart and many rounds of
    a lone bidder run: its 512 threads leave one object to thread 0's second
    step."""
    rng = np.random.default_rng(o)
    cost = (rng.standard_normal((1, o)) + 0.1 * rng.standard_normal((p, o))).astype(np.float32)
    valid = np.zeros(p, bool)
    valid[rng.permutation(p)[:n_valid]] = True
    obj, rounds, bids, _ = emulate(-cost, valid)
    ref_obj, ref_rounds = plain(-cost, valid)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds and bids >= n_valid
    assert (obj[valid] >= 0).all() and (obj[~valid] == -1).all()


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrapper's
    kernel path without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_wrapper_refuses_before_launching(monkeypatch):
    """K4 keeps a problem's state in one block's shared memory and takes a
    bool mask: a CUDA call that breaks either raises before any build or
    launch; one that keeps both goes on to the launch."""

    def no_launch(*args):
        raise AssertionError("kernel launch reached")

    monkeypatch.setattr(lap, "_auction_cuda", no_launch)
    before = lap.batched_min_cost_assignment.launches

    def on_card(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta").as_subclass(_OnCard)

    assert on_card(1).device.type == "cuda"
    with pytest.raises(ValueError, match="shared memory"):
        lap.batched_min_cost_assignment(on_card(2, 300, 20_000), on_card(2, 300, dtype=torch.bool))
    with pytest.raises(TypeError, match="bool"):
        lap.batched_min_cost_assignment(on_card(2, 300, 900), on_card(2, 300))
    with pytest.raises(ValueError, match=r"cost \[B, P, O\]"):
        lap.batched_min_cost_assignment(on_card(2, 300, 900), on_card(2, 299, dtype=torch.bool))
    with pytest.raises(AssertionError, match="kernel launch reached"):
        lap.batched_min_cost_assignment(on_card(2, 300, 900), on_card(2, 300, dtype=torch.bool))
    with pytest.raises(AssertionError, match="kernel launch reached"):
        lap.auction_assignment(on_card(300, 900), on_card(300, dtype=torch.bool))
    assert lap.batched_min_cost_assignment.launches == before
    assert lap.smem_bytes(300, 900) <= lap.SMEM_LIMIT < lap.smem_bytes(300, 20_000)
