"""How K4 (``richsem_tpu_torch/csrc/auction.cu``) splits the auction, emulated
on the CPU and held to the JAX ``auction_assignment`` (jitted on the CPU) and
to the port's plain ``_auction``, bit for bit on the assignment and with the
same rounds.

The emulation does what one thread block does for one problem: only the
valid bidders' rows are read; a bidder's row is cut into 32 lanes (lane l
takes objects l, l+32, ...), each lane keeps its largest value with its first
index and the largest of the rest (-1e30 when there is none), and the lanes
merge in the kernel's xor-shuffle tree, so that the first maximum wins and a
tie elsewhere gives v2 = v1; the bid is (price + (v1 - v2)) + eps in float32;
each bid becomes a 64-bit key (the float's bits mapped to an order-preserving
word, negative floats too, over ~person) applied by max in a shuffled order;
a person per thread resolves; the greedy fallback lets two persons take the
same object. Lists of valid persons and bidders are shuffled, as the kernel's
atomics leave their order open.

Cases: ``tests/test_torch_lap.py``'s, P 300 with 16 valid and every row valid
at O 900, a negative bid reached through negative prices on a hand-built
state (one round against the plain version's round), and a problem with no
valid person. Last, the CUDA wrapper's refusals, reached on a meta tensor that
reports a CUDA device, before any launch.
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
LANES = 32


def order_key(bid: np.float32, person: int) -> int:
    """The kernel's 64-bit key: the bid's bits mapped so that unsigned order is
    float order (negative floats reversed), over ~person (the lowest person
    wins a tie)."""
    u = int(np.float32(bid).view(np.uint32))
    hi = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (hi << 32) | (~person & 0xFFFFFFFF)


def key_person(k: int) -> int:
    return ~k & 0xFFFFFFFF


def lane_top2(v: np.ndarray, second: bool = True):
    """v [n, O] f32 -> lane 0's (v1, first index, v2) after the shuffle tree."""
    n, o = v.shape
    steps = -(-o // LANES)
    lanes = np.full((n, steps * LANES), -np.inf, np.float32)
    lanes[:, :o] = v
    lanes = lanes.reshape(n, steps, LANES)  # object = step * 32 + lane
    m1 = lanes.max(1)
    first = lanes.argmax(1)
    i1 = first * LANES + np.arange(LANES)
    i1 = np.where(i1 < o, i1, INT_MAX)  # a lane with no object keeps its start values
    rest = lanes.copy()
    np.put_along_axis(rest, first[:, None, :], -np.inf, axis=1)
    m2 = np.maximum(rest.max(1), NEG) if second else np.full_like(m1, NEG)
    for off in (16, 8, 4, 2, 1):
        partner = np.arange(LANES) ^ off
        om1, oi1, om2 = m1[:, partner], i1[:, partner], m2[:, partner]
        take = (om1 > m1) | ((om1 == m1) & (oi1 < i1))
        m2 = np.where(take, np.maximum(om2, m1), np.maximum(m2, om1))
        m1, i1 = np.where(take, om1, m1), np.where(take, oi1, i1)
    return m1[:, 0], i1[:, 0], m2[:, 0]


def bid_round(benefit, valid, obj, price, eps, rng):
    """One round as the block runs it -> (obj, price, bids of the round)."""
    obj, price = obj.copy(), price.copy()
    cur = rng.permutation(np.nonzero(valid & (obj < 0))[0])
    v = benefit[cur] - price[None, :]
    v1, best, v2 = lane_top2(v)
    bid = (price[best] + (v1 - v2)) + eps
    assert bid.dtype == np.float32
    key = {}
    for j in rng.permutation(len(cur)):  # the atomics' order is open
        key[best[j]] = max(key.get(best[j], 0), order_key(bid[j], int(cur[j])))
    bidv = dict(zip(cur.tolist(), bid.tolist()))
    best_of = dict(zip(cur.tolist(), best.tolist()))
    for q in range(len(obj)):  # a thread a person
        if not valid[q]:
            continue
        if obj[q] < 0:
            ob = best_of[q]
            if key_person(key[ob]) == q and bidv[q] > NEG / 2:
                obj[q] = ob
                price[ob] = bidv[q]
        elif obj[q] in key and bidv[key_person(key[obj[q]])] > NEG / 2:
            obj[q] = -1
    return obj, price, len(cur)


def emulate(benefit, valid, max_iters=3000, eps_rel=1e-4, seed=0):
    """One problem as one thread block runs it -> (obj_of [P], rounds, bids,
    restarts)."""
    rng = np.random.default_rng(seed)
    benefit = np.asarray(benefit, np.float32)
    p, o = benefit.shape
    vlist = np.nonzero(valid)[0]
    n_valid = len(vlist)
    m = np.abs(benefit[vlist]).max() if n_valid else np.float32(0)
    scale = np.maximum(np.float32(m), np.float32(1e-6))
    eps = np.float32(eps_rel) * scale
    coarsest = scale / THETA
    cap = min(max_iters, 4 * n_valid + 64)
    obj = np.full(p, -1, np.int64)
    price = np.zeros(o, np.float32)
    it = best_n = last_prog = n_now = rounds = bids = restarts = 0
    while True:
        stalled = it >= cap or it - last_prog >= 32
        if not (n_now < n_valid and (not stalled or eps <= coarsest)):
            break
        rounds += 1
        if stalled:
            restarts += 1
            eps = eps * THETA
            it = best_n = last_prog = 0
            obj[:] = -1
            price[:] = 0
        obj, price, n_bid = bid_round(benefit, valid, obj, price, eps, rng)
        bids += n_bid
        n_now = int((valid & (obj >= 0)).sum())
        it += 1
        if n_now > best_n:
            best_n, last_prog = n_now, it
    left = rng.permutation(np.nonzero(valid & (obj < 0))[0])
    if len(left):
        taken = np.zeros(o, bool)
        taken[obj[obj >= 0]] = True
        _, greedy, _ = lane_top2(np.where(taken[None], NEG, benefit[left]), second=False)
        obj[left] = greedy  # each on its own: two may take one object
    return obj, rounds, bids, restarts


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
    v1, best, v2 = lane_top2(benefit[cur] - price[None])
    bids = (price[best] + (v1 - v2)) + eps
    assert (bids < 0).all() and len(set(best.tolist())) < len(cur)
    for seed in range(3):
        got_obj, got_price, _ = bid_round(benefit, valid, obj, price, eps,
                                          np.random.default_rng(seed))
        np.testing.assert_array_equal(got_obj, want_obj[0].numpy())
        np.testing.assert_array_equal(got_price, want_price[0].numpy())


def test_order_key_orders_floats_and_breaks_ties_by_person():
    vals = np.asarray([-np.inf, -1e30, -3.5, -1e-20, 0.0, 1e-20, 2.0, 1e30, np.inf],
                      np.float32)
    keys = [order_key(v, 7) for v in vals]
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert order_key(np.float32(-2.0), 3) > order_key(np.float32(-2.0), 4)
    assert all(key_person(order_key(np.float32(1.5), q)) == q for q in (0, 299))


def test_no_valid_person():
    cost = np.random.default_rng(6).standard_normal((7, 30)).astype(np.float32)
    valid = np.zeros(7, bool)
    obj, rounds, bids, restarts = emulate(-cost, valid)
    ref_obj, ref_rounds = plain(-cost, valid)
    np.testing.assert_array_equal(obj, jax_single(-cost, valid))
    np.testing.assert_array_equal(obj, ref_obj)
    assert rounds == ref_rounds == bids == restarts == 0 and (obj == -1).all()


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrapper's
    kernel path without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_wrapper_refuses_before_launching(monkeypatch):
    """K4 keeps a problem in one block's shared memory and takes a bool mask:
    a CUDA call that breaks either raises before any build or launch; one that
    keeps both goes on to the launch."""

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
