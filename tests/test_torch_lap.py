"""The port's auction assignment held against the JAX package's: on identical
float32 costs it must give the same assignments (an epsilon-optimal but
different assignment would change the losses), and reach scipy's optimum
where the JAX one does.

Cases: random costs over a padded batch with varied valid counts, the
price-war tied rows of ``tests/test_lap.py`` (which run the restart with a
64x coarser epsilon), an iteration cap small enough to leave the greedy
fallback work to do, and the row-argmin matcher.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from richsem_tpu.ops.lap import auction_assignment as jax_auction
from richsem_tpu.ops.lap import batched_min_cost_assignment as jax_batched
from richsem_tpu.ops.lap import greedy_assignment as jax_greedy
from richsem_tpu_torch.ops import lap


def _opt_cost(cost, valid):
    rows = np.nonzero(valid)[0]
    r, c = linear_sum_assignment(cost[rows])
    return cost[rows[r], c].sum()


@pytest.mark.parametrize("seed,p,o", [(0, 12, 50), (1, 30, 90), (2, 5, 300)])
def test_batched_assignments_match_jax_and_scipy(seed, p, o):
    rng = np.random.default_rng(seed)
    b = 4
    cost = rng.standard_normal((b, p, o)).astype(np.float32)
    valid = np.arange(p)[None, :] < np.asarray([p, p // 2, 1, 0])[:, None]
    ref = np.asarray(jax_batched(jnp.asarray(cost), jnp.asarray(valid)))
    before = lap.batched_min_cost_assignment.rounds
    out = lap.batched_min_cost_assignment(torch.from_numpy(cost), torch.from_numpy(valid))
    assert lap.batched_min_cost_assignment.rounds > before
    np.testing.assert_array_equal(out.numpy(), ref)
    for i in range(b):
        if valid[i].any():
            rows = np.nonzero(valid[i])[0]
            assert len(set(out[i, rows].tolist())) == len(rows)  # one-to-one
            got = cost[i, rows, out[i, rows].numpy()].sum()
            assert got - _opt_cost(cost[i], valid[i]) <= len(rows) * 1e-4 * np.abs(cost[i]).max()
    assert (out.numpy()[~valid] == -1).all()


def test_price_war_tied_rows_match_jax():
    """Near-identical rows: the fixed-epsilon attempt stalls and restarts
    coarser; the port must walk the same escalation."""
    rng = np.random.default_rng(3)
    p, o = 40, 200
    base = rng.standard_normal((1, o)).astype(np.float32)
    cost = np.tile(base, (p, 1)) + 1e-5 * rng.standard_normal((p, o)).astype(np.float32)
    valid = np.ones(p, bool)
    ref_obj, ref_ben = jax_auction(jnp.asarray(-cost), jnp.asarray(valid))
    obj, ben = lap.auction_assignment(torch.from_numpy(-cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(obj.numpy(), np.asarray(ref_obj))
    np.testing.assert_array_equal(ben.numpy(), np.asarray(ref_ben))
    assert len(set(obj.tolist())) == p
    got = cost[np.arange(p), obj.numpy()].sum()
    opt = _opt_cost(cost, valid)
    assert got - opt < 0.05 * abs(opt) + 0.5  # the bound of tests/test_lap.py


def test_iteration_cap_greedy_fallback_matches_jax():
    """No object 0 among the held ones: JAX marks held objects with a scatter
    in which every unassigned person also writes False at index 0
    (``lap.py:210``), so whether a held object 0 counts as taken depends on
    the order duplicate scatter indices are applied in. The port marks
    exactly the held objects."""
    p, o = 20, 60
    cost = np.zeros((p, o), np.float32)  # fully degenerate ties
    cost[:, 3::7] = -1.0
    valid = np.ones(p, bool)
    valid[-3:] = False
    ref_obj, _ = jax_auction(jnp.asarray(-cost), jnp.asarray(valid), max_iters=3)
    obj, _ = lap.auction_assignment(torch.from_numpy(-cost), torch.from_numpy(valid),
                                    max_iters=3)
    np.testing.assert_array_equal(obj.numpy(), np.asarray(ref_obj))
    assert (obj.numpy()[valid] >= 0).all() and (obj.numpy()[~valid] == -1).all()


def test_greedy_assignment_matches_jax():
    rng = np.random.default_rng(4)
    cost = rng.standard_normal((3, 6, 9)).astype(np.float32)
    valid = rng.uniform(size=(3, 6)) < 0.6
    ref = np.asarray(jax_greedy(jnp.asarray(cost), jnp.asarray(valid)))
    out = lap.greedy_assignment(torch.from_numpy(cost), torch.from_numpy(valid))
    np.testing.assert_array_equal(out.numpy(), ref)
