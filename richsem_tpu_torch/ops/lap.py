"""Batched linear assignment by auction (counterpart of ``richsem_tpu/ops/lap.py``).

The same algorithm, step for step, as the JAX ``auction_assignment``
(``lap.py:57-232``), so that identical float32 costs give identical
assignments: persons (GT boxes, padded, with a validity mask) bid in parallel
for objects (queries); each object goes to its highest bid, and among equal
bids to the lowest person index (``lap.py:105-117``); an attempt that stalls
(no new assignment for 32 rounds, or more than ``4 * n_valid + 64`` rounds)
restarts from zero prices with a 64x coarser epsilon; whoever is still
unassigned after the coarsest attempt takes its best free object greedily.

The JAX version vmaps a ``while_loop`` over the batch; here the batch is a
leading dimension and each element's state freezes once its own condition is
false, which is what the vmapped loop does. The loop is host-driven: each
round reads one flag (whether any element still runs) from the device.
``batched_min_cost_assignment.rounds`` counts the rounds run.
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG_INF = -1e30


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, O] at idx [B, P] -> [B, P]."""
    return torch.gather(x, 1, idx)


def _auction(benefit: torch.Tensor, person_valid: torch.Tensor, max_iters: int,
             eps_rel: float) -> Tuple[torch.Tensor, int]:
    """benefit [B, P, O] f32, person_valid [B, P] -> (obj_of [B, P], rounds)."""
    bsz, p, o = benefit.shape
    dev = benefit.device
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    benefit = torch.where(person_valid[..., None], benefit.float(), neg)
    scale = torch.where(person_valid[..., None], benefit.abs(), benefit.new_zeros(()))
    scale = scale.amax(dim=(1, 2)).clamp(min=1e-6)  # [B]
    person_ids = torch.arange(p, device=dev)
    obj_ids = torch.arange(o, device=dev)
    n_valid = person_valid.sum(1)
    attempt_cap = torch.clamp(4 * n_valid + 64, max=max_iters)
    theta = 64.0

    obj_of = torch.full((bsz, p), -1, dtype=torch.long, device=dev)
    price = torch.zeros((bsz, o), dtype=torch.float32, device=dev)
    eps = eps_rel * scale
    it = torch.zeros(bsz, dtype=torch.long, device=dev)
    best_n = torch.zeros_like(it)
    last_prog = torch.zeros_like(it)

    def stalled(it, last_prog):
        return (it >= attempt_cap) | (it - last_prog >= 32)

    rounds = 0
    while True:
        unassigned = (person_valid & (obj_of < 0)).any(1)
        running = unassigned & (~stalled(it, last_prog) | (eps <= scale / theta))
        if not bool(running.any()):
            break
        rounds += 1
        # restart-coarser escalation
        restart = stalled(it, last_prog)
        n_eps = torch.where(restart, eps * theta, eps)
        n_price = torch.where(restart[:, None], price.new_zeros(()), price)
        n_obj = torch.where(restart[:, None], obj_of.new_full((), -1), obj_of)
        n_it = torch.where(restart, 0, it)
        n_best = torch.where(restart, 0, best_n)
        n_last = torch.where(restart, 0, last_prog)
        # one bidding round
        bidders = person_valid & (n_obj < 0)
        v_masked = torch.where(bidders[..., None], benefit - n_price[:, None, :], neg)
        v1 = v_masked.amax(dim=2)
        best_obj = v_masked.argmax(dim=2)  # first maximum, as jnp.argmax
        best_mask = obj_ids[None, None, :] == best_obj[..., None]
        v2 = torch.where(best_mask, neg, v_masked).amax(dim=2)
        bid = torch.where(bidders, _gather(n_price, best_obj) + (v1 - v2) + n_eps[:, None], neg)
        bid_mat = torch.where(best_mask & bidders[..., None], bid[..., None], neg)
        obj_best_bid = bid_mat.amax(dim=1)  # [B, O]
        contested = obj_best_bid > _NEG_INF / 2
        winner_mat = torch.where(bid_mat >= obj_best_bid[:, None, :],
                                 person_ids[None, :, None], p)
        winner_of_obj = torch.where(contested[:, None, :], winner_mat, p).amin(dim=1)
        cur = n_obj.clamp(min=0)
        evicted = ((n_obj >= 0) & _gather(contested, cur)
                   & (_gather(winner_of_obj, cur) != person_ids))
        n_obj = torch.where(evicted, -1, n_obj)
        won = (bidders & _gather(contested, best_obj)
               & (_gather(winner_of_obj, best_obj) == person_ids))
        n_obj = torch.where(won, best_obj, n_obj)
        n_price = torch.where(contested, obj_best_bid, n_price)
        n_it = n_it + 1
        n_now = (person_valid & (n_obj >= 0)).sum(1)
        progressed = n_now > n_best
        n_best = torch.maximum(n_best, n_now)
        n_last = torch.where(progressed, n_it, n_last)
        # elements whose loop has ended keep their state
        obj_of = torch.where(running[:, None], n_obj, obj_of)
        price = torch.where(running[:, None], n_price, price)
        eps = torch.where(running, n_eps, eps)
        it = torch.where(running, n_it, it)
        best_n = torch.where(running, n_best, best_n)
        last_prog = torch.where(running, n_last, last_prog)

    # greedy fallback for whoever the coarsest attempt left unassigned
    unassigned = person_valid & (obj_of < 0)
    taken = (obj_ids[None, None, :] == obj_of[..., None]).any(1)
    greedy = torch.where(taken[:, None, :], neg, benefit).argmax(dim=2)
    obj_of = torch.where(unassigned, greedy, obj_of)
    return obj_of, rounds


def auction_assignment(benefit: torch.Tensor, person_valid: torch.Tensor,
                       max_iters: int = 3000, eps_rel: float = 1e-4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize ``sum(benefit[p, obj_of[p]])`` for one ``[P, O]`` problem ->
    (``obj_of [P]`` int64, -1 for invalid persons; realized benefit ``[P]``,
    0 for invalid)."""
    obj_of, rounds = _auction(benefit[None], person_valid[None], max_iters, eps_rel)
    batched_min_cost_assignment.rounds += rounds
    obj_of = obj_of[0]
    b = torch.where(person_valid[:, None], benefit.float(), benefit.new_tensor(_NEG_INF))
    realized = torch.where(obj_of >= 0, b.gather(1, obj_of.clamp(min=0)[:, None])[:, 0],
                           b.new_zeros(()))
    return obj_of, realized


def batched_min_cost_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                                max_iters: int = 3000, eps_rel: float = 1e-4
                                ) -> torch.Tensor:
    """Minimize cost over a batch: ``cost [B, P, O]``, ``row_valid [B, P]`` ->
    column per row ``[B, P]`` (-1 where invalid)."""
    obj_of, rounds = _auction(-cost, row_valid, max_iters, eps_rel)
    batched_min_cost_assignment.rounds += rounds
    return obj_of


batched_min_cost_assignment.rounds = 0  # auction rounds run; chip_smoke.py reads it


def greedy_assignment(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Row-argmin matcher, collisions allowed (``SimpleMinsumMatcher``)."""
    idx = torch.where(row_valid[..., None], cost, cost.new_tensor(float("inf"))).argmin(-1)
    return torch.where(row_valid, idx, -1)
