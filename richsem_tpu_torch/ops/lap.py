"""Batched linear assignment by auction (counterpart of ``richsem_tpu/ops/lap.py``).

The same algorithm, step for step, as the JAX ``auction_assignment``
(``lap.py:57-232``), so that identical float32 costs give identical
assignments: persons (GT boxes, padded, with a validity mask) bid in parallel
for objects (queries); each object goes to its highest bid, and among equal
bids to the lowest person index (``lap.py:105-117``); an attempt that stalls
(no new assignment for 32 rounds, or more than ``4 * n_valid + 64`` rounds)
restarts from zero prices with a 64x coarser epsilon; whoever is still
unassigned after the coarsest attempt takes its best free object greedily.

* On CUDA tensors the whole loop is one launch of the hand-written kernel K4
  (``csrc/auction.cu``), one thread block a problem, as the JAX
  ``while_loop`` runs on the device inside the jitted step: nothing is read
  on the host. Each launch adds one to ``batched_min_cost_assignment.launches``
  and the batch's largest round count (what the plain loop counts) to the
  device counter :func:`device_rounds` (an int64 tensor on that device), which
  a caller reads after its own synchronise.
* On CPU tensors :func:`_auction` runs, the plain version: the batch is a
  leading dimension and each element's state freezes once its own condition
  is false, which is what the vmapped loop does. Its loop is host-driven (it
  reads whether any element still runs every round) and adds its rounds to
  ``batched_min_cost_assignment.rounds``.

:func:`scipy_assignment` is ``HungarianMatcherCPU``'s exact solver: SciPy's
``linear_sum_assignment`` on a host copy of the cost, as JAX's
``pure_callback`` runs it (``lap.py:243-270``). Its host read cannot sit in a
CUDA graph: it raises while the current stream captures.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from richsem_tpu_torch.ops import _build

_NEG_INF = -1e30


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, O] at idx [B, P] -> [B, P]."""
    return torch.gather(x, 1, idx)


def _bid_round(benefit: torch.Tensor, bidders: torch.Tensor, obj_of: torch.Tensor,
               price: torch.Tensor, eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bidding round of the plain version (JAX ``lap.py:92-136``) over a
    batch, with dense masked reductions: ``benefit [B, P, O]`` f32 (-1e30 on
    invalid rows), ``bidders [B, P]``, ``obj_of [B, P]``, ``price [B, O]``,
    ``eps [B]`` -> (obj_of, price)."""
    p, o = benefit.shape[1:]
    neg = _NEG_INF  # a Python scalar takes the tensors' float32
    person_ids = torch.arange(p, device=benefit.device)
    obj_ids = torch.arange(o, device=benefit.device)
    v_masked = torch.where(bidders[..., None], benefit - price[:, None, :], neg)
    v1 = v_masked.amax(dim=2)
    best_obj = v_masked.argmax(dim=2)  # first maximum, as jnp.argmax
    best_mask = obj_ids[None, None, :] == best_obj[..., None]
    v2 = torch.where(best_mask, neg, v_masked).amax(dim=2)
    bid = torch.where(bidders, _gather(price, best_obj) + (v1 - v2) + eps[:, None], neg)
    bid_mat = torch.where(best_mask & bidders[..., None], bid[..., None], neg)
    obj_best_bid = bid_mat.amax(dim=1)  # [B, O]
    contested = obj_best_bid > _NEG_INF / 2
    winner_mat = torch.where(bid_mat >= obj_best_bid[:, None, :], person_ids[None, :, None], p)
    winner_of_obj = torch.where(contested[:, None, :], winner_mat, p).amin(dim=1)
    cur = obj_of.clamp(min=0)
    evicted = ((obj_of >= 0) & _gather(contested, cur)
               & (_gather(winner_of_obj, cur) != person_ids))
    obj_of = torch.where(evicted, -1, obj_of)
    won = (bidders & _gather(contested, best_obj)
           & (_gather(winner_of_obj, best_obj) == person_ids))
    obj_of = torch.where(won, best_obj, obj_of)
    return obj_of, torch.where(contested, obj_best_bid, price)


def _auction(benefit: torch.Tensor, person_valid: torch.Tensor, max_iters: int,
             eps_rel: float) -> Tuple[torch.Tensor, int]:
    """benefit [B, P, O] f32, person_valid [B, P] -> (obj_of [B, P], rounds)."""
    bsz, p, o = benefit.shape
    dev = benefit.device
    neg = torch.tensor(_NEG_INF, dtype=torch.float32, device=dev)
    benefit = torch.where(person_valid[..., None], benefit.float(), neg)
    scale = torch.where(person_valid[..., None], benefit.abs(), benefit.new_zeros(()))
    scale = scale.amax(dim=(1, 2)).clamp(min=1e-6)  # [B]
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
        n_obj, n_price = _bid_round(benefit, person_valid & (n_obj < 0), n_obj, n_price, n_eps)
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


_K4 = "auction"
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
_WARPS = 16  # K4's block: 512 threads


def smem_bytes(p: int, o: int) -> int:
    """K4's shared memory for ``p`` persons and ``o`` objects: two keys, a
    price and a holder an object, seven words a person, a warp's top-2 and the
    block's counters (``auction.cu``'s ``smem_bytes``, checked here before any
    build or launch)."""
    return o * 24 + p * 28 + (3 * _WARPS + 2) * 4


_DEVICE_ROUNDS: Dict[torch.device, torch.Tensor] = {}


def device_rounds(device) -> torch.Tensor:
    """K4's round counter on ``device``: an int64 scalar tensor to which each
    launch adds its batch's largest round count. Read it after a synchronise;
    ``zero_()`` it to start a count."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _DEVICE_ROUNDS:
        _DEVICE_ROUNDS[device] = torch.zeros((), dtype=torch.int64, device=device)
    return _DEVICE_ROUNDS[device]


def _lib() -> ctypes.CDLL:
    lib = _build.load(_K4)
    if lib.auction.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.auction.argtypes = [ptr] * 4 + [i32] * 5 + [ctypes.c_float, ptr]
        lib.auction.restype = ctypes.c_int
    return lib


def _check_cuda(cost: torch.Tensor, valid: torch.Tensor) -> None:
    if cost.dim() != 3 or valid.shape != cost.shape[:2]:
        raise ValueError(f"K4 takes cost [B, P, O] and valid [B, P], got "
                         f"{tuple(cost.shape)} and {tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"K4 takes a bool validity mask, got {valid.dtype}")
    if cost.device != valid.device:
        raise ValueError("cost and valid must share a device")
    b, p, o = cost.shape
    if o < 1:
        raise ValueError("K4 needs at least one object")
    if smem_bytes(p, o) > SMEM_LIMIT:
        raise ValueError(f"K4 keeps a problem in one block's shared memory: P {p} and O {o} "
                         f"need {smem_bytes(p, o)} bytes, more than {SMEM_LIMIT}")


def _auction_cuda(cost: torch.Tensor, valid: torch.Tensor, negate: bool, max_iters: int,
                  eps_rel: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: -> (obj_of [B, P] int64, stats [B, 2] int32: each problem's rounds
    and bids). ``cost`` [B, P, O] is the benefit, negated when ``negate``."""
    b, p, o = cost.shape
    cost = cost.float().contiguous()
    valid = valid.contiguous()
    obj_of = torch.empty((b, p), dtype=torch.int64, device=cost.device)
    stats = torch.empty((b, 2), dtype=torch.int32, device=cost.device)
    if b * p == 0:
        return obj_of, stats.zero_()
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().auction(cost.data_ptr(), valid.data_ptr(), obj_of.data_ptr(),
                             stats.data_ptr(), b, p, o, int(negate), max_iters, eps_rel, stream)
    if err != 0:
        raise RuntimeError(f"K4 auction launch failed: CUDA error {err}")
    batched_min_cost_assignment.launches += 1
    device_rounds(cost.device).add_(stats[:, 0].amax())
    return obj_of, stats


def _solve(cost: torch.Tensor, valid: torch.Tensor, negate: bool, max_iters: int,
           eps_rel: float) -> torch.Tensor:
    """K4 on a CUDA tensor, the plain version on a CPU one; -> obj_of [B, P]."""
    if cost.device.type == "cpu":
        obj_of, rounds = _auction(-cost if negate else cost, valid, max_iters, eps_rel)
        batched_min_cost_assignment.rounds += rounds
        return obj_of
    if cost.device.type != "cuda":
        raise RuntimeError(f"auction: no kernel for device {cost.device}")
    _check_cuda(cost, valid)
    return _auction_cuda(cost, valid, negate, max_iters, eps_rel)[0]


def auction_assignment(benefit: torch.Tensor, person_valid: torch.Tensor,
                       max_iters: int = 3000, eps_rel: float = 1e-4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Maximize ``sum(benefit[p, obj_of[p]])`` for one ``[P, O]`` problem ->
    (``obj_of [P]`` int64, -1 for invalid persons; realized benefit ``[P]``,
    0 for invalid). K4 on a CUDA tensor, the plain version on a CPU one."""
    obj_of = _solve(benefit[None], person_valid[None], False, max_iters, eps_rel)[0]
    b = torch.where(person_valid[:, None], benefit.float(), _NEG_INF)
    realized = torch.where(obj_of >= 0, b.gather(1, obj_of.clamp(min=0)[:, None])[:, 0], 0.0)
    return obj_of, realized


def batched_min_cost_assignment(cost: torch.Tensor, row_valid: torch.Tensor,
                                max_iters: int = 3000, eps_rel: float = 1e-4
                                ) -> torch.Tensor:
    """Minimize cost over a batch: ``cost [B, P, O]``, ``row_valid [B, P]`` ->
    column per row ``[B, P]`` (-1 where invalid). K4 on CUDA tensors, the
    plain version on CPU ones."""
    return _solve(cost, row_valid, True, max_iters, eps_rel)


batched_min_cost_assignment.launches = 0  # K4 launches (either entry point)
batched_min_cost_assignment.rounds = 0  # the plain version's rounds (CPU tensors)


def greedy_assignment(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Row-argmin matcher, collisions allowed (``SimpleMinsumMatcher``)."""
    idx = torch.where(row_valid[..., None], cost, float("inf")).argmin(-1)
    return torch.where(row_valid, idx, -1)


@torch.no_grad()
def scipy_assignment(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """Exact min-cost assignment on the host: ``cost [B, P, O]``, ``row_valid
    [B, P]`` -> column per row ``[B, P]`` on ``cost``'s device (-1 where
    invalid), each image's valid rows through ``linear_sum_assignment``."""
    from scipy.optimize import linear_sum_assignment

    if cost.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("HungarianMatcherCPU reads the cost on the host, which a CUDA graph "
                           "cannot hold: take this step eagerly")
    c = cost.float().cpu().numpy()
    valid = row_valid.cpu().numpy()
    out = np.full(c.shape[:2], -1, np.int64)
    for b in range(c.shape[0]):
        rows = np.nonzero(valid[b])[0]
        if len(rows):
            r, col = linear_sum_assignment(c[b, rows])
            out[b, rows[r]] = col
    return torch.from_numpy(out).to(cost.device)
