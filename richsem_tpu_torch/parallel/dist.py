"""Data parallelism: one process a card (counterpart of ``richsem_tpu/parallel/mesh.py``
and of the multi-process parts of ``richsem_tpu/train/main.py``).

The JAX package puts a ``("data", "model")`` mesh under one jit: the batch is
sharded over ``data``, the parameters are replicated and XLA inserts the
gradient all-reduce. The port takes the reference's layout (its
``main.py:204-206``): one process a card, started by ``torchrun`` (or
:func:`spawn`), a process group over NCCL on the card and over gloo on the
CPU, and every rank holding the whole model and stepping on its own
``cfg.batch_size`` images.

**The rule.** The ranks' batches, stacked in rank order, are the global batch
of JAX's step; ranks may hold other canvases, as JAX's processes may. Every
quantity that JAX computes over the global batch inside its jit is global
here too:

* The batch statistics that the loss reads (:data:`STAT_KEYS`: the count of
  valid GT boxes, the largest count in one image, the GT classes that appear,
  those of them that CDN's positive queries hold, whether any image is an
  extra one) are reduced over the ranks on the host
  before the step (:func:`step_stats`, one small gloo collective), from the
  numpy batch, so that reading them synchronises nothing. They ride in the
  batch as tensors.
* Where the teacher's weak labels rewrite the extra images' labels and boxes
  on the card (``use_imagenet_pusedo_labels``), the statistics are those of
  the rewritten batch, which the host never sees: each rank computes them
  from its rewritten tensors (:func:`tensor_stats`) and one collective in the
  step (:data:`reduce_stats_`, captured in the train graph) gathers the
  ranks' int32 rows and reduces them on the card with the sums, maxima and
  unions of :func:`step_stats`. JAX computes them in its one jitted program
  over the sharded batch (``richsem_tpu/train/engine.py:108-127``).
* Each batch-global normaliser is its global value divided by N, the
  reference's way (``num_boxes / world_size``): the mean over the ranks of
  their losses equals, term by term, the JAX loss on the global batch.
  Normalisers over a rank's own images (``b * nq``, a mean over images) stay
  as they are, since every rank holds ``b`` images.
* The update uses the gradient of that mean: one all-reduce a step
  (:data:`average_`) averages every gradient that the optimizer's global norm
  reads, the FrozenBN buffers' included, and with them the step's metrics, so
  that the logged loss, ``grad_norm`` and the ``finite`` flag are the global
  ones on every rank.

Without a process group the step computes the same statistics from its
batch's tensors (:func:`tensor_stats`) and nothing is reduced: the loss reads
them the same way at every world size.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

# the batch statistics a train step reads, global over the ranks
STAT_KEYS = ("gt_total", "gt_max", "gt_classes", "dn_total", "dn_classes", "extra_any")


@dataclasses.dataclass
class Dist:
    """This process's place: rank, world size and local rank; ``group`` the
    default process group (NCCL on the card, gloo on the CPU) and ``host`` a
    gloo group over the same ranks for the host collectives. Without a group
    (no launcher), rank 0 of 1."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    backend: Optional[str] = None
    group: Any = None
    host: Any = None

    @property
    def active(self) -> bool:
        return self.backend is not None

    @property
    def lead(self) -> bool:
        """Whether this rank writes the run's files (logs, checkpoints)."""
        return self.rank == 0

    def device(self, kind) -> torch.device:
        """The device of this rank: ``cuda:LOCAL_RANK`` on the card, else the CPU."""
        kind = torch.device(kind)
        if kind.type != "cuda":
            return kind
        return torch.device("cuda", self.local_rank if self.active else (kind.index or 0))


_HOST: Dict[int, Any] = {}  # id of the default group -> (it, its gloo twin)


def _host_group(backend: str):
    """The gloo twin of the running default group, made once a group: the
    entry holds the group it was made for, so a later group (after a
    ``destroy_process_group``) never inherits a stale twin."""
    world = dist.group.WORLD
    if backend == "gloo":
        return world
    entry = _HOST.get(id(world))
    if entry is None or entry[0] is not world:
        _HOST.clear()
        _HOST[id(world)] = (world, dist.new_group(backend="gloo"))
    return _HOST[id(world)][1]


def init_distributed(device="cuda") -> Dist:
    """Start the process group when the launcher's environment is set
    (:data:`LAUNCH_ENV`, as ``torchrun`` sets it), at any world size, 1
    included, as JAX's ``init_distributed`` acts on its environment; reuse
    the group when one is running. The card takes NCCL on
    ``cuda:LOCAL_RANK``, the CPU gloo. A CUDA run whose NCCL group cannot be
    made raises: it never goes on with gloo or alone. -> :class:`Dist`."""
    kind = torch.device(device).type
    want = "nccl" if kind == "cuda" else "gloo"
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
        if backend != want:
            raise RuntimeError(f"a {backend} process group is running, and a {kind} run "
                               f"needs {want}")
        rank = dist.get_rank()
        local = int(os.environ.get("LOCAL_RANK", rank))
        return Dist(rank, dist.get_world_size(), local, backend, dist.group.WORLD,
                    _host_group(backend))
    present = [k for k in LAUNCH_ENV if k in os.environ]
    if not present:
        return Dist()
    if len(present) != len(LAUNCH_ENV):
        raise ValueError(f"the launcher's environment is incomplete: {sorted(present)} set, "
                         f"{sorted(set(LAUNCH_ENV) - set(present))} missing")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if not 0 <= rank < world:
        raise ValueError(f"RANK {rank} lies outside WORLD_SIZE {world}")
    kw: Dict[str, Any] = {}
    if kind == "cuda":
        if not torch.cuda.is_available() or not dist.is_nccl_available():
            raise RuntimeError("a CUDA run needs NCCL and a card; this process has "
                               f"cuda={torch.cuda.is_available()}, "
                               f"nccl={dist.is_available() and dist.is_nccl_available()}")
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} cards")
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(want, init_method="env://", rank=rank, world_size=world, **kw)
    return Dist(rank, world, local, want, dist.group.WORLD, _host_group(want))


def check_mesh(mesh_shape: Optional[Dict[str, int]], world: int) -> None:
    """``cfg.mesh_shape`` read as the JAX package reads it (``make_mesh``):
    ``data`` -1 means every rank, else it must equal the world size, and
    ``model`` must be 1. Raises with the reason otherwise."""
    shape = dict(mesh_shape or {})
    extra = set(shape) - {"data", "model"}
    if extra:
        raise ValueError(f"mesh_shape has axes {sorted(extra)}; the mesh's axes are "
                         "'data' and 'model'")
    data, model = int(shape.get("data", -1)), int(shape.get("model", 1))
    if model != 1:
        raise ValueError(f"mesh_shape model={model}: the JAX package shards nothing over "
                         "'model' (its mesh only reserves the axis), and the port shards "
                         "only the batch; set model=1")
    if data not in (-1, world):
        raise ValueError(f"mesh_shape data={data}, but the run has {world} process(es), "
                         "one a card: set data=-1 (every rank) or the world size")


def broadcast_(d: Dist, tensors: Sequence[torch.Tensor]) -> None:
    """Every rank's ``tensors`` set to rank 0's in place: one broadcast over
    ``d.group`` for each dtype (the tensors flattened into one buffer)."""
    if not d.active:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, 0, group=d.group)
            o = 0
            for t in ts:
                t.copy_(flat[o:o + t.numel()].view_as(t))
                o += t.numel()


def gather_ints(d: Dist, values: Sequence[int]) -> np.ndarray:
    """Each rank's ``values`` -> ``[world, len(values)]`` int64 on every rank (one
    gloo all-gather; this rank's own row alone without a group)."""
    row = torch.tensor(list(values), dtype=torch.int64)
    if not d.active:
        return row.numpy()[None]
    rows = [torch.empty_like(row) for _ in range(d.world)]
    dist.all_gather(rows, row, group=d.host)
    return torch.stack(rows).numpy()


def batch_stats(batch: Dict[str, np.ndarray], cfg) -> Dict[str, np.ndarray]:
    """The statistics of :data:`STAT_KEYS` of one host batch (``valid [B,G]``,
    ``labels [B,G]``, optionally ``is_extra [B]``) over ``cfg.num_classes``.
    ``dn_total`` and ``dn_classes`` count and name the valid GT that CDN's
    positive queries hold: an image's first ``min(count, 2 * cfg.dn_number)``
    (``models/dn.py:prepare_cdn``)."""
    num_classes, dn_slots = cfg.num_classes, 2 * cfg.dn_number
    valid = np.asarray(batch["valid"], bool)
    labels = np.asarray(batch["labels"])
    counts = valid.sum(1)
    in_dn = valid & (np.arange(valid.shape[1])[None, :]
                     < np.minimum(counts, dn_slots)[:, None])

    def classes(mask):
        out = np.zeros(num_classes, bool)
        lab = labels[mask]
        out[lab[(lab >= 0) & (lab < num_classes)]] = True
        return out

    extra = batch.get("is_extra")
    return {"gt_total": np.asarray(counts.sum(), np.int64),
            "gt_max": np.asarray(counts.max() if counts.size else 0, np.int64),
            "gt_classes": classes(valid), "dn_total": np.asarray(in_dn.sum(), np.int64),
            "dn_classes": classes(in_dn),
            "extra_any": np.asarray(bool(extra is not None and np.any(extra)))}


def tensor_stats(batch: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """:func:`batch_stats` of a batch's tensors, on their device; nothing is
    read on the host, so a CUDA graph may hold it."""
    num_classes, dn_slots = cfg.num_classes, 2 * cfg.dn_number
    valid, labels = batch["valid"].bool(), batch["labels"].long()
    counts = valid.sum(1)
    slot = torch.arange(valid.shape[1], device=valid.device)
    in_dn = valid & (slot[None, :] < counts.clamp(max=dn_slots)[:, None])
    known = (labels >= 0) & (labels < num_classes)

    def classes(mask):
        # the rest go to an extra entry, so that no mask selects on the host
        idx = torch.where(mask & known, labels, num_classes).reshape(-1)
        out = torch.zeros(num_classes + 1, dtype=torch.bool, device=valid.device)
        return out.index_fill_(0, idx, True)[:num_classes]

    extra = batch.get("is_extra")
    return {"gt_total": counts.sum(), "gt_max": counts.max(),
            "gt_classes": classes(valid), "dn_total": in_dn.sum(), "dn_classes": classes(in_dn),
            "extra_any": (extra.any() if extra is not None
                          else torch.zeros((), dtype=torch.bool, device=valid.device))}


def step_stats(d: Dist, batch: Optional[Dict[str, np.ndarray]],
               cfg) -> Optional[Dict[str, np.ndarray]]:
    """The host collective before a step: whether the rank has a ``batch``
    (None when its loader is out), its :func:`batch_stats`, and their global
    values (sum, max, unions, any) over the ranks -> those global statistics,
    or None when any rank has no batch (every rank ends its epoch there).
    Without a group, nothing is reduced and ``{}`` stands for a batch: the
    step computes its batch's own statistics (:func:`tensor_stats`)."""
    if not d.active:
        return None if batch is None else {}
    c = cfg.num_classes
    if batch is None:
        row = [0] * (5 + 2 * c)
    else:
        s = batch_stats(batch, cfg)
        row = [1, int(s["gt_total"]), int(s["gt_max"]), int(s["dn_total"]),
               int(s["extra_any"]), *s["gt_classes"].astype(np.int64).tolist(),
               *s["dn_classes"].astype(np.int64).tolist()]
    rows = gather_ints(d, row)
    if not rows[:, 0].all():
        return None
    return {"gt_total": np.asarray(rows[:, 1].sum(), np.int64),
            "gt_max": np.asarray(rows[:, 2].max(), np.int64),
            "gt_classes": rows[:, 5:5 + c].max(0).astype(bool),
            "dn_total": np.asarray(rows[:, 3].sum(), np.int64),
            "dn_classes": rows[:, 5 + c:].max(0).astype(bool),
            "extra_any": np.asarray(bool(rows[:, 4].max()))}


class _ReduceStats:
    """The statistics collective of a step with the teacher's weak labels:
    ``reduce_stats_(stats, d, num_classes)`` -> the global statistics of
    :data:`STAT_KEYS` from each rank's :func:`tensor_stats`, on the card.
    One all-gather of each rank's int32 row (the counts, the largest count,
    ``extra_any`` and the two class masks), then the sums, maxima and unions
    of :func:`step_stats` taken on the device, so that a CUDA graph holds it
    and nothing is read on the host. ``.launches`` counts its calls, as
    :data:`average_`'s does."""

    def __init__(self):
        self.launches = 0

    def __call__(self, stats: Dict[str, torch.Tensor], d: Dist,
                 num_classes: int) -> Dict[str, torch.Tensor]:
        head = torch.stack([stats[k].reshape(()).to(torch.int32)
                            for k in ("gt_total", "gt_max", "dn_total", "extra_any")])
        row = torch.cat([head, stats["gt_classes"].to(torch.int32),
                         stats["dn_classes"].to(torch.int32)])
        rows = torch.empty(d.world * row.numel(), dtype=torch.int32, device=row.device)
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather(rows, row, group=d.group)
        self.launches += 1
        rows = rows.view(d.world, -1)
        c = num_classes
        return {"gt_total": rows[:, 0].sum(), "gt_max": rows[:, 1].amax().long(),
                "gt_classes": rows[:, 4:4 + c].amax(0).bool(), "dn_total": rows[:, 2].sum(),
                "dn_classes": rows[:, 4 + c:].amax(0).bool(),
                "extra_any": rows[:, 3].amax().bool()}


reduce_stats_ = _ReduceStats()


def gather_to_lead(d: Dist, obj: Any) -> Optional[List[Any]]:
    """Every rank's ``obj`` (picklable) -> the list in rank order on rank 0,
    None elsewhere; ``[obj]`` without a group."""
    if not d.active:
        return [obj]
    out = [None] * d.world if d.lead else None
    dist.gather_object(obj, out, dst=0, group=d.host)
    return out


def broadcast_object(d: Dist, obj: Any) -> Any:
    """Rank 0's ``obj`` on every rank."""
    if not d.active:
        return obj
    box = [obj if d.lead else None]
    dist.broadcast_object_list(box, src=0, group=d.host)
    return box[0]


def barrier(d: Dist) -> None:
    if d.active:
        dist.barrier(group=d.host)


class _Average:
    """The gradient collective: ``average_(flat, d)`` replaces ``flat`` on every
    rank by the mean over the ranks, in place: NCCL's AVG on the card (which
    is one kernel even in a one-rank group), a gloo sum divided by N on the
    CPU (gloo has no AVG). ``.launches`` counts its calls, as a kernel
    wrapper's counts its launches, so that a CUDA graph's capture and replays
    count it as they count the kernels."""

    def __init__(self):
        self.launches = 0

    def __call__(self, flat: torch.Tensor, d: Dist) -> None:
        if d.backend == "nccl":
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=d.group)
        else:
            dist.all_reduce(flat, group=d.group)
            flat.div_(d.world)
        self.launches += 1


average_ = _Average()


def union_(mask: torch.Tensor, d: Dist) -> torch.Tensor:
    """The union over the ranks of a bool ``mask``: one all-reduce (MAX) of its
    int32 copy. The many-to-one criterion's federated classes (the classes its
    queries were assigned) read it."""
    buf = mask.to(torch.int32)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=d.group)
    union_.calls += 1
    return buf.bool()


union_.calls = 0  # its collectives, a set's federated classes each


def total_(counts: torch.Tensor, d: Dist) -> torch.Tensor:
    """The sum over the ranks of ``counts``: one all-reduce (SUM) of its copy.
    The many-to-one ``class_error`` reads it for its two counts (the assigned
    queries whose class is right, and the assigned queries), so that its ratio
    is the global batch's, as JAX takes it over the data-sharded batch."""
    buf = counts.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=d.group)
    total_.calls += 1
    return buf


total_.calls = 0  # its collectives, a many-to-one set's class_error each


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, world: int, port: int, args: tuple, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        result = {"ok": fn(*args)}
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        result = {"error": traceback.format_exc()}
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    with open(out, "wb") as f:
        pickle.dump(result, f)


def spawn(fn: Callable[..., Any], nprocs: int, args: tuple = (),
          timeout: float = 240.0) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` new processes (the spawn method), rank
    ``r`` with the launcher's environment of rank ``r`` of ``nprocs`` on a free
    localhost port and local rank ``r`` (so one card each on the card), ->
    their results in rank order (picklable). A rank that raises makes this
    raise with its traceback. Past ``timeout`` seconds every rank still
    running is killed and :class:`TimeoutError` raised: a hung collective
    never outlives its caller."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
        procs = [ctx.Process(target=_rank_main, args=(fn, r, nprocs, port, args, outs[r]),
                             daemon=True) for r in range(nprocs)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results: Dict[int, Any] = {}
        try:
            while len(results) < nprocs:
                for r, p in enumerate(procs):
                    if r in results or p.is_alive():
                        continue
                    if not os.path.isfile(outs[r]):
                        raise RuntimeError(f"rank {r} of {nprocs} exited with code "
                                           f"{p.exitcode} and no result")
                    with open(outs[r], "rb") as f:
                        res = pickle.load(f)
                    if "error" in res:  # the other ranks may wait on it: stop them
                        raise RuntimeError(f"rank {r} of {nprocs} raised:\n{res['error']}")
                    results[r] = res["ok"]
                if time.monotonic() > deadline:
                    late = [r for r, p in enumerate(procs) if p.is_alive()]
                    raise TimeoutError(f"ranks {late} of {nprocs} still ran after "
                                       f"{timeout:.0f} s and were killed")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
    return [results[r] for r in range(nprocs)]
