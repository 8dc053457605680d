"""Training/eval orchestration (counterpart of ``richsem_tpu/train/main.py``).

CLI -> config load/merge/dump -> model via the registry -> datasets, samplers
(RFS/CAS/shuffle), bucket-grouped loaders (+ the ImageNet-LVIS interleave) ->
optimizer -> auto-resume / pretrained load -> epoch loop (train, checkpoint,
periodic eval, best-checkpoint tracking, EMA eval, JSON log lines), on the
card unless ``--device cpu`` is asked for.

Data parallelism (``parallel/dist.py``): one process a card, as ``torchrun``
starts them; with the launcher's environment set the run is one rank of a
process group (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU), at any world
size. Each rank reads its shard of the samplers with ``cfg.batch_size``
images a step, starts from rank 0's parameters, and before each step joins
one host collective that gives the step the global batch statistics and
ends the epoch for every rank when any rank's loader is out; its train step
averages the gradients over the ranks. Each rank evaluates its shard of the
val set, and rank 0 summarises the gathered predictions. Only rank 0 writes
``log.txt``, ``config.json``, ``eval.json``, ``results.json`` and the
checkpoints, each save followed by a barrier.

Usage:
  python -m richsem_tpu_torch.train.main -c configs/richsem/dino_4scale_lvis.py \\
      --output_dir out/ [--options k=v ...] [--eval] [--test] [--resume dir] \\
      [--device cuda]
  torchrun --nproc_per_node=N -m richsem_tpu_torch.train.main -c ... --output_dir out/

The non-finite-loss abort is delayed by one step, as in JAX: a step's
``finite`` flag is read after the next step has been issued, so at most one
poisoned update lands before the run stops. The flag is the global loss's,
so every rank stops at the same step.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import time
from collections import deque
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

import richsem_tpu_torch.models.build  # noqa: F401 - registers 'richsem'
from richsem_tpu_torch.config import Config, parse_override_options
from richsem_tpu_torch.data.datasets import build_dataset
from richsem_tpu_torch.data.loader import DataLoader, MultiDatasetLoader
from richsem_tpu_torch.data.samplers import ClassAwareSampler, RepeatFactorSampler, ShuffleSampler
from richsem_tpu_torch.models import registry
from richsem_tpu_torch.parallel import dist as pdist
from richsem_tpu_torch.parallel.dist import Dist
from richsem_tpu_torch.train.engine import create_train_state, make_eval_step, make_train_step
from richsem_tpu_torch.train.optim import build_optimizer, ema_init
from richsem_tpu_torch.utils.checkpoint import BestMetricHolder, CheckpointManager
from richsem_tpu_torch.utils.logging import MetricLogger, setup_logger

# CLI defaults, applied only when neither the config file nor the command
# line provides the key — an explicitly passed flag beats the config file,
# but an *unset* default must not clobber config/--options values
# (the reference avoids this by hard-erroring on collisions, main.py:150-156).
_CLI_DEFAULTS = dict(
    dataset_file="lvis", data_root="DATASET", output_dir="", resume="",
    pretrain_model_path="", finetune_ignore=None, eval=False, test=False,
    debug=False, seed=42, start_epoch=0, note="", device="cuda",
)

def get_args_parser() -> argparse.ArgumentParser:
    """CLI surface parity with main.py:74-125, plus ``--device``.

    Every optional argument defaults to ``argparse.SUPPRESS`` so that
    :func:`load_config` can distinguish explicitly passed flags from
    defaults (see ``_CLI_DEFAULTS``)."""
    S = argparse.SUPPRESS
    p = argparse.ArgumentParser("RichSem-PyTorch", add_help=False)
    p.add_argument("--config_file", "-c", type=str, required=True)
    p.add_argument("--options", nargs="+", default=S, help="override k=v pairs")
    p.add_argument("--dataset_file", type=str, default=S)
    p.add_argument("--data_root", type=str, default=S)
    p.add_argument("--output_dir", type=str, default=S)
    p.add_argument("--resume", type=str, default=S)
    p.add_argument("--pretrain_model_path", type=str, default=S)
    p.add_argument("--finetune_ignore", type=str, nargs="+", default=S)
    p.add_argument("--eval", action="store_true", default=S)
    p.add_argument("--save_results", action="store_true", default=S,
                   help="dump the gt/pred arrays during eval "
                        "(reference engine.py:239-299)")
    p.add_argument("--test", action="store_true", default=S)
    p.add_argument("--debug", action="store_true", default=S)
    p.add_argument("--seed", type=int, default=S)
    p.add_argument("--start_epoch", type=int, default=S)
    p.add_argument("--note", type=str, default=S)
    p.add_argument("--device", type=str, default=S,
                   help="cuda (default) or cpu")
    return p


def load_config(args) -> Config:
    provided = dict(vars(args))
    options = provided.pop("options", None)
    provided.pop("config_file", None)
    cfg = Config.fromfile(args.config_file)
    for k, v in provided.items():  # explicitly passed CLI flags
        cfg[k] = v
    cfg.merge_from_dict(parse_override_options(options))  # --options wins
    for k, v in _CLI_DEFAULTS.items():
        if k not in cfg:
            cfg[k] = v
    return cfg


def build_loaders(cfg, shard_id: int = 0, num_shards: int = 1):
    """-> (train_loader, val_loader, train_ds, val_ds) of shard ``shard_id`` of
    ``num_shards`` (a rank's), ``cfg.batch_size`` images a step: JAX's
    ``global_batch // num_shards`` with one device a process."""
    train_ds = build_dataset("train", cfg)
    val_ds = build_dataset("val", cfg)
    buckets = [tuple(b) for b in cfg.train_canvas_buckets]
    max_gt = cfg.max_gt_per_image

    if cfg.use_rfs:
        sampler = RepeatFactorSampler(
            train_ds.category_ids_per_image(), cfg.num_classes,
            repeat_thresh=cfg.rfs_repeat_sh,
            shard_id=shard_id, num_shards=num_shards, seed=cfg.seed,
        )
    elif cfg.use_cas:
        sampler = ClassAwareSampler(
            train_ds.category_ids_per_image(), cfg.num_classes,
            shard_id=shard_id, num_shards=num_shards, seed=cfg.seed,
        )
    else:
        sampler = ShuffleSampler(len(train_ds), shard_id, num_shards, seed=cfg.seed)
    global_batch = cfg.batch_size * num_shards
    train_loader = DataLoader(
        train_ds, sampler, global_batch // num_shards, buckets, max_gt, seed=cfg.seed,
    )
    if cfg.use_imagenet:
        extra_ds = build_dataset("train", cfg, imagenet_lvis=True)
        extra_buckets = list(buckets)
        if cfg.imagenet_use_mosaic:
            extra_buckets.append((1280, 1280))  # 2×(640,640) mosaic canvas
        extra_loader = DataLoader(
            extra_ds, ShuffleSampler(len(extra_ds), shard_id, num_shards, cfg.seed),
            global_batch // num_shards, extra_buckets, max_gt, seed=cfg.seed + 1,
        )
        train_loader = MultiDatasetLoader(train_loader, extra_loader, cfg.main_weight,
                                          cfg.sub_weight)
    # Eval resize is shortest-side 800 @ max 1333 in either orientation
    # (datasets/coco.py:689-692) — cover both orientations of the eval canvas
    ch, cw = tuple(cfg.eval_canvas)
    eval_canvas = sorted({(ch, cw), (cw, ch)})
    val_loader = DataLoader(
        val_ds,
        ShuffleSampler(len(val_ds), shard_id, num_shards, 0, shuffle=False,
                       pad_to_equal=num_shards > 1),
        max(global_batch // num_shards, 1), eval_canvas, max_gt,
        drop_last=False, pad_last=True,
    )
    return train_loader, val_loader, train_ds, val_ds


def place_batch(batch: Dict[str, np.ndarray], device) -> Dict[str, object]:
    """Host batch -> tensors on ``device`` (int32 widened to int64); on the card
    each is copied from pinned memory without blocking the host. ``image_id``
    stays on the host."""
    device = torch.device(device)
    out: Dict[str, object] = {}
    for k, v in batch.items():
        if k == "image_id":
            out[k] = np.asarray(v)
            continue
        a = np.asarray(v)  # a 0-d statistic stays 0-d (np.ascontiguousarray makes it 1-d)
        t = torch.from_numpy(a if a.flags.c_contiguous else np.ascontiguousarray(a))
        if t.dtype == torch.int32:
            t = t.long()
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch_to_device(batches: Iterable, device, depth: int = 2) -> Iterator:
    """Place the next batch(es) while the current step runs: the copies are
    issued ahead of the step that reads them (main.py:290)."""
    buf: deque = deque()
    for batch in batches:
        buf.append(place_batch(batch, device))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _timed(batches: Iterable, waits: list) -> Iterator:
    """``batches``, appending the host seconds spent waiting for each to ``waits``."""
    it = iter(batches)
    while True:
        t = time.perf_counter()
        try:
            batch = next(it)
        except StopIteration:
            return
        waits.append(time.perf_counter() - t)
        yield batch


@contextlib.contextmanager
def swapped_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]):
    """The model with ``params`` (e.g. the EMA) in place of its own, restored after."""
    own = {n: p.detach().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(params[n])
    try:
        yield model
    finally:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(own[n])


def _predictions(results, image_ids):
    scores = results["scores"].float().cpu().numpy()
    labels = results["labels"].cpu().numpy()
    boxes = results["boxes"].float().cpu().numpy()
    return {int(image_ids[i]): {"scores": scores[i], "labels": labels[i], "boxes": boxes[i]}
            for i in range(len(image_ids))}, (scores, labels, boxes)


def _eval_rounds(val_loader, d: Dist) -> Iterator:
    """The val loader's batches; under a process group the last one is run
    again until this rank has run as many as the rank with the most
    (``num_batches_hint``, gathered), since every round gathers the
    predictions (JAX ``main.py:196-218``)."""
    pad = 0
    if d.active:
        local = val_loader.num_batches_hint(0)
        if local is None:
            raise RuntimeError("data-parallel eval needs an eval transform whose sizes the "
                               "dataset can predict (dataset.size_hint)")
        pad = int(pdist.gather_ints(d, [local]).max()) - local
    last = None
    for batch in val_loader.epoch(0):
        last = batch
        yield batch
    if pad and last is None:
        raise RuntimeError("this rank's val shard holds no batch to run again")
    for _ in range(pad):
        yield last


def evaluate(cfg, model, val_loader, val_ds, text_embed=None, logger=None, device="cuda",
             save_results_dir: Optional[str] = None, dist: Optional[Dist] = None,
             clip_model=None) -> Dict[str, float]:
    """Eval loop + AP summary (engine.py:149-330 equivalent) -> the evaluator's
    metrics, ``eval_ms_per_batch`` (host clock, loader included) and
    ``eval_graphs``, the CUDA graphs the step captured (one a batch shape; 0
    on the CPU). Each call builds its own step, so no graph outlives it.

    Under a process group (``dist``) each rank evaluates its shard in equal
    rounds (:func:`_eval_rounds`), every round's predictions are gathered to
    rank 0 (the evaluator keeps one an image id, so padded and re-run images
    count once), and rank 0's summary is broadcast, so that every rank
    returns the same metrics (JAX ``main.py:162-285``).

    ``save_results_dir`` mirrors the reference's ``--save_results`` dump
    (engine.py:239-299): each rank's {gt, prediction} arrays pickled to
    ``results_rank{k}.pkl`` for offline AP-parity diffing."""
    from richsem_tpu_torch.data.evaluation import CocoEvaluator, LvisEvaluator

    d = dist or Dist()
    eval_step = make_eval_step(model, cfg, clip_model)
    if cfg.dataset_file.startswith("lvis"):
        evaluator = LvisEvaluator(val_ds.index, max_dets=cfg.num_select)
    else:
        # COCO protocol fixes maxDets at 100 per image-category regardless
        # of num_select (pycocotools default params, coco_eval.py)
        evaluator = CocoEvaluator(val_ds.index, max_dets=100)
    n, n_batches, saved = 0, 0, []
    t0 = time.perf_counter()
    for batch in prefetch_to_device(_eval_rounds(val_loader, d), device):
        results = eval_step(batch, text_embed)
        preds, (scores, labels, boxes) = _predictions(results, batch["image_id"])
        for ranks_preds in pdist.gather_to_lead(d, preds) or []:
            evaluator.update(ranks_preds)
        n_batches += 1
        if save_results_dir is not None:
            saved.append({
                "image_id": batch["image_id"],
                "orig_size": batch["orig_size"].cpu().numpy(),
                "gt_labels": batch["labels"].cpu().numpy(),
                "gt_boxes": batch["boxes"].cpu().numpy(),
                "gt_valid": batch["valid"].cpu().numpy(),
                "scores": scores, "labels": labels, "boxes": boxes,
            })
        n += len(preds)
        if cfg.debug and n >= 30:
            break
    ms_batch = (time.perf_counter() - t0) * 1e3 / max(n_batches, 1)
    if save_results_dir is not None:
        os.makedirs(save_results_dir, exist_ok=True)
        out = os.path.join(save_results_dir, f"results_rank{d.rank}.pkl")
        with open(out, "wb") as f:
            pickle.dump(saved, f)
        if logger:
            logger.info(f"saved {len(saved)} eval batches to {out}")
    stats = None
    if d.lead:
        stats = dict(evaluator.summarize(), eval_ms_per_batch=ms_batch,
                     eval_graphs=len(eval_step.graphs))
    stats = pdist.broadcast_object(d, stats)
    if logger:
        logger.info(f"eval on {n} images ({n_batches} batches, {ms_batch:.1f} ms/batch"
                    f"{f', rank {d.rank} of {d.world}' if d.active else ''}): {stats}")
    return stats


def test_submission(cfg, model, val_loader, text_embed=None, device="cuda",
                    dist: Optional[Dist] = None, clip_model=None) -> Optional[list]:
    """Submission mode: COCO-format result records (engine.py:333-447
    ``test`` + ``convert_to_xywh`` parity), one set an image id. Under a
    process group each rank runs its shard in equal rounds and rank 0 gathers
    the records; the other ranks return None."""
    d = dist or Dist()
    eval_step = make_eval_step(model, cfg, clip_model)
    records, seen = [], set()
    for batch in prefetch_to_device(_eval_rounds(val_loader, d), device):
        _, (scores, labels, boxes) = _predictions(eval_step(batch, text_embed),
                                                  batch["image_id"])
        local: Dict[int, list] = {}
        for i in range(len(batch["image_id"])):
            b = boxes[i]
            xywh = np.stack([b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
            recs = local.setdefault(int(batch["image_id"][i]), [])
            for k in range(len(xywh)):
                if scores[i, k] <= 0:
                    continue
                recs.append({
                    "image_id": int(batch["image_id"][i]),
                    "category_id": int(labels[i, k]),
                    "bbox": [round(float(v), 2) for v in xywh[k]],
                    "score": round(float(scores[i, k]), 5),
                })
        for ranks_records in pdist.gather_to_lead(d, local) or []:
            for img_id, recs in ranks_records.items():
                if img_id not in seen:
                    seen.add(img_id)
                    records.extend(recs)
    return records if d.lead else None


def _clip_branch(cfg, val_ds, device, logger):
    """The frozen CLIP teacher with its weights, and the class text bank."""
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.models.clip.tokenizer import SimpleTokenizer
    from richsem_tpu_torch.models.clip_align import build_text_embedding
    from richsem_tpu_torch.utils.convert import clip_params_from_jax

    # the teacher's vision tower follows the training compute dtype (the
    # reference teacher runs fp16, clip/clip.py model.half())
    dtype = "bfloat16" if getattr(cfg, "compute_dtype", "float32") == "bfloat16" else None
    clip_model = build_clip_teacher(cfg, dtype=dtype, device=device)
    with open(cfg.clip_checkpoint_path, "rb") as f:
        flax_params = pickle.load(f)
    clip_model.load_state_dict(clip_params_from_jax(flax_params, clip_model.state_dict()))
    tokenizer = SimpleTokenizer(cfg.clip_bpe_path)
    cats = dict(val_ds.index.cats)
    logger.info(f"building text bank for {len(cats)} categories…")
    return clip_model, build_text_embedding(clip_model, cats, tokenizer)


def _resume_epoch(manager: CheckpointManager) -> int:
    """The epoch after the one the restored checkpoint completes. JAX takes
    ``step // len(train_loader)`` (main.py:476), which restarts a finished epoch
    when bucket grouping dropped partial batches (ROADMAP F8), so the port's
    checkpoints carry their epoch."""
    info = manager.restored
    if info["epoch"] is None:
        raise ValueError(f"checkpoint step {info['step']} in {manager.directory} records no "
                         "epoch to resume after")
    return int(info["epoch"]) + 1


def _synced(batches: Iterable, d: Dist, cfg) -> Iterator:
    """The loader's batches, each with the step's global batch statistics
    (``parallel/dist.py:step_stats``: one host collective a step, from the
    numpy batch); it ends for every rank when any rank's loader is out, so
    that every rank takes the same number of steps."""
    it = iter(batches)
    try:
        while True:
            batch = next(it, None)
            stats = pdist.step_stats(d, batch, cfg)
            if stats is None:
                return
            yield dict(batch, **stats)
    finally:
        if hasattr(it, "close"):
            it.close()


def _replicated(state) -> list:
    """The tensors every rank holds alike: parameters, buffers, AdamW's moments
    and the EMA."""
    model, opt = state.model, state.optimizer
    return [*model.parameters(), *model.buffers(), *opt.mu, *opt.nu,
            *(state.ema or {}).values()]


def train_loop(cfg, device=None) -> Dict:
    """One run as the CLI describes it -> ``{"test": path}``, ``{"eval": stats}``
    or ``{"best": ..., "state": the TrainState, "train_step": the step (its CUDA
    graphs on the card), "dist": this rank's place, "epochs": the epoch stats,
    "step_s", "data_s": host seconds a step and waiting for its batch,
    "ckpt_save_s", "ckpt_restore_s"}``. Under the launcher's environment the
    run is one rank of a data-parallel run (see the module docstring)."""
    kind = device or getattr(cfg, "device", "cuda")
    d = pdist.init_distributed(kind)
    pdist.check_mesh(getattr(cfg, "mesh_shape", None), d.world)
    device = d.device(kind)
    logger = setup_logger(cfg.output_dir or None, process_index=d.rank)
    logger.info(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}"
                + (f", rank {d.rank} of {d.world} over {d.backend}" if d.active else ""))
    if cfg.output_dir and d.lead:
        os.makedirs(cfg.output_dir, exist_ok=True)
        Config.from_dict(cfg.to_dict()).dump(os.path.join(cfg.output_dir, "config.json"))

    pretrained = None
    if cfg.pretrain_model_path:
        from richsem_tpu_torch.utils.checkpoint import guard_converted_checkpoint

        with open(cfg.pretrain_model_path, "rb") as f:
            pretrained = pickle.load(f)
        # converted reference checkpoints must not be silently clamped: may
        # mutate cfg (exact gather path for eval) BEFORE the model is built,
        # or refuse a clamped training run
        guard_converted_checkpoint(cfg, pretrained, logger)
    model, _, _ = registry.MODEL_REGISTRY["richsem"](
        cfg, device=device, generator=torch.Generator(device=device).manual_seed(cfg.seed))

    train_loader, val_loader, train_ds, val_ds = build_loaders(cfg, d.rank, d.world)
    # the lr schedule must agree on every rank
    steps_per_epoch = max(int(pdist.gather_ints(d, [len(train_loader)]).min()), 1)
    if pretrained is not None:
        from richsem_tpu_torch.utils.checkpoint import load_pretrained_params

        load_pretrained_params(model, pretrained, cfg.finetune_ignore or [])

    text_embed = clip_model = None
    if cfg.use_language or cfg.use_visual_distill:
        clip_model, text_embed = _clip_branch(cfg, val_ds, device, logger)

    fed_weight = None
    if cfg.use_fed_loss:
        from richsem_tpu_torch.data.coco_api import category_image_counts

        counts = category_image_counts(train_ds.index, cfg.num_classes,
                                       {c: c for c in train_ds.index.cats})
        fed_weight = torch.from_numpy(counts).to(device) ** 0.5

    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch),
                               use_ema=cfg.use_ema)
    train_step = make_train_step(model, cfg, seed=cfg.seed, device=device,
                                 clip_model=clip_model, dist=d)

    result: Dict = {"ckpt_save_s": [], "ckpt_restore_s": [], "dist": d}
    ckpt: Optional[CheckpointManager] = None
    start_epoch = cfg.start_epoch
    if cfg.output_dir:
        ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpt"))
        latest = ckpt.latest_step()
        if latest is not None:  # auto-resume (main.py:319-349)
            logger.info(f"auto-resuming from step {latest}")
            t = time.perf_counter()
            state = ckpt.restore(state)
            result["ckpt_restore_s"].append(time.perf_counter() - t)
            start_epoch = _resume_epoch(ckpt)
    if cfg.resume and (ckpt is None or ckpt.latest_step() is None):
        # explicit --resume from another run's checkpoint dir (main.py:344-349)
        src = CheckpointManager(cfg.resume)
        step = src.latest_step()
        logger.info(f"resuming from {cfg.resume} step {step}")
        state = src.restore(state)
        start_epoch = _resume_epoch(src)
    # every rank starts from rank 0's state, also a rank that cannot see its
    # checkpoint: the tensors, then the step, AdamW's count and the epoch
    pdist.broadcast_(d, _replicated(state))
    state.step, state.optimizer.count, start_epoch = pdist.broadcast_object(
        d, (state.step, state.optimizer.count, start_epoch))

    if cfg.test:
        res = test_submission(cfg, model, val_loader, text_embed, device=device, dist=d,
                              clip_model=clip_model)
        out_path = os.path.join(cfg.output_dir or ".", "results.json")
        if d.lead:
            with open(out_path, "w") as f:
                json.dump(res, f)
            logger.info(f"wrote {len(res)} detections to {out_path}")
        pdist.barrier(d)
        return {"test": out_path}

    if cfg.eval:
        stats = evaluate(cfg, model, val_loader, val_ds, text_embed, logger, device,
                         save_results_dir=(cfg.output_dir or ".")
                         if getattr(cfg, "save_results", False) else None, dist=d,
                         clip_model=clip_model)
        if cfg.output_dir and d.lead:
            with open(os.path.join(cfg.output_dir, "eval.json"), "w") as f:
                json.dump(dict(stats, step=int(state.step)), f)
        pdist.barrier(d)
        return {"eval": stats}

    def save(**kw):  # rank 0 writes; every rank waits for it
        if d.lead:
            t = time.perf_counter()
            ckpt.save(int(state.step), state, **kw)
            result["ckpt_save_s"].append(time.perf_counter() - t)
        pdist.barrier(d)

    best = BestMetricHolder(use_ema=cfg.use_ema)
    log_path = os.path.join(cfg.output_dir, "log.txt") if cfg.output_dir and d.lead else None
    result.update(epochs=[], step_s=[], data_s=[])

    for epoch in range(start_epoch, cfg.epochs):
        if cfg.use_ema and epoch == cfg.ema_epoch and cfg.ema_epoch > 0:
            # EMA starts tracking at ema_epoch (util/utils.py ModelEma +
            # main.py:337-342 rebuild semantics)
            state.ema = ema_init(model)
            train_step.reset()  # a graph updates the EMA tensors it captured
        mlog = MetricLogger(logger=logger)
        t0 = time.time()
        # Per-step NaN abort, delayed by exactly one step (reference aborts on
        # the step the NaN appears, engine.py:93-96; here at most ONE
        # poisoned update lands before the abort)
        prev_finite, prev_it = None, -1
        batches = _synced(train_loader.epoch(epoch), d, cfg)
        placed = _timed(prefetch_to_device(batches, device), result["data_s"])
        t_step = time.perf_counter()
        for it, batch in enumerate(mlog.log_every(placed, 50, header=f"Epoch [{epoch}]",
                                                  total=steps_per_epoch)):
            if fed_weight is not None:
                batch["fed_weight"] = fed_weight
            metrics = train_step(state, batch, text_embed)
            if prev_finite is not None and not bool(prev_finite):
                logger.error(f"non-finite loss at epoch {epoch} it {prev_it}")
                raise FloatingPointError("loss is not finite")
            prev_finite, prev_it = metrics["finite"], it
            if it % 50 == 0:  # the metrics are the global batch's on every rank
                mlog.update(**{k: float(v) for k, v in metrics.items() if k != "finite"})
            now = time.perf_counter()
            result["step_s"].append(now - t_step)
            t_step = now
            if cfg.debug and it >= 15:
                break
        if prev_finite is not None and not bool(prev_finite):
            logger.error(f"non-finite loss at epoch {epoch} it {prev_it}")
            raise FloatingPointError("loss is not finite")
        epoch_stats = {k: v.global_avg for k, v in mlog.meters.items()}

        if ckpt and ((epoch + 1) % cfg.save_checkpoint_interval == 0
                     or epoch + 1 == cfg.lr_drop):
            save(epoch=epoch)

        if (epoch + 1) % cfg.eval_interval == 0:
            stats = evaluate(cfg, model, val_loader, val_ds, text_embed, logger, device,
                             dist=d, clip_model=clip_model)
            ap = stats.get("AP", float("nan"))
            if best.update(ap, epoch) and ckpt:
                save(metrics={"AP": ap}, epoch=epoch)
            if cfg.use_ema and state.ema is not None:
                with swapped_params(model, state.ema):
                    ema_stats = evaluate(cfg, model, val_loader, val_ds, text_embed, logger,
                                         device, dist=d, clip_model=clip_model)
                best.update(ema_stats.get("AP", float("nan")), epoch, is_ema=True)
                epoch_stats.update({f"ema_{k}": v for k, v in ema_stats.items()})
            epoch_stats.update(stats)

        epoch_stats.update({"epoch": epoch, "step": int(state.step),
                            "train_time_s": round(time.time() - t0, 1)})
        result["epochs"].append(epoch_stats)
        if log_path:
            with open(log_path, "a") as f:
                f.write(json.dumps(epoch_stats, default=float) + "\n")

    result.update(best=best.summary(), state=state, train_step=train_step)
    return result


def main() -> None:
    args = get_args_parser().parse_args()
    cfg = load_config(args)
    train_loop(cfg)


if __name__ == "__main__":
    main()
