"""Train and eval steps (counterpart of ``richsem_tpu/train/engine.py``).

* :func:`make_loss_fn` -- with ``use_visual_distill``, the frozen CLIP
  teacher's targets (one spatial forward a step, RoIAlign + attention pool at
  the first ``distill_max_boxes`` valid GT boxes, the weak-label rewrite of
  ``is_extra`` rows under ``use_imagenet_pusedo_labels``, and for the
  ``pred`` objectives the teacher at the predicted boxes); then CDN queries,
  the detector forward with ``train=True``, matching and the weighted loss.
* :func:`make_train_step` -- loss, gradient (of every leaf, frozen ones
  included), the clipped AdamW update, EMA, and the metrics of
  ``engine.py:301-311`` with the ``finite`` flag. The step's random draws (CDN
  noise, federated-loss uniforms) come from a ``torch.Generator`` seeded from
  the base seed and the step counter, so the stream advances with the step and
  a resumed run draws what the uninterrupted one would; a caller (a test) may
  pass the draws in instead. On the card the step is replayed as a CUDA graph
  per batch shape (:class:`TrainStep`), the counterpart of JAX's jitted and
  donated step; on the CPU it runs as it is.
* :func:`make_eval_step` -- inference forward + PostProcess
  (:func:`eval_forward`), replayed as a CUDA graph per batch shape on the card
  (:class:`EvalStep`), run as it is on the CPU.

Batch layout: ``images [B,H,W,3]`` f32, ``pad_mask [B,H,W]`` bool (True on
padding), ``labels [B,G]`` int, ``boxes [B,G,4]`` normalized cxcywh,
``valid [B,G]`` bool, ``orig_size [B,2]``, optionally ``is_extra [B]`` bool
and, with ``masks=True``, ``masks [B,G,H/8,W/8]`` bool (the collate's);
with the teacher also ``size [B,2]``, the valid (h, w) of each image in the
canvas, by which the normalized boxes are scaled for the RoI crops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.clip_align import (
    clip_pseudo_labels_multi,
    clip_spatial_features,
    clip_teacher_box_targets,
)
from richsem_tpu_torch.models.criterion import (
    GlobalStats,
    build_weight_dict,
    expand_dn_targets,
    set_criterion,
    weighted_loss,
)
from richsem_tpu_torch.models.dn import cdn_draws, cdn_pad, prepare_cdn
from richsem_tpu_torch.models.postprocess import postprocess
from richsem_tpu_torch.models.segmentation import exact_f32
from richsem_tpu_torch.parallel.dist import (
    STAT_KEYS,
    Dist,
    average_,
    reduce_stats_,
    tensor_stats,
    total_,
    union_,
)
from richsem_tpu_torch.train.optim import AdamW, ema_init, ema_update, frozen_leaves

# JAX's metric keys (engine.py:301-311), the DN distillation term and, where the
# batch carries masks, the two mask terms (JAX logs neither)
METRIC_KEYS = ("loss_ce", "loss_bbox", "loss_giou", "loss_ce_dn", "loss_distill",
               "loss_distill_dn", "class_error", "cardinality_error", "offset_beyond_margin",
               "loss_mask", "loss_dice")


def _use_dn(cfg) -> bool:
    return bool(cfg.use_dn and cfg.dn_number > 0)


def dn_group_mode(cfg) -> bool:
    """CDN's group-count branch: ``0 < dn_number < 50`` (unless a test forces
    the budget branch with ``dn_force_budget``), as JAX's ``make_loss_fn``."""
    return 0 < cfg.dn_number < 50 and not getattr(cfg, "dn_force_budget", False)


def step_draws(cfg, batch_size: int, generator: torch.Generator,
               device="cuda", gt_slots: int = 0) -> Dict[str, Any]:
    """One step's random draws: ``dn`` (the four CDN tensors, with DN on, for
    the pad of ``gt_slots`` GT slots an image in the group-count branch) and
    ``fed_uniforms [16, C]`` (with the federated loss on)."""
    draws: Dict[str, Any] = {}
    if _use_dn(cfg):
        if dn_group_mode(cfg) and gt_slots < 1:
            raise ValueError("the CDN group-count branch sizes its draws by the GT slots: "
                             "pass gt_slots")
        pad = cdn_pad(cfg.dn_number, gt_slots, dn_group_mode(cfg))
        draws["dn"] = cdn_draws(batch_size, cfg.dn_number, cfg.num_classes, generator,
                                device=device, pad=pad)
    if cfg.use_fed_loss:
        draws["fed_uniforms"] = torch.rand((16, cfg.num_classes), generator=generator,
                                           device=device)
    return draws


def make_loss_fn(model, cfg, clip_model=None, world_size: int = 1, dist: Optional[Dist] = None
                 ) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """-> ``loss_fn(batch, draws, text_embed=None, dropout_generator=None) ->
    (total, losses)``.

    ``clip_model`` is the frozen teacher (``models/build.py:build_clip_teacher``),
    which ``use_visual_distill`` needs; under ``use_clip_visual_query`` its
    spatial map also feeds the detector's content queries. Dropout in training
    draws its masks from ``dropout_generator``. The loss reads the global batch's
    statistics (:data:`STAT_KEYS`): those the batch carries from the ranks'
    host collective (``parallel/dist.py:step_stats``), which ``world_size``
    above 1 requires, else the batch's own; with the teacher's weak labels on
    a batch with ``is_extra``, those of the rewritten batch, reduced over the
    ranks of ``dist`` on the card. It is this rank's share of the
    loss of the global batch (each batch-global normaliser over
    ``world_size``). Under ``OptMatcher`` with the federated loss, the classes
    its queries were assigned are united over the ranks of ``dist``
    (``parallel/dist.py:union_``), a second collective of the step; under
    ``OptMatcher`` across more than one rank, each matched set's
    ``class_error`` sums its two counts over the ranks (``total_``)."""
    use_teacher = bool(getattr(cfg, "use_visual_distill", False))
    if use_teacher and clip_model is None:
        raise ValueError("use_visual_distill needs the CLIP teacher: pass clip_model "
                         "(models/build.py:build_clip_teacher)")
    distill_type = cfg.distill_type if use_teacher else ""
    objective = getattr(cfg, "clip_distill_objective", "gt")
    distill_aux = getattr(cfg, "distill_aux_layers", False)
    if distill_aux and objective != "gt":
        raise NotImplementedError("distill_aux_layers requires clip_distill_objective='gt'")
    use_clip_query = use_teacher and getattr(cfg, "use_clip_visual_query", False)
    weight_dict = build_weight_dict(cfg)
    use_dn = _use_dn(cfg)
    group_mode = use_dn and dn_group_mode(cfg)
    union = sum_counts = None
    if dist is not None and dist.active:
        union = functools.partial(union_, d=dist)
        if dist.world > 1:
            sum_counts = functools.partial(total_, d=dist)
    monitor_offsets = getattr(cfg, "monitor_msda_offsets", False)
    # the teacher's weak labels rewrite extra images' boxes on the device, past
    # the host's statistics
    weak_labels = use_teacher and bool(getattr(cfg, "use_imagenet_pusedo_labels", False))

    def teacher_targets(batch, text_embed):
        """-> the batch with ``clip_logits``, ``clip_embed``, ``clip_valid`` (and
        extra rows rewritten to the teacher's weak labels), and the spatial map."""
        spatial = clip_spatial_features(clip_model, batch["images"])
        clip_embed, clip_logits, clip_valid = clip_teacher_box_targets(
            clip_model, batch["images"], batch["boxes"], batch["size"].float(), text_embed,
            clip_model.logit_scale, valid=batch["valid"],
            max_boxes=getattr(cfg, "distill_max_boxes", 100), spatial=spatial)
        batch = dict(batch, clip_logits=clip_logits, clip_embed=clip_embed,
                     clip_valid=clip_valid)
        if cfg.use_imagenet_pusedo_labels and "is_extra" in batch:
            # every above-threshold (box, class) pair of an extra image becomes
            # a supervised slot, its teacher targets permuted along
            labels, boxes, keep, slot = clip_pseudo_labels_multi(
                clip_logits, batch["boxes"], batch["valid"], cfg.clip_pusedo_th,
                expand_topk=getattr(cfg, "clip_pusedo_topk", 4))
            extra = batch["is_extra"][:, None]
            batch["labels"] = torch.where(extra, labels, batch["labels"])
            batch["boxes"] = torch.where(extra[..., None], boxes, batch["boxes"])
            batch["valid"] = torch.where(extra, keep, batch["valid"])
            for key in ("clip_logits", "clip_embed"):
                sel = torch.gather(batch[key], 1,
                                   slot[..., None].expand(-1, -1, batch[key].shape[-1]))
                batch[key] = torch.where(extra[..., None], sel, batch[key])
            batch["clip_valid"] = torch.where(
                extra, torch.gather(batch["clip_valid"], 1, slot), batch["clip_valid"])
        return batch, spatial

    def global_stats(batch):
        """The global batch's statistics. Where the teacher rewrote extra
        images' labels and boxes, those of the rewritten batch: this rank's
        own, reduced over the ranks of ``dist`` on the card
        (``parallel/dist.py:reduce_stats_``), as JAX computes them inside its
        jit over the sharded batch. Else those the batch carries (the ranks'
        host collective), or the batch's own in one process. No statistic
        sets a shape or a host decision: CDN's pad is static in the GT slots
        (``models/dn.py:cdn_pad``) and its group-count branch a setting, as
        under JAX's jit."""
        if weak_labels and "is_extra" in batch:
            stats = tensor_stats(batch, cfg)
            if dist is not None and dist.active:
                return reduce_stats_(stats, dist, cfg.num_classes)
            if world_size > 1:
                raise ValueError("a data-parallel step with the teacher's weak labels needs "
                                 "its process group (dist) to reduce the statistics")
            return stats
        if STAT_KEYS[0] in batch:
            return {k: batch[k] for k in STAT_KEYS}
        if world_size > 1:
            raise ValueError("a data-parallel step needs the global batch statistics "
                             f"{STAT_KEYS} in the batch (parallel/dist.py:step_stats)")
        return tensor_stats(batch, cfg)

    def loss_fn(batch, draws, text_embed=None, dropout_generator=None):
        spatial = None
        if use_teacher:
            batch, spatial = teacher_targets(batch, text_embed)
        stats = global_stats(batch)
        dn_args, dn_meta = {}, None
        if use_dn:
            dn_labels, dn_boxes_unsig, dn_attn, dn_meta = prepare_cdn(
                batch["labels"], batch["boxes"], batch["valid"], draws["dn"],
                stats["gt_max"], dn_number=cfg.dn_number, label_noise_ratio=cfg.dn_label_noise_ratio,
                box_noise_scale=cfg.dn_box_noise_scale, num_queries=cfg.num_queries,
                check_pos_dn=cfg.check_pos_dn, group_mode=group_mode,
            )
            dn_args = dict(dn_labels=dn_labels, dn_boxes_unsig=dn_boxes_unsig,
                           dn_attn_mask=dn_attn)
            dn_meta = expand_dn_targets(batch["labels"], batch["boxes"], batch["valid"],
                                        dn_meta, gt_clip_logits=batch.get("clip_logits"),
                                        gt_clip_valid=batch.get("clip_valid"))
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed,
                        clip_features=spatial if use_clip_query else None, train=True,
                        dropout_generator=dropout_generator, **dn_args)
        if use_teacher and objective in ("pred", "pred_all"):
            # the teacher rescoring the predicted boxes (richsem.py:492-519)
            _, outputs["teacher_clip_logits"], _ = clip_teacher_box_targets(
                clip_model, batch["images"], outputs["pred_boxes"].detach(),
                batch["size"].float(), text_embed, clip_model.logit_scale, spatial=spatial)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid", "masks", "clip_logits",
                                         "clip_embed", "clip_valid") if k in batch}
        losses = set_criterion(
            outputs, targets, GlobalStats.of(stats, world_size, union, sum_counts), num_classes=cfg.num_classes,
            fed_uniforms=draws.get("fed_uniforms"), focal_alpha=cfg.focal_alpha,
            cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
            cost_giou=cfg.set_cost_giou, matcher_type=cfg.matcher_type,
            use_fed_loss=cfg.use_fed_loss, fed_num_sample_cats=cfg.fed_num_sample_cats,
            fed_weight=batch.get("fed_weight"),
            use_fed_on_kd=getattr(cfg, "use_fed_on_kd", False), distill_type=distill_type,
            clip_distill_objective=objective,
            use_dynamic_distill_weight=getattr(cfg, "use_dynamic_distill_weight", False),
            dn_meta=dn_meta, enc_cls_agn=getattr(cfg, "enc_cls_agn", False),
            distill_aux_layers=distill_aux,
        )
        weight_mask = None
        if batch.get("is_extra") is not None:
            keep = 1.0 - stats["extra_any"].float()
            weight_mask = {}
            if cfg.mask_bbox:
                weight_mask.update(loss_bbox=keep, loss_xy=keep, loss_hw=keep)
            if cfg.mask_giou:
                weight_mask["loss_giou"] = keep
            if cfg.mask_labels:
                weight_mask["loss_ce"] = keep
        total = weighted_loss(losses, weight_dict, weight_mask)
        if monitor_offsets and "offset_beyond_margin" in outputs:
            losses["offset_beyond_margin"] = outputs["offset_beyond_margin"]
        return total, losses

    return loss_fn


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms (and no benchmark) while the block
    runs, the caller's settings put back after. cuDNN picks a convolution's
    algorithms by its shapes, and for some (DETRsegm's at bs1) the weight
    gradient adds in no fixed order; under this the train step repeats bit
    for bit on every path."""
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev


@dataclasses.dataclass
class TrainState:
    """Step counter, the model (its parameters), the optimizer and the EMA."""

    step: int
    model: Any
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model, optimizer: AdamW, use_ema: bool = False) -> TrainState:
    return TrainState(0, model, optimizer, ema_init(model) if use_ema else None)


def eval_forward(model, cfg, batch, text_embed=None, clip_model=None) -> Dict[str, torch.Tensor]:
    """The eval step's body: inference forward + PostProcess. It runs as it is
    on the CPU; on the card a CUDA graph of it is replayed (:class:`EvalStep`).
    With ``use_clip_visual_query`` the teacher's spatial map of the images
    (``clip_model``) feeds the content queries, as in training. The mask head
    does not run: its output is not read, as XLA drops it from JAX's step."""
    clip_features = None
    if getattr(cfg, "use_clip_visual_query", False):
        clip_features = clip_spatial_features(clip_model, batch["images"])
    outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed,
                    clip_features=clip_features, mask_head=False)  # no mask output read
    return postprocess(
        outputs["pred_logits"], outputs["pred_boxes"], batch["orig_size"],
        num_select=cfg.num_select, nms_iou_threshold=cfg.nms_iou_threshold,
    )


DROPOUT_SEED = 1 << 40  # dropout's generator seeds apart from the draws' (TrainStep)
GRAPH_INPUTS = ("images", "pad_mask", "orig_size")  # the batch's fields the step reads


def graph_key(batch, text_embed=None) -> tuple:
    """What one CUDA graph of the eval step serves: the shapes and dtypes of
    the batch's inputs (batch size and canvas) and of the text bank, or its
    absence, and the device."""
    return (str(batch["images"].device),
            *((tuple(batch[k].shape), batch[k].dtype) for k in GRAPH_INPUTS),
            None if text_embed is None else (tuple(text_embed.shape), text_embed.dtype))


def captured_launches(counters: Dict[str, Any], capture: Callable[[], Any]) -> Dict[str, int]:
    """Run ``capture()`` (a CUDA graph's capture) and return how much each
    kernel wrapper's ``.launches`` rose meanwhile, with the counters put back:
    a capture records launches, the card runs none of them."""
    before = {k: c.launches for k, c in counters.items()}
    try:
        capture()
    finally:
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        for k, c in counters.items():
            c.launches = before[k]
    return delta


def add_launches(counters: Dict[str, Any], delta: Dict[str, int]) -> None:
    """Count a replay's launches: each wrapper's delta from its capture."""
    for k, n in delta.items():
        counters[k].launches += n


@dataclasses.dataclass
class _Graph:
    """One captured step: its graph, static inputs (the batch's fields, the
    draws and the text bank) and outputs, the launches it holds, the host ms
    of its warm-up and capture, and (train) the optimizer and EMA it updates."""

    graph: Any
    inputs: Dict[str, torch.Tensor]
    text: Optional[torch.Tensor]
    outputs: Dict[str, torch.Tensor]
    launches: Dict[str, int]
    capture_ms: float
    draws: Optional[Dict[str, Any]] = None
    bound: Tuple[Any, ...] = ()


class _Graphs:
    """The CUDA graphs of one step function, by key, in one memory pool."""

    def __init__(self):
        self.graphs: Dict[tuple, _Graph] = {}
        self._pool = None
        self.generators: Tuple[torch.Generator, ...] = ()

    def reset(self) -> None:
        """Drop every graph (and with the last one, the pool's memory)."""
        self.graphs.clear()
        self._pool = None

    @property
    def pool_bytes(self) -> int:
        """Device memory held by the graphs' shared pool: the allocator's
        segments of that pool (0 before the first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def _capture_into(self, key, what: str, body: Callable[[], Dict[str, torch.Tensor]]):
        """Capture ``body()`` into a new graph of the shared pool -> (graph, its
        outputs, the launches it holds); a failed capture raises with ``key``.
        ``self.generators`` (dropout's) are registered with the graph, so that
        a replay draws from their state at the replay."""
        try:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph, out = torch.cuda.CUDAGraph(), {}
            for gen in self.generators:
                graph.register_generator_state(gen)

            def capture():
                with torch.cuda.graph(graph, pool=self._pool):
                    out.update(body())

            launches = captured_launches(_step_counters(), capture)
        except Exception as e:
            raise RuntimeError(f"{what}: CUDA graph capture failed for key {key}") from e
        torch.cuda.synchronize()
        return graph, out, launches


def _on_card(batch) -> bool:
    """Whether a step on ``batch`` replays graphs (on the card) or runs as it is."""
    return batch["images"].device.type == "cuda"


def _side_stream_run(fn: Callable[[], Any]) -> Any:
    """``fn()`` on a side stream, waited for: a step's warm-up before its capture
    (cuBLAS, cuDNN and the allocator)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    return out


class EvalStep(_Graphs):
    """``eval_step(batch, text_embed=None)``: inference forward + PostProcess
    (:func:`eval_forward`), with the teacher's spatial pass under
    ``use_clip_visual_query`` (``clip_model``).

    On the card it keeps one ``torch.cuda.CUDAGraph`` for each
    :func:`graph_key`, as JAX compiles its jitted step once a shape. The first
    call for a key runs the body on a side stream to warm up, then captures it
    into static input buffers (all the step's graphs share one memory pool);
    every call copies the batch's inputs and the text bank into those buffers,
    replays, and returns clones of the outputs. A failed capture raises with
    its key. The graphs read the parameters' storage, so updates that copy
    into the parameters (the optimizer, the trainer's EMA swap, a checkpoint's
    ``load_state_dict``) are seen; a caller that rebinds a parameter tensor
    calls :meth:`reset`. The kernel wrappers count the launches a replay runs
    (their deltas at capture). On the CPU the body runs as it is.
    """

    def __init__(self, model, cfg, clip_model=None):
        super().__init__()
        self.model, self.cfg, self.clip_model = model, cfg, clip_model

    def _body(self, batch, text_embed):
        return eval_forward(self.model, self.cfg, batch, text_embed, self.clip_model)

    def __call__(self, batch, text_embed=None) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            if not _on_card(batch):
                return self._body(batch, text_embed)
            key = graph_key(batch, text_embed)
            g = self.graphs.get(key) or self._capture(key, batch, text_embed)
            for k, buf in g.inputs.items():
                buf.copy_(batch[k])
            if g.text is not None:
                g.text.copy_(text_embed)
            g.graph.replay()
            add_launches(_step_counters(), g.launches)
            return {k: v.clone() for k, v in g.outputs.items()}

    def _capture(self, key, batch, text_embed) -> _Graph:
        t0 = time.perf_counter()
        inputs = {k: batch[k].clone() for k in GRAPH_INPUTS}
        text = None if text_embed is None else text_embed.clone()
        _side_stream_run(lambda: self._body(inputs, text))
        graph, out, launches = self._capture_into(key, "eval step",
                                                  lambda: self._body(inputs, text))
        g = _Graph(graph, inputs, text, out, launches, (time.perf_counter() - t0) * 1e3)
        self.graphs[key] = g
        return g


# the batch's fields the train step reads (loss_fn), where present
TRAIN_INPUTS = ("images", "pad_mask", "labels", "boxes", "valid", "masks", "size",
                "is_extra", "fed_weight") + STAT_KEYS


def train_graph_key(batch, text_embed=None, ema: bool = False) -> tuple:
    """What one CUDA graph of the train step serves: the device, the shapes and
    dtypes of the batch fields the step reads (an absent one as absent), the
    text bank or its absence, and whether EMA is on."""
    return (str(batch["images"].device),
            *((k, None) if batch.get(k) is None else (k, tuple(batch[k].shape), batch[k].dtype)
              for k in TRAIN_INPUTS),
            None if text_embed is None else (tuple(text_embed.shape), text_embed.dtype),
            bool(ema))


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _tree_copy_(dst, src) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _tree_copy_(v, src[k])
        else:
            v.copy_(src[k])


class TrainStep(_Graphs):
    """``train_step(state, batch, text_embed=None, draws=None) -> metrics``;
    updates ``state`` in place (parameters, optimizer moments, EMA, step).

    A step is a host part and a device part, :meth:`body`. The host part
    draws the step's random numbers (:meth:`draws`, from a generator seeded
    with ``(seed, state.step)``, unless the caller passes them), writes the
    optimizer's lr and bias corrections into its device tensor
    (``AdamW.prepare``) and, after the body, advances the optimizer's count
    and ``state.step``. The body reads nothing that changes from step to step
    but tensors.

    On the CPU the two parts run as they are (:meth:`eager`). On the card the
    step keeps one ``torch.cuda.CUDAGraph`` of the body for each
    :func:`train_graph_key`, as JAX compiles its jitted step once a shape. The
    first call for a key is the step run eagerly on a side stream (the
    warm-up: its update lands once); the body is then captured into static
    buffers of the batch's fields, the draws and the text bank, which runs
    nothing. Every later call copies its inputs into those buffers, fills the
    optimizer's scalars, replays the graph, advances the counters and returns
    clones of the metrics (a caller may read them after the next replay). A
    failed capture raises with its key. All the graphs share one memory pool,
    which holds their gradients: after a capture ``.grad`` is ``None``, and an
    eager backward allocates its own. The graphs update the parameters,
    moments and EMA in place and read their storage, so whatever copies into
    them (a checkpoint's restore, the EMA swap) is seen; a caller that
    rebinds them (a new EMA dict) calls :meth:`reset`, and a call with
    another optimizer or EMA than the graph's raises. The kernel wrappers
    count a replay's launches (their deltas at capture).

    Under a process group (``dist``, ``parallel/dist.py``) the step is one
    rank's of a data-parallel step: its draws are its rows of the global
    batch's, its loss its share of the global loss (the batch carries the
    global statistics), and between the backward and the update one
    all-reduce averages every gradient the optimizer reads and the metrics
    (:meth:`_average`). Each call issues that collective exactly once: the
    warm-up runs it eagerly, the capture records it and launches nothing, and
    a replay runs the recorded one, so ranks may warm up and replay in the
    same step.

    Dropout in training (``cfg.dropout > 0``) draws its masks from the step's
    own generator, seeded in the host part from ``(seed, state.step)`` and
    the rank, and registered with each graph, so each replay draws anew.

    ``HungarianMatcherCPU`` reads the cost on the host, which a CUDA graph
    cannot hold: on the card such a step raises, naming the matcher, and the
    caller takes :meth:`eager` steps.
    """

    def __init__(self, model, cfg, seed: int = 0, device="cuda", clip_model=None,
                 dist: Optional[Dist] = None):
        super().__init__()
        self.model, self.cfg, self.seed, self.device = model, cfg, seed, device
        self.dist = dist or Dist()
        self.loss_fn = make_loss_fn(model, cfg, clip_model, world_size=self.dist.world,
                                    dist=self.dist)
        self.buffers = [b for _, b in frozen_leaves(model)]
        self.reduce_bytes = 0  # the averaged buffer's bytes, once a step has run
        self.dropout_generator = None
        if getattr(cfg, "dropout", 0.0) > 0:
            self.dropout_generator = torch.Generator(device=device)
            self.generators = (self.dropout_generator,)

    def _seed_dropout(self, state: TrainState) -> None:
        """Seed dropout's generator for this step (and rank)."""
        if self.dropout_generator is not None:
            self.dropout_generator.manual_seed(
                (self.seed * 1_000_003 + state.step) + DROPOUT_SEED * (1 + self.dist.rank))

    def draws(self, state: TrainState, batch_size: int, gt_slots: int = 0) -> Dict[str, Any]:
        """The step's draws, from a generator seeded with ``(seed, state.step)``:
        those of the global batch of ``batch_size`` images a rank (of
        ``gt_slots`` GT slots each), of which the rank keeps its own rows, so
        that N ranks draw what one process with the global batch draws."""
        g = torch.Generator(device=self.device).manual_seed(self.seed * 1_000_003 + state.step)
        d = self.dist
        draws = step_draws(self.cfg, batch_size * d.world, g, device=self.device,
                           gt_slots=gt_slots)
        if d.world > 1 and "dn" in draws:
            rows = slice(d.rank * batch_size, (d.rank + 1) * batch_size)
            draws["dn"] = {k: v[rows] for k, v in draws["dn"].items()}
        return draws

    def _average(self, opt: AdamW, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The data-parallel step's one collective: every gradient the
        optimizer reads (``None`` as zeros) and the metrics, copied into one
        flat f32 buffer (one multi-tensor copy), averaged over the ranks; each
        leaf's ``.grad`` becomes its view of the buffer. -> the averaged
        metrics."""
        leaves, names = opt.leaves(), list(metrics)
        flat = torch.empty(sum(t.numel() for t in leaves) + len(names), dtype=torch.float32,
                           device=leaves[0].device)
        views, dst, src, o = [], [], [], 0
        for t in leaves:
            views.append(flat[o:o + t.numel()].view_as(t))
            o += t.numel()
            if t.grad is None:
                views[-1].zero_()
            elif t.grad.dtype != torch.float32:
                raise TypeError(f"the gradient collective takes float32 gradients, not "
                                f"{t.grad.dtype}")
            else:
                dst.append(views[-1])
                src.append(t.grad)
        torch._foreach_copy_(dst, src)
        flat[o:].copy_(torch.stack([metrics[k].float().reshape(()) for k in names]))
        average_(flat, self.dist)
        self.reduce_bytes = flat.numel() * flat.element_size()
        for t, v in zip(leaves, views):
            t.grad = v
        return {k: flat[o + i] for i, k in enumerate(names)}

    def body(self, state: TrainState, batch, draws, text_embed=None) -> Dict[str, torch.Tensor]:
        """The device part: the loss and its backward (the FrozenBN tensors'
        gradients too, for the global norm), the optimizer's update, EMA and
        the metrics, under :func:`deterministic_convolutions`."""
        with deterministic_convolutions():
            return self._body(state, batch, draws, text_embed)

    def _body(self, state: TrainState, batch, draws, text_embed=None) -> Dict[str, torch.Tensor]:
        opt = state.optimizer
        opt.zero_grad()
        for b in self.buffers:  # gradients of the frozen tensors enter the global norm
            b.requires_grad_(True)
        try:
            kw = {} if self.dropout_generator is None else {
                "dropout_generator": self.dropout_generator}
            with exact_f32():  # f32 convolutions (the mask heads') without TF32, both ways
                total, losses = self.loss_fn(batch, draws, text_embed, **kw)
                total.backward()
        finally:
            for b in self.buffers:
                b.requires_grad_(False)
        terms = {"loss": total.detach()}
        terms.update({k: v.detach() for k, v in losses.items() if k in METRIC_KEYS})
        if self.dist.active:
            terms = self._average(opt, terms)
        gnorm = opt.update()
        if state.ema is not None:
            ema_update(state.ema, self.model, self.cfg.ema_decay)
        metrics = {"loss": terms.pop("loss"), "grad_norm": gnorm}
        metrics["finite"] = torch.isfinite(metrics["loss"])
        metrics.update(terms)
        return metrics

    def eager(self, state: TrainState, batch, text_embed=None, draws=None):
        """One step run as it is: the host part around :meth:`body`."""
        if draws is None:
            draws = self.draws(state, *batch["labels"].shape)
        state.optimizer.prepare()
        self._seed_dropout(state)
        metrics = self.body(state, batch, draws, text_embed)
        state.optimizer.advance()
        state.step += 1
        return metrics

    def __call__(self, state: TrainState, batch, text_embed=None, draws=None):
        if not _on_card(batch):
            return self.eager(state, batch, text_embed, draws)
        if self.cfg.matcher_type == "HungarianMatcherCPU":  # its host read: no graph
            raise RuntimeError(
                f"train step: matcher_type {self.cfg.matcher_type!r} reads the cost on the "
                "host, which a CUDA graph cannot hold; take eager steps (TrainStep.eager)")
        if draws is None:
            draws = self.draws(state, *batch["labels"].shape)
        key = train_graph_key(batch, text_embed, state.ema is not None)
        g = self.graphs.get(key)
        if g is None:
            return self._warm_up_and_capture(key, state, batch, text_embed, draws)
        if g.bound[0] is not state.optimizer or g.bound[1] is not state.ema:
            raise RuntimeError("train step: the optimizer or EMA was rebound since its graph "
                               "was captured; call reset() after rebinding them")
        for k, buf in g.inputs.items():
            buf.copy_(batch[k])
        _tree_copy_(g.draws, draws)
        if g.text is not None:
            g.text.copy_(text_embed)
        state.optimizer.prepare()
        self._seed_dropout(state)
        g.graph.replay()
        add_launches(_step_counters(), g.launches)
        state.optimizer.advance()
        state.step += 1
        return {k: v.clone() for k, v in g.outputs.items()}

    def _warm_up_and_capture(self, key, state, batch, text_embed, draws):
        t0 = time.perf_counter()
        inputs = {k: batch[k].clone() for k in TRAIN_INPUTS if batch.get(k) is not None}
        text = None if text_embed is None else text_embed.clone()
        static_draws = _tree_map(torch.clone, draws)
        metrics = _side_stream_run(lambda: self.eager(state, inputs, text, static_draws))
        try:
            graph, out, launches = self._capture_into(
                key, "train step", lambda: self.body(state, inputs, static_draws, text))
        finally:
            state.optimizer.zero_grad()  # the graph's gradients stay in its pool
        self.graphs[key] = _Graph(graph, inputs, text, out, launches,
                                  (time.perf_counter() - t0) * 1e3, static_draws,
                                  (state.optimizer, state.ema))
        return metrics


def make_train_step(model, cfg, seed: int = 0, device="cuda", clip_model=None,
                    dist: Optional[Dist] = None) -> TrainStep:
    """-> ``train_step(state, batch, text_embed=None, draws=None) -> metrics``.

    Updates ``state`` in place (parameters, optimizer moments, EMA, step).
    Without ``draws``, they come from a generator seeded with
    ``(seed, state.step)``. ``clip_model`` is the frozen teacher of
    ``use_visual_distill``; it is not trained. ``dist`` makes it one rank's
    step of a data-parallel step. See :class:`TrainStep`."""
    return TrainStep(model, cfg, seed, device, clip_model, dist)


def _launch_counters() -> Dict[str, Any]:
    from richsem_tpu_torch.bench import launch_counters

    return launch_counters()


def _step_counters() -> Dict[str, Any]:
    """The kernel wrappers' counters and the step's collectives'."""
    return dict(_launch_counters(), grad_average=average_, stats_gather=reduce_stats_)


def make_eval_step(model, cfg, clip_model=None) -> EvalStep:
    """Inference forward + PostProcess, a CUDA graph per shape on the card.

    The returned ``eval_step(batch, text_embed=None)`` takes ``batch`` with
    ``images [B,H,W,3]``, ``pad_mask [B,H,W]`` (True on padding) and
    ``orig_size [B,2]`` (h, w), and returns ``scores``, ``labels`` and
    ``boxes`` of ``[B, num_select]`` (boxes ``[B, num_select, 4]``, xyxy in
    image coordinates). Under ``use_clip_visual_query`` the teacher
    (``clip_model``) runs its spatial pass in the step, as in JAX's
    ``make_eval_step``. See :class:`EvalStep`.
    """
    if getattr(cfg, "use_clip_visual_query", False) and clip_model is None:
        raise ValueError("use_clip_visual_query eval needs the CLIP teacher at inference "
                         "(pass clip_model to make_eval_step)")
    return EvalStep(model, cfg, clip_model)
