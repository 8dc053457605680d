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
  pass the draws in instead.
* :func:`make_eval_step` -- inference forward + PostProcess.

Batch layout: ``images [B,H,W,3]`` f32, ``pad_mask [B,H,W]`` bool (True on
padding), ``labels [B,G]`` int, ``boxes [B,G,4]`` normalized cxcywh,
``valid [B,G]`` bool, ``orig_size [B,2]``, optionally ``is_extra [B]`` bool;
with the teacher also ``size [B,2]``, the valid (h, w) of each image in the
canvas, by which the normalized boxes are scaled for the RoI crops.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.clip_align import (
    clip_pseudo_labels_multi,
    clip_spatial_features,
    clip_teacher_box_targets,
)
from richsem_tpu_torch.models.criterion import (
    build_weight_dict,
    expand_dn_targets,
    set_criterion,
    weighted_loss,
)
from richsem_tpu_torch.models.dn import cdn_draws, prepare_cdn
from richsem_tpu_torch.models.postprocess import postprocess
from richsem_tpu_torch.train.optim import AdamW, ema_init, ema_update, frozen_leaves

# JAX's metric keys (engine.py:301-311), and the DN distillation term
METRIC_KEYS = ("loss_ce", "loss_bbox", "loss_giou", "loss_ce_dn", "loss_distill",
               "loss_distill_dn", "class_error", "cardinality_error", "offset_beyond_margin")


def _use_dn(cfg) -> bool:
    return bool(cfg.use_dn and cfg.dn_number > 0)


def step_draws(cfg, batch_size: int, generator: torch.Generator,
               device="cuda") -> Dict[str, Any]:
    """One step's random draws: ``dn`` (the four CDN tensors, with DN on) and
    ``fed_uniforms [16, C]`` (with the federated loss on)."""
    draws: Dict[str, Any] = {}
    if _use_dn(cfg):
        draws["dn"] = cdn_draws(batch_size, cfg.dn_number, cfg.num_classes, generator,
                                device=device)
    if cfg.use_fed_loss:
        draws["fed_uniforms"] = torch.rand((16, cfg.num_classes), generator=generator,
                                           device=device)
    return draws


def make_loss_fn(model, cfg, clip_model=None
                 ) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """-> ``loss_fn(batch, draws, text_embed=None) -> (total, losses)``.

    ``clip_model`` is the frozen teacher (``models/build.py:build_clip_teacher``),
    which ``use_visual_distill`` needs."""
    if getattr(cfg, "use_clip_visual_query", False):
        raise NotImplementedError(
            "use_clip_visual_query is not ported to richsem_tpu_torch yet (ROADMAP.md "
            "queue 1, item 11)")
    use_teacher = bool(getattr(cfg, "use_visual_distill", False))
    if use_teacher and clip_model is None:
        raise ValueError("use_visual_distill needs the CLIP teacher: pass clip_model "
                         "(models/build.py:build_clip_teacher)")
    distill_type = cfg.distill_type if use_teacher else ""
    objective = getattr(cfg, "clip_distill_objective", "gt")
    weight_dict = build_weight_dict(cfg)
    use_dn = _use_dn(cfg)
    monitor_offsets = getattr(cfg, "monitor_msda_offsets", False)
    if use_dn and 0 < cfg.dn_number < 50 and not getattr(cfg, "dn_force_budget", False):
        raise NotImplementedError(
            "the CDN group-count branch (dn_number < 50) is not ported yet "
            "(ROADMAP.md queue 1, item 11)")

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

    def loss_fn(batch, draws, text_embed=None):
        if use_teacher:
            batch, spatial = teacher_targets(batch, text_embed)
        dn_args, dn_meta = {}, None
        if use_dn:
            dn_labels, dn_boxes_unsig, dn_attn, dn_meta = prepare_cdn(
                batch["labels"], batch["boxes"], batch["valid"], draws["dn"],
                dn_number=cfg.dn_number, label_noise_ratio=cfg.dn_label_noise_ratio,
                box_noise_scale=cfg.dn_box_noise_scale, num_queries=cfg.num_queries,
                check_pos_dn=cfg.check_pos_dn,
            )
            dn_args = dict(dn_labels=dn_labels, dn_boxes_unsig=dn_boxes_unsig,
                           dn_attn_mask=dn_attn)
            dn_meta = expand_dn_targets(batch["labels"], batch["boxes"], batch["valid"],
                                        dn_meta, gt_clip_logits=batch.get("clip_logits"),
                                        gt_clip_valid=batch.get("clip_valid"))
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed,
                        train=True, **dn_args)
        if use_teacher and objective in ("pred", "pred_all"):
            # the teacher rescoring the predicted boxes (richsem.py:492-519)
            _, outputs["teacher_clip_logits"], _ = clip_teacher_box_targets(
                clip_model, batch["images"], outputs["pred_boxes"].detach(),
                batch["size"].float(), text_embed, clip_model.logit_scale, spatial=spatial)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid", "clip_logits",
                                         "clip_embed", "clip_valid") if k in batch}
        losses = set_criterion(
            outputs, targets, num_classes=cfg.num_classes,
            fed_uniforms=draws.get("fed_uniforms"), focal_alpha=cfg.focal_alpha,
            cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
            cost_giou=cfg.set_cost_giou, matcher_type=cfg.matcher_type,
            use_fed_loss=cfg.use_fed_loss, fed_num_sample_cats=cfg.fed_num_sample_cats,
            fed_weight=batch.get("fed_weight"),
            use_fed_on_kd=getattr(cfg, "use_fed_on_kd", False), distill_type=distill_type,
            clip_distill_objective=objective,
            use_dynamic_distill_weight=getattr(cfg, "use_dynamic_distill_weight", False),
            dn_meta=dn_meta, enc_cls_agn=getattr(cfg, "enc_cls_agn", False),
            distill_aux_layers=getattr(cfg, "distill_aux_layers", False),
        )
        weight_mask = None
        if batch.get("is_extra") is not None:
            keep = 1.0 - batch["is_extra"].any().float()
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


@dataclasses.dataclass
class TrainState:
    """Step counter, the model (its parameters), the optimizer and the EMA."""

    step: int
    model: Any
    optimizer: AdamW
    ema: Optional[Dict[str, torch.Tensor]] = None


def create_train_state(model, optimizer: AdamW, use_ema: bool = False) -> TrainState:
    return TrainState(0, model, optimizer, ema_init(model) if use_ema else None)


def make_train_step(model, cfg, seed: int = 0, device="cuda", clip_model=None):
    """-> ``train_step(state, batch, text_embed=None, draws=None) -> metrics``.

    Updates ``state`` in place (parameters, optimizer moments, EMA, step).
    Without ``draws``, they come from a generator seeded with
    ``(seed, state.step)``. ``clip_model`` is the frozen teacher of
    ``use_visual_distill``; it is not trained."""
    loss_fn = make_loss_fn(model, cfg, clip_model)
    buffers = [b for _, b in frozen_leaves(model)]

    def train_step(state: TrainState, batch, text_embed=None, draws=None):
        if draws is None:
            g = torch.Generator(device=device).manual_seed(seed * 1_000_003 + state.step)
            draws = step_draws(cfg, batch["labels"].shape[0], g, device=device)
        opt = state.optimizer
        opt.zero_grad()
        for b in buffers:  # gradients of the frozen tensors enter the global norm
            b.requires_grad_(True)
        try:
            total, losses = loss_fn(batch, draws, text_embed)
            total.backward()
        finally:
            for b in buffers:
                b.requires_grad_(False)
        gnorm = opt.step()
        if state.ema is not None:
            ema_update(state.ema, model, cfg.ema_decay)
        state.step += 1
        metrics = {"loss": total.detach(), "grad_norm": gnorm,
                   "finite": torch.isfinite(total.detach())}
        metrics.update({k: v.detach() for k, v in losses.items() if k in METRIC_KEYS})
        return metrics

    return train_step


def make_eval_step(model, cfg) -> Callable[..., Dict[str, torch.Tensor]]:
    """Inference forward + PostProcess.

    The returned ``eval_step(batch, text_embed=None)`` takes ``batch`` with
    ``images [B,H,W,3]``, ``pad_mask [B,H,W]`` (True on padding) and
    ``orig_size [B,2]`` (h, w), and returns ``scores``, ``labels`` and
    ``boxes`` of ``[B, num_select]`` (boxes ``[B, num_select, 4]``, xyxy in
    image coordinates).
    """
    if getattr(cfg, "use_clip_visual_query", False):
        raise NotImplementedError(
            "use_clip_visual_query eval is not ported to richsem_tpu_torch yet "
            "(ROADMAP.md queue 1, item 11)"
        )

    @torch.inference_mode()
    def eval_step(batch, text_embed=None):
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        return postprocess(
            outputs["pred_logits"], outputs["pred_boxes"], batch["orig_size"],
            num_select=cfg.num_select, nms_iou_threshold=cfg.nms_iou_threshold,
        )

    return eval_step
