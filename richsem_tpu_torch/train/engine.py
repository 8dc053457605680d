"""Train and eval steps (counterpart of ``richsem_tpu/train/engine.py``).

* :func:`make_loss_fn` -- CDN queries, the detector forward with ``train=True``,
  matching and the weighted loss, for the closed-vocabulary recipe (no CLIP
  teacher: ``use_visual_distill`` raises, ROADMAP.md queue 1, item 8).
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
``valid [B,G]`` bool, ``orig_size [B,2]``, optionally ``is_extra [B]`` bool.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.criterion import (
    build_weight_dict,
    expand_dn_targets,
    set_criterion,
    weighted_loss,
)
from richsem_tpu_torch.models.dn import cdn_draws, prepare_cdn
from richsem_tpu_torch.models.postprocess import postprocess
from richsem_tpu_torch.train.optim import AdamW, ema_init, ema_update, frozen_leaves

METRIC_KEYS = ("loss_ce", "loss_bbox", "loss_giou", "loss_ce_dn", "loss_distill",
               "class_error", "cardinality_error", "offset_beyond_margin")


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


def make_loss_fn(model, cfg) -> Callable[..., Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """-> ``loss_fn(batch, draws, text_embed=None) -> (total, losses)``."""
    if getattr(cfg, "use_visual_distill", False):
        raise NotImplementedError(
            "the CLIP teacher and distillation are not ported yet (ROADMAP.md queue 1, "
            "item 8)")
    if getattr(cfg, "use_clip_visual_query", False):
        raise NotImplementedError(
            "use_clip_visual_query needs the CLIP teacher (ROADMAP.md queue 1, item 8)")
    weight_dict = build_weight_dict(cfg)
    use_dn = _use_dn(cfg)
    monitor_offsets = getattr(cfg, "monitor_msda_offsets", False)
    if use_dn and 0 < cfg.dn_number < 50 and not getattr(cfg, "dn_force_budget", False):
        raise NotImplementedError(
            "the CDN group-count branch (dn_number < 50) is not ported yet "
            "(ROADMAP.md queue 1, item 11)")

    def loss_fn(batch, draws, text_embed=None):
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
                                        dn_meta)
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed,
                        train=True, **dn_args)
        targets = {k: batch[k] for k in ("labels", "boxes", "valid")}
        losses = set_criterion(
            outputs, targets, num_classes=cfg.num_classes,
            fed_uniforms=draws.get("fed_uniforms"), focal_alpha=cfg.focal_alpha,
            cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
            cost_giou=cfg.set_cost_giou, matcher_type=cfg.matcher_type,
            use_fed_loss=cfg.use_fed_loss, fed_num_sample_cats=cfg.fed_num_sample_cats,
            fed_weight=batch.get("fed_weight"), dn_meta=dn_meta,
            enc_cls_agn=getattr(cfg, "enc_cls_agn", False),
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


def make_train_step(model, cfg, seed: int = 0, device="cuda"):
    """-> ``train_step(state, batch, text_embed=None, draws=None) -> metrics``.

    Updates ``state`` in place (parameters, optimizer moments, EMA, step).
    Without ``draws``, they come from a generator seeded with
    ``(seed, state.step)``."""
    loss_fn = make_loss_fn(model, cfg)
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
            "use_clip_visual_query eval needs the CLIP teacher, which is not "
            "ported yet (ROADMAP.md queue 1, item 8)"
        )

    @torch.inference_mode()
    def eval_step(batch, text_embed=None):
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        return postprocess(
            outputs["pred_logits"], outputs["pred_boxes"], batch["orig_size"],
            num_select=cfg.num_select, nms_iou_threshold=cfg.nms_iou_threshold,
        )

    return eval_step
