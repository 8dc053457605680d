"""Set-prediction criterion (counterpart of ``richsem_tpu/models/criterion.py``).

The parts the closed-vocabulary DINO recipe runs: matching, focal and
federated classification loss, L1/GIoU, the ``loss_xy``/``loss_hw``,
``cardinality_error`` and ``class_error`` diagnostics (computed without
gradient, where JAX stops it), and the aux, interm and DN sets, over padded
targets (``labels [B,G]``, ``boxes [B,G,4]``, ``valid [B,G]``). The loss-weight
matrix (:func:`build_weight_dict`) and :func:`weighted_loss` follow the JAX
ones key for key.

The federated loss samples classes by a Gumbel top-k. JAX draws its 16
uniform vectors from ``jax.random.split(rng, 16)`` (``criterion.py:489``);
here they are one ``[16, C]`` tensor, ``fed_uniforms``, row ``i`` for split
``i``: 0 the final layer, 1 the DN final layer, 2+i the DN aux layers, 8+i
the aux layers, 14 the interm set.

The distillation terms of the flagship (``criterion.py:281-340``):
``loss_distill``, KL(teacher || student) of the CLIP logits on the matched
queries of the final layer (objective ``gt``: the teacher at the GT boxes;
``pred`` / ``pred_all``: the teacher at the predicted boxes), or the L1 of the
normalized embeddings (``clip_l1``); ``loss_distill_dn`` on the positive DN
queries; optionally restricted to the federated-loss classes of the same set
(``use_fed_on_kd``) and weighted by the teacher's entropy
(``use_dynamic_distill_weight``).

The many-to-one OptMatcher layout, ``distill_aux_layers`` and the mask
losses raise ``NotImplementedError`` naming the ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.matcher import match
from richsem_tpu_torch.utils import boxes as box_ops
from richsem_tpu_torch.utils.misc import l2_normalize

Tensor = torch.Tensor


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to richsem_tpu_torch yet (ROADMAP.md queue 1, {item})")


def fed_loss_classes(
    uniforms: Tensor,  # [C] uniform in [0, 1)
    matched_labels: Tensor,  # [N], -1 for invalid
    num_classes: int,
    num_sample_cats: int,
    fed_weight: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """-> ``(ids [W], mask [W])``: every appeared class, then classes sampled
    proportionally to ``fed_weight`` without replacement (Gumbel top-k), up to
    ``max(num_sample_cats, n_appeared)`` active entries of ``W = min(C,
    max(num_sample_cats, N))``. Ties keep JAX ``top_k``'s order (lower index
    first)."""
    n = matched_labels.numel()
    num_sample_cats = min(num_sample_cats, num_classes)
    width = min(num_classes, max(num_sample_cats, n))
    dev = matched_labels.device
    appeared = torch.zeros(num_classes, dtype=torch.bool, device=dev)
    appeared[matched_labels[matched_labels >= 0].long()] = True
    gumbel = -torch.log(-torch.log(uniforms.float() + 1e-20) + 1e-20)
    if fed_weight is None:
        fed_weight = torch.ones(num_classes, dtype=torch.float32, device=dev)
    score = torch.log(fed_weight.float().clamp(min=1e-20)) + gumbel
    score = torch.where(appeared, score.new_tensor(1e9), score)
    ids = torch.sort(score, descending=True, stable=True).indices[:width]
    keep = torch.clamp(appeared.sum(), min=num_sample_cats)
    mask = torch.arange(width, device=dev) < keep
    return ids, mask


def _sigmoid_focal(logits: Tensor, onehot: Tensor, alpha: float, gamma: float) -> Tensor:
    p = torch.sigmoid(logits)
    ce = logits.clamp(min=0) - logits * onehot + torch.log1p(torch.exp(-logits.abs()))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * onehot + (1 - alpha) * (1 - onehot)) * loss
    return loss


def loss_labels(
    pred_logits: Tensor,  # [B, Q, C]
    col: Tensor,  # [B, G] matched query per GT (-1 invalid)
    gt_labels: Tensor,
    gt_valid: Tensor,
    num_boxes: Tensor,
    focal_alpha: float = 0.25,
    fed_ids: Optional[Tuple[Tensor, Tensor]] = None,
    query_mask: Optional[Tensor] = None,  # [B, Q] queries to supervise
) -> Dict[str, Tensor]:
    b, q, c = pred_logits.shape
    logits = pred_logits.float()
    hit = gt_valid & (col >= 0)
    onehot = torch.zeros((b, q + 1, c), dtype=torch.float32, device=logits.device)
    bidx = torch.arange(b, device=col.device)[:, None].expand_as(col)
    col_safe = torch.where(hit, col, q)
    onehot[bidx, col_safe, gt_labels.clamp(min=0).long()] = hit.float()
    onehot = onehot[:, :q]
    fed_mask = None
    if fed_ids is not None:
        ids, fed_mask = fed_ids
        logits, onehot = logits[..., ids], onehot[..., ids]
    focal = _sigmoid_focal(logits, onehot, focal_alpha, 2.0)
    if fed_mask is not None:
        focal = focal * fed_mask.float()
    if query_mask is not None:
        focal = focal * query_mask[..., None].float()
    out = {"loss_ce": focal.sum() / num_boxes}
    with torch.no_grad():
        matched = torch.gather(pred_logits, 1,
                               col.clamp(min=0)[..., None].expand(-1, -1, c))
        ok = (matched.argmax(-1) == gt_labels) & hit
        out["class_error"] = 100.0 * (1.0 - ok.sum() / hit.sum().clamp(min=1))
    return out


def loss_boxes(pred_boxes: Tensor, col: Tensor, gt_boxes: Tensor, gt_valid: Tensor,
               num_boxes: Tensor) -> Dict[str, Tensor]:
    sel = torch.gather(pred_boxes.float(), 1, col.clamp(min=0)[..., None].expand(-1, -1, 4))
    m = (gt_valid & (col >= 0)).float()
    l1 = (sel - gt_boxes.float()).abs()
    giou = box_ops.generalized_box_iou_elementwise(
        box_ops.box_cxcywh_to_xyxy(sel), box_ops.box_cxcywh_to_xyxy(gt_boxes.float()))
    out = {
        "loss_bbox": (l1.sum(-1) * m).sum() / num_boxes,
        "loss_giou": ((1.0 - giou) * m).sum() / num_boxes,
    }
    with torch.no_grad():
        out["loss_xy"] = (l1[..., :2].sum(-1) * m).sum() / num_boxes
        out["loss_hw"] = (l1[..., 2:].sum(-1) * m).sum() / num_boxes
    return out


@torch.no_grad()
def loss_cardinality(pred_logits: Tensor, gt_valid: Tensor) -> Tensor:
    card = (pred_logits.argmax(-1) != pred_logits.shape[-1] - 1).sum(1)
    return (card.float() - gt_valid.sum(1).float()).abs().mean()


def _kl_terms(student_logits: Tensor, teacher_logits: Tensor, dynamic_weight: bool,
              fed_ids: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """Per-row KL(teacher || student), optionally over the federated classes only
    and weighted by the teacher's entropy over all classes (taken before the
    restriction, as the reference does)."""
    s = student_logits.float()
    t_logits = teacher_logits.float()
    weight = None
    if dynamic_weight:
        t_full = torch.softmax(t_logits, -1)
        ent = -(t_full * torch.log(t_full.clamp(min=1e-20))).sum(-1, keepdim=True)
        weight = ent / math.log(t_logits.shape[-1]) * 2.0
    if fed_ids is not None:
        ids, mask = fed_ids
        # masked tail slots must not enter the class softmax
        s = torch.where(mask, s[..., ids], -1e9)
        t_logits = torch.where(mask, t_logits[..., ids], -1e9)
    log_p = torch.log_softmax(s, -1)
    t = torch.softmax(t_logits, -1)
    kl = t * (torch.log(t.clamp(min=1e-20)) - log_p)
    if weight is not None:
        kl = kl * weight
    return kl.sum(-1)


def _at(x: Tensor, col: Tensor) -> Tensor:
    """``x [B, Q, C]`` at the matched query of each GT slot -> ``[B, G, C]``."""
    return torch.gather(x, 1, col.clamp(min=0)[..., None].expand(-1, -1, x.shape[-1]))


def distill_loss_kl(pred_clip_logits: Tensor, col: Tensor, gt_valid: Tensor,
                    tgt_clip_logits: Tensor, num_boxes: Tensor, dynamic_weight: bool = False,
                    fed_ids: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """KL on the matched queries against the teacher at the GT boxes
    (``distill_type='clip_logits'``, objective ``gt``)."""
    kl = _kl_terms(_at(pred_clip_logits.float(), col), tgt_clip_logits, dynamic_weight, fed_ids)
    m = (gt_valid & (col >= 0)).float()
    return (kl * m).sum() / num_boxes


def distill_loss_kl_pred(pred_clip_logits: Tensor, teacher_clip_logits: Tensor, col: Tensor,
                         gt_valid: Tensor, num_boxes: Tensor, objective: str,
                         dynamic_weight: bool = False,
                         fed_ids: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """KL against the teacher at the predicted boxes: ``pred`` on the matched
    queries over ``num_boxes``, ``pred_all`` on every query over ``B * Q``."""
    if objective == "pred":
        kl = _kl_terms(_at(pred_clip_logits, col), _at(teacher_clip_logits, col),
                       dynamic_weight, fed_ids)
        m = (gt_valid & (col >= 0)).float()
        return (kl * m).sum() / num_boxes
    b, nq = pred_clip_logits.shape[:2]
    kl = _kl_terms(pred_clip_logits, teacher_clip_logits, dynamic_weight, fed_ids)
    return kl.sum() / (b * nq)


def distill_loss_l1(pred_clip_embed: Tensor, col: Tensor, gt_valid: Tensor,
                    tgt_clip_embed: Tensor, num_boxes: Tensor) -> Tensor:
    """L1 between normalized embeddings (``distill_type='clip_l1'``)."""
    sel = l2_normalize(_at(pred_clip_embed.float(), col))
    m = (gt_valid & (col >= 0)).float()
    l1 = (sel - tgt_clip_embed.float()).abs().sum(-1)
    return (l1 * m).sum() / num_boxes


def set_criterion(
    outputs: Dict[str, Any],
    targets: Dict[str, Tensor],
    num_classes: int,
    fed_uniforms: Optional[Tensor] = None,  # [16, C], see the module docstring
    focal_alpha: float = 0.25,
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    matcher_type: str = "HungarianMatcher",
    use_fed_loss: bool = False,
    fed_num_sample_cats: int = 50,
    fed_weight: Optional[Tensor] = None,
    use_fed_on_kd: bool = False,
    distill_type: str = "",
    clip_distill_objective: str = "gt",
    use_dynamic_distill_weight: bool = False,
    dn_meta: Optional[Dict[str, Tensor]] = None,
    enc_cls_agn: bool = False,
    distill_aux_layers: bool = False,
) -> Dict[str, Tensor]:
    """-> unweighted loss dict with the reference's naming (``loss_ce``,
    ``loss_bbox``, ``loss_giou``, ``loss_distill``, ``*_dn``, ``*_0..k``,
    ``*_interm`` and the diagnostics). Combine with :func:`weighted_loss`.

    Distillation reads ``targets["clip_logits"]`` (``clip_embed`` for
    ``clip_l1``) and ``clip_valid``, ``outputs["teacher_clip_logits"]`` for
    the ``pred`` objectives, and ``pos_clip_logits`` / ``pos_clip_valid`` of
    ``dn_meta`` (:func:`expand_dn_targets`)."""
    if distill_aux_layers:
        raise _not_ported("distill_aux_layers", "item 11")
    if matcher_type == "OptMatcher":
        raise _not_ported("the OptMatcher many-to-one layout", "item 11")
    if "masks" in targets or "pred_masks" in outputs or "mask_params" in outputs:
        raise _not_ported("mask losses", "item 11")
    if enc_cls_agn:
        raise _not_ported("enc_cls_agn", "item 11")
    if use_fed_loss and fed_uniforms is None:
        raise ValueError("the federated loss needs fed_uniforms [16, num_classes]")
    gt_labels, gt_boxes, gt_valid = targets["labels"], targets["boxes"], targets["valid"]
    num_boxes = gt_valid.sum().float().clamp(min=1.0)

    def run_matcher(out_set):
        return match(out_set["pred_logits"], out_set["pred_boxes"], gt_labels, gt_boxes,
                     gt_valid, cost_class, cost_bbox, cost_giou, focal_alpha,
                     matcher_type=matcher_type)

    def fed_ids_for(i, col, labels=None, valid=None):
        if not use_fed_loss:
            return None
        labels = gt_labels if labels is None else labels
        valid = gt_valid if valid is None else valid
        matched = torch.where(valid & (col >= 0), labels, -1).reshape(-1)
        return fed_loss_classes(fed_uniforms[i], matched, num_classes,
                                fed_num_sample_cats, fed_weight)

    has_distill = distill_type in ("clip_logits", "clip_l1") and (
        "pred_clip_logits" in outputs or "pred_clip_embed" in outputs)
    clip_valid = targets.get("clip_valid", gt_valid)

    def one_set(out_set, i, col, include_distill=False):
        fids = fed_ids_for(i, col)
        d = loss_labels(out_set["pred_logits"], col, gt_labels, gt_valid, num_boxes,
                        focal_alpha, fids)
        d.update(loss_boxes(out_set["pred_boxes"], col, gt_boxes, gt_valid, num_boxes))
        d["cardinality_error"] = loss_cardinality(out_set["pred_logits"], gt_valid)
        kd_fids = fids if use_fed_on_kd else None
        if include_distill and distill_type == "clip_logits":
            if clip_distill_objective == "gt":
                d["loss_distill"] = distill_loss_kl(
                    out_set["pred_clip_logits"], col, clip_valid, targets["clip_logits"],
                    num_boxes, use_dynamic_distill_weight, kd_fids)
            else:
                d["loss_distill"] = distill_loss_kl_pred(
                    out_set["pred_clip_logits"], outputs["teacher_clip_logits"], col,
                    gt_valid, num_boxes, clip_distill_objective,
                    use_dynamic_distill_weight, kd_fids)
        elif include_distill and distill_type == "clip_l1":
            d["loss_distill"] = distill_loss_l1(out_set["pred_clip_embed"], col, clip_valid,
                                                targets["clip_embed"], num_boxes)
        return d

    losses: Dict[str, Tensor] = dict(one_set(outputs, 0, run_matcher(outputs), has_distill))

    if dn_meta is not None and "dn_outputs" in outputs:
        dn_out = outputs["dn_outputs"]
        dn_col = dn_slot_indices(dn_meta)
        dn_nb = num_boxes * dn_meta["num_groups"]
        pos_valid, qmask = dn_meta["pos_valid"], dn_meta["slot_in_use"]
        dn_sets = [(dn_out, "_dn", 1)] + [
            (aux, f"_dn_{i}", 2 + i) for i, aux in enumerate(dn_out.get("aux_outputs", []))]
        for out_set, suffix, i in dn_sets:
            fids = fed_ids_for(i, dn_col, dn_meta["pos_labels"], pos_valid)
            d = loss_labels(out_set["pred_logits"], dn_col, dn_meta["pos_labels"],
                            pos_valid, dn_nb, focal_alpha, fids, query_mask=qmask)
            d.update(loss_boxes(out_set["pred_boxes"], dn_col, dn_meta["pos_boxes"],
                                pos_valid, dn_nb))
            if (i == 1 and has_distill and distill_type == "clip_logits"
                    and "pred_clip_logits" in out_set):
                # the same federated classes as the DN focal loss (use_fed_on_kd)
                d["loss_distill"] = distill_loss_kl(
                    out_set["pred_clip_logits"], dn_col,
                    dn_meta.get("pos_clip_valid", pos_valid), dn_meta["pos_clip_logits"],
                    dn_nb, use_dynamic_distill_weight, fids if use_fed_on_kd else None)
            losses.update({f"{k}{suffix}": v for k, v in d.items()})

    for i, aux in enumerate(outputs.get("aux_outputs", [])):
        d = one_set(aux, 8 + i, run_matcher(aux))
        losses.update({f"{k}_{i}": v for k, v in d.items()})

    if "interm_outputs" in outputs:
        interm = outputs["interm_outputs"]
        d = one_set(interm, 14, run_matcher(interm))
        losses.update({f"{k}_interm": v for k, v in d.items()})
    return losses


def dn_slot_indices(dn_meta: Dict[str, Tensor]) -> Tensor:
    """Fabricated DN matching: the positive slot of each supervised row."""
    return dn_meta["pos_slots"]


def expand_dn_targets(gt_labels: Tensor, gt_boxes: Tensor, gt_valid: Tensor,
                      dn_meta: Dict[str, Tensor], gt_clip_logits: Optional[Tensor] = None,
                      gt_clip_valid: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Each positive DN slot becomes its own supervised row: adds ``pos_slots``,
    ``pos_labels``, ``pos_boxes`` and ``pos_valid`` ([B, P]) to ``dn_meta``, and
    with the teacher's targets ``pos_clip_logits`` [B, P, C] and
    ``pos_clip_valid`` (the slots whose GT got a target)."""
    match_gt = dn_meta["match_gt"]
    b, p = match_gt.shape
    valid = match_gt >= 0
    safe = match_gt.clamp(min=0)
    out = dict(dn_meta)
    slots = torch.arange(p, device=match_gt.device)[None].expand(b, p)
    out["pos_slots"] = torch.where(valid, slots, -1)
    out["pos_labels"] = torch.gather(gt_labels, 1, safe)
    out["pos_boxes"] = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    out["pos_valid"] = valid & torch.gather(gt_valid, 1, safe)
    if gt_clip_logits is not None:
        out["pos_clip_logits"] = torch.gather(
            gt_clip_logits, 1, safe[..., None].expand(-1, -1, gt_clip_logits.shape[-1]))
        if gt_clip_valid is not None:
            out["pos_clip_valid"] = out["pos_valid"] & torch.gather(gt_clip_valid, 1, safe)
    return out


def build_weight_dict(cfg) -> Dict[str, float]:
    """The reference's weight-dict naming matrix (``criterion.py:722-755``)."""
    base = {"loss_ce": cfg.cls_loss_coef, "loss_bbox": cfg.bbox_loss_coef,
            "loss_giou": cfg.giou_loss_coef}
    wd = dict(base)
    if getattr(cfg, "masks", False):
        wd["loss_mask"] = cfg.mask_loss_coef
        wd["loss_dice"] = cfg.dice_loss_coef
    use_distill = getattr(cfg, "use_visual_distill", False)
    if cfg.use_dn:
        wd.update({f"{k}_dn": v for k, v in base.items()})
        if use_distill:
            wd["loss_distill_dn"] = cfg.distill_loss_coef
    if use_distill:
        wd["loss_distill"] = cfg.distill_loss_coef
    clean = dict(wd)
    if cfg.aux_loss:
        for i in range(cfg.dec_layers - 1):
            wd.update({f"{k}_{i}": v for k, v in clean.items()})
    if cfg.two_stage_type != "no":
        box_on = 0.0 if cfg.no_interm_box_loss else 1.0
        coeff = {"loss_ce": 1.0, "loss_bbox": box_on, "loss_giou": box_on}
        wd.update({f"{k}_interm": v * cfg.interm_loss_coef * coeff[k]
                   for k, v in base.items()})
    return wd


def weighted_loss(losses: Dict[str, Tensor], weight_dict: Dict[str, float],
                  weight_mask: Optional[Dict[str, Tensor]] = None) -> Tensor:
    """sum_k w_k * loss_k; ``weight_mask`` multiplies the weights of keys with a
    given prefix (the extra-data masking hook)."""
    total = None
    for k, w in weight_dict.items():
        if k not in losses:
            continue
        term = losses[k] * w
        for prefix, m in (weight_mask or {}).items():
            if k.startswith(prefix):
                term = term * m
                break
        total = term if total is None else total + term
    return total if total is not None else torch.zeros(())
