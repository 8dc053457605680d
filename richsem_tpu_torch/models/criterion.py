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

Under ``matcher_type="OptMatcher"`` every matched set takes the many-to-one
layout (``criterion.py:170-240``): simOTA (:mod:`richsem_tpu_torch.models.ota_matcher`)
gives each query its GT, ``gt_of_query [B, Q]`` (-1 background), and the
focal, box and distillation losses run over the assigned queries
(:func:`loss_labels_m2o`, :func:`loss_boxes_m2o`), normalised by the global
valid GT count; the DN sets keep their fabricated one-to-one matching.
``distill_aux_layers`` distills every aux decoder layer as the final one, and
``enc_cls_agn`` matches and supervises the interm set with every label 0
(its federated classes from split 15).

The mask losses (``criterion.py:494-558``) supervise the final set's matched
queries when the targets carry ``masks [B, G, H/8, W/8]``: DETRsegm's
``pred_masks`` through :func:`~richsem_tpu_torch.models.segmentation.loss_masks`,
or CondInst's dynamic networks instantiated at the matched queries
(``mask_feats``, ``mask_params`` and the predicted centres, detached as JAX
stops their gradient). Under ``OptMatcher`` they raise JAX's
``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from richsem_tpu_torch.models.cond_inst import box_centers_px, dynamic_mask_logits
from richsem_tpu_torch.models.matcher import match
from richsem_tpu_torch.models.ota_matcher import ota_match
from richsem_tpu_torch.models.segmentation import dice_loss, loss_masks, mask_focal_loss
from richsem_tpu_torch.utils import boxes as box_ops
from richsem_tpu_torch.utils.misc import l2_normalize

Tensor = torch.Tensor


def fed_loss_classes(
    uniforms: Tensor,  # [C] in [0, 1)
    appeared: Tensor,  # [C] bool
    n: int,
    num_classes: int,
    num_sample_cats: int,
    fed_weight: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """-> ``(ids [W], mask [W])``: every appeared class, then classes sampled
    proportionally to ``fed_weight`` without replacement (Gumbel top-k), up to
    ``max(num_sample_cats, n_appeared)`` active entries of ``W = min(C,
    max(num_sample_cats, n))``. ``appeared`` holds the classes of the matched
    GT of the global batch and ``n`` counts its matched-label slots (JAX's
    ``matched_labels.size``). Ties keep JAX ``top_k``'s order (lower index
    first)."""
    num_sample_cats = min(num_sample_cats, num_classes)
    width = min(num_classes, max(num_sample_cats, n))
    dev = appeared.device
    gumbel = -torch.log(-torch.log(uniforms.float() + 1e-20) + 1e-20)
    if fed_weight is None:
        fed_weight = torch.ones(num_classes, dtype=torch.float32, device=dev)
    score = torch.log(fed_weight.float().clamp(min=1e-20)) + gumbel
    score = torch.where(appeared, 1e9, score)
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
    num_matched: Tensor,
    focal_alpha: float = 0.25,
    fed_ids: Optional[Tuple[Tensor, Tensor]] = None,
    query_mask: Optional[Tensor] = None,  # [B, Q] queries to supervise
) -> Dict[str, Tensor]:
    """Focal (or federated) loss over ``num_boxes``, and ``class_error`` over
    ``num_matched``, the matched GT count."""
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
        out["class_error"] = 100.0 * (1.0 - ok.sum() / num_matched)
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


def _gather_gt_per_query(gt_of_query: Tensor, gt_field: Tensor, gt_valid: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """``gt_of_query [B, Q]`` (-1 background) x ``gt_field [B, G, ...]`` ->
    (the field of each query's GT [B, Q, ...], assigned [B, Q])."""
    safe = gt_of_query.clamp(min=0)
    idx = safe if gt_field.dim() == 2 else safe[..., None].expand(-1, -1, gt_field.shape[-1])
    sel = torch.gather(gt_field, 1, idx)
    return sel, (gt_of_query >= 0) & torch.gather(gt_valid, 1, safe)


def loss_labels_m2o(pred_logits: Tensor, gt_of_query: Tensor, gt_labels: Tensor,
                    gt_valid: Tensor, num_boxes: Tensor, focal_alpha: float = 0.25,
                    fed_ids: Optional[Tuple[Tensor, Tensor]] = None,
                    total: Optional[Callable[[Tensor], Tensor]] = None) -> Dict[str, Tensor]:
    """The focal (or federated) loss under the many-to-one assignment, over
    ``num_boxes``; ``class_error`` over the assigned queries of the global
    batch: ``total`` (``parallel/dist.py:total_``) sums its two counts over
    the ranks."""
    c = pred_logits.shape[-1]
    logits = pred_logits.float()
    lbl, assigned = _gather_gt_per_query(gt_of_query, gt_labels, gt_valid)
    classes = torch.arange(c, device=lbl.device)
    onehot = ((lbl[..., None] == classes) & assigned[..., None]).float()
    fed_mask = None
    if fed_ids is not None:
        ids, fed_mask = fed_ids
        logits, onehot = logits[..., ids], onehot[..., ids]
    focal = _sigmoid_focal(logits, onehot, focal_alpha, 2.0)
    if fed_mask is not None:
        focal = focal * fed_mask.float()
    out = {"loss_ce": focal.sum() / num_boxes}
    with torch.no_grad():
        ok = (pred_logits.argmax(-1) == lbl) & assigned
        counts = torch.stack([ok.sum(), assigned.sum()])
        if total is not None:
            counts = total(counts)
        out["class_error"] = 100.0 * (1.0 - counts[0] / counts[1].clamp(min=1))
    return out


def loss_boxes_m2o(pred_boxes: Tensor, gt_of_query: Tensor, gt_boxes: Tensor,
                   gt_valid: Tensor, num_boxes: Tensor) -> Dict[str, Tensor]:
    """L1 and GIoU of every assigned query against its GT, over ``num_boxes``."""
    sel, assigned = _gather_gt_per_query(gt_of_query, gt_boxes, gt_valid)
    m = assigned.float()
    pb = pred_boxes.float()
    l1 = (pb - sel.float()).abs()
    giou = box_ops.generalized_box_iou_elementwise(
        box_ops.box_cxcywh_to_xyxy(pb), box_ops.box_cxcywh_to_xyxy(sel.float()))
    out = {
        "loss_bbox": (l1.sum(-1) * m).sum() / num_boxes,
        "loss_giou": ((1.0 - giou) * m).sum() / num_boxes,
    }
    with torch.no_grad():
        out["loss_xy"] = (l1[..., :2].sum(-1) * m).sum() / num_boxes
        out["loss_hw"] = (l1[..., 2:].sum(-1) * m).sum() / num_boxes
    return out


class GlobalStats(NamedTuple):
    """What the losses read of the global batch, which is one process's batch
    or the stacked batches of ``ranks`` data-parallel ranks, each count
    clamped at 1 and divided by ``ranks``: ``num_boxes``, its valid GT count;
    ``classes [C]``, the classes of its valid GT; ``dn_boxes`` and
    ``dn_classes``, the same of the valid GT that CDN's positive queries hold
    (all but those of an image past ``2 * dn_number``). Every valid GT is
    matched (a query each, in every set), so these are what JAX counts and
    sees as appeared over the matched GT of the matching sets and of the DN
    sets; the mean over the ranks of their losses is then, term by term, the
    loss of the global batch."""

    num_boxes: Tensor
    classes: Tensor
    dn_boxes: Tensor
    dn_classes: Tensor
    ranks: int = 1
    union: Optional[Callable[[Tensor], Tensor]] = None  # a mask's union over the ranks
    total: Optional[Callable[[Tensor], Tensor]] = None  # counts summed over the ranks

    @classmethod
    def of(cls, stats: Dict[str, Tensor], ranks: int = 1,
           union: Optional[Callable[[Tensor], Tensor]] = None,
           total: Optional[Callable[[Tensor], Tensor]] = None) -> "GlobalStats":
        """From the global batch's statistics (``parallel/dist.py:STAT_KEYS``);
        ``union`` and ``total`` (``parallel/dist.py:union_``, ``total_``) with
        ``ranks`` above 1."""
        def share(count):
            return count.float().clamp(min=1.0) / ranks

        return cls(share(stats["gt_total"]), stats["gt_classes"], share(stats["dn_total"]),
                   stats["dn_classes"], ranks, union, total)


def set_criterion(
    outputs: Dict[str, Any],
    targets: Dict[str, Tensor],
    stats: GlobalStats,
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
    ``dn_meta`` (:func:`expand_dn_targets`).

    ``stats`` are the global batch's (:class:`GlobalStats`): ``num_boxes``
    normalises every set's losses, the DN sets' times their group count. Under
    the many-to-one layout a set's federated classes are the classes of its
    assigned queries over the global batch (``stats.union`` across ranks: a
    valid GT may end without a query), and their table's width counts
    ``min(Q, G)`` slots an image (``criterion.py:58``). The many-to-one
    ``class_error`` counts the assigned queries of the global batch
    (``stats.total`` across ranks)."""
    if use_fed_loss and fed_uniforms is None:
        raise ValueError("the federated loss needs fed_uniforms [16, num_classes]")
    gt_labels, gt_boxes, gt_valid = targets["labels"], targets["boxes"], targets["valid"]
    num_boxes = stats.num_boxes
    many_to_one = matcher_type == "OptMatcher"
    b, g = gt_labels.shape
    if many_to_one and "masks" in targets and ("pred_masks" in outputs
                                               or "mask_params" in outputs):
        # JAX's words: the mask losses are only for one-to-one matchers
        raise NotImplementedError(
            "mask losses under matcher_type='OptMatcher' (many-to-one) are not "
            "implemented; use HungarianMatcher/SimpleMinsumMatcher with masks=True")

    def run_matcher(out_set, labels=gt_labels):
        if many_to_one:
            return ota_match(out_set["pred_logits"], out_set["pred_boxes"], labels, gt_boxes,
                             gt_valid, focal_alpha=focal_alpha)
        return match(out_set["pred_logits"], out_set["pred_boxes"], labels, gt_boxes,
                     gt_valid, cost_class, cost_bbox, cost_giou, focal_alpha,
                     matcher_type=matcher_type)

    def fed_ids_for(i, n, appeared):
        """Split ``i``'s classes; ``n`` matched-label slots of a process."""
        if not use_fed_loss:
            return None
        return fed_loss_classes(fed_uniforms[i], appeared, n * stats.ranks,
                                num_classes, fed_num_sample_cats, fed_weight)

    def slots(col):  # JAX's matched_labels.size, the many-to-one table capped at B * G
        return min(col.numel(), b * g) if many_to_one else col.numel()

    has_distill = distill_type in ("clip_logits", "clip_l1") and (
        "pred_clip_logits" in outputs or "pred_clip_embed" in outputs)
    clip_valid = targets.get("clip_valid", gt_valid)

    def distill(out_set, col, kd_fids):
        if distill_type == "clip_l1":
            if not many_to_one:
                return distill_loss_l1(out_set["pred_clip_embed"], col, clip_valid,
                                       targets["clip_embed"], num_boxes)
            sel_t, assigned = _gather_gt_per_query(col, targets["clip_embed"],
                                                   gt_valid & clip_valid)
            l1 = (l2_normalize(out_set["pred_clip_embed"].float()) - sel_t.float()).abs().sum(-1)
            return (l1 * assigned.float()).sum() / num_boxes
        pred = out_set["pred_clip_logits"]
        if clip_distill_objective == "gt" and many_to_one:
            sel_t, assigned = _gather_gt_per_query(col, targets["clip_logits"],
                                                   gt_valid & clip_valid)
            kl = _kl_terms(pred, sel_t, use_dynamic_distill_weight, kd_fids)
            return (kl * assigned.float()).sum() / num_boxes
        if clip_distill_objective == "gt":
            return distill_loss_kl(pred, col, clip_valid, targets["clip_logits"], num_boxes,
                                   use_dynamic_distill_weight, kd_fids)
        if clip_distill_objective == "pred_all" or not many_to_one:
            return distill_loss_kl_pred(pred, outputs["teacher_clip_logits"], col, gt_valid,
                                        num_boxes, clip_distill_objective,
                                        use_dynamic_distill_weight, kd_fids)
        # 'pred' under many-to-one: the assigned queries against the teacher
        _, assigned = _gather_gt_per_query(col, gt_boxes, gt_valid)
        kl = _kl_terms(pred, outputs["teacher_clip_logits"], use_dynamic_distill_weight,
                       kd_fids)
        return (kl * assigned.float()).sum() / num_boxes

    def appeared(col):
        """The classes the set's matching holds, over the global batch."""
        if not many_to_one:
            return stats.classes  # every valid GT is matched
        lbl, assigned = _gather_gt_per_query(col, gt_labels, gt_valid)
        seen = torch.zeros(num_classes + 1, dtype=torch.bool, device=col.device)
        seen = seen.scatter(0, torch.where(assigned, lbl, num_classes).reshape(-1), True)
        seen = seen[:num_classes]
        return stats.union(seen) if stats.union is not None else seen

    def matched_losses(out_set, col, labels, fids):
        """The focal, box and cardinality terms of a set matched by ``col``."""
        if many_to_one:
            d = loss_labels_m2o(out_set["pred_logits"], col, labels, gt_valid, num_boxes,
                                focal_alpha, fids, stats.total)
            d.update(loss_boxes_m2o(out_set["pred_boxes"], col, gt_boxes, gt_valid, num_boxes))
        else:
            d = loss_labels(out_set["pred_logits"], col, labels, gt_valid, num_boxes,
                            num_boxes, focal_alpha, fids)
            d.update(loss_boxes(out_set["pred_boxes"], col, gt_boxes, gt_valid, num_boxes))
        d["cardinality_error"] = loss_cardinality(out_set["pred_logits"], gt_valid)
        return d

    def one_set(out_set, i, col, include_distill=False):
        fids = fed_ids_for(i, slots(col), appeared(col)) if use_fed_loss else None
        d = matched_losses(out_set, col, gt_labels, fids)
        if include_distill:
            d["loss_distill"] = distill(out_set, col, fids if use_fed_on_kd else None)
        return d

    col = run_matcher(outputs)
    losses: Dict[str, Tensor] = dict(one_set(outputs, 0, col, has_distill))
    if "masks" in targets and not many_to_one:
        losses.update(mask_losses(outputs, col, targets["masks"], gt_valid, num_boxes))

    if dn_meta is not None and "dn_outputs" in outputs:
        dn_out = outputs["dn_outputs"]
        dn_col = dn_slot_indices(dn_meta)
        dn_nb = num_boxes * dn_meta["num_groups"]
        dn_hits = stats.dn_boxes * dn_meta["num_groups"]
        pos_valid, qmask = dn_meta["pos_valid"], dn_meta["slot_in_use"]
        dn_sets = [(dn_out, "_dn", 1)] + [
            (aux, f"_dn_{i}", 2 + i) for i, aux in enumerate(dn_out.get("aux_outputs", []))]
        for out_set, suffix, i in dn_sets:
            fids = fed_ids_for(i, dn_col.numel(), stats.dn_classes)
            d = loss_labels(out_set["pred_logits"], dn_col, dn_meta["pos_labels"],
                            pos_valid, dn_nb, dn_hits, focal_alpha, fids, query_mask=qmask)
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
        aux_distill = has_distill and distill_aux_layers and (
            "pred_clip_logits" in aux or "pred_clip_embed" in aux)
        d = one_set(aux, 8 + i, run_matcher(aux), aux_distill)
        losses.update({f"{k}_{i}": v for k, v in d.items()})

    if "interm_outputs" in outputs:
        interm = outputs["interm_outputs"]
        if enc_cls_agn:
            # class-agnostic: every label 0, for the matching and the loss
            agn = torch.zeros_like(gt_labels)
            col = run_matcher(interm, agn)
            fids = None
            if use_fed_loss:  # class 0 appeared if any GT did; JAX caps no table here
                seen = torch.zeros_like(stats.classes)
                seen[0] = stats.classes.any()
                fids = fed_ids_for(15, col.numel(), seen)
            d = matched_losses(interm, col, agn, fids)
        else:
            d = one_set(interm, 14, run_matcher(interm))
        losses.update({f"{k}_interm": v for k, v in d.items()})
    return losses


def mask_losses(outputs: Dict[str, Any], col: Tensor, gt_masks: Tensor, gt_valid: Tensor,
                num_boxes: Tensor) -> Dict[str, Tensor]:
    """``loss_mask`` and ``loss_dice`` of the final set's matched queries
    (``col [B, G]``), for whichever mask head's outputs ``outputs`` holds
    (none: no term)."""
    if "pred_masks" in outputs:
        return loss_masks(outputs["pred_masks"], col, gt_masks, gt_valid, num_boxes)
    if "mask_params" not in outputs:
        return {}
    # CondInst: the dynamic networks of the matched queries only, [B, G] instances
    feats = outputs["mask_feats"]
    b, hm, wm = feats.shape[0], feats.shape[1], feats.shape[2]
    stride = outputs.get("mask_feat_stride", 8)
    safe = col.clamp(min=0)[..., None]
    params = torch.gather(outputs["mask_params"], 1,
                          safe.expand(-1, -1, outputs["mask_params"].shape[-1]))
    boxes = torch.gather(outputs["pred_boxes"], 1, safe.expand(-1, -1, 4))
    layout = outputs.get("mask_head_layout", {})
    logits = dynamic_mask_logits(
        feats, params, box_centers_px(boxes.detach(), feats, stride),
        dy_channels=layout.get("dy_channels", 8), layers=layout.get("layers", 3),
        rel_coord=layout.get("rel_coord", True), mask_feat_stride=stride)
    m = (gt_valid & (col >= 0)).reshape(-1)
    n = b * col.shape[1]
    logits, tgt = logits.reshape(n, hm, wm), gt_masks.reshape(n, hm, wm)
    return {"loss_mask": mask_focal_loss(logits, tgt, m, num_boxes),
            "loss_dice": dice_loss(logits, tgt, m, num_boxes)}


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
