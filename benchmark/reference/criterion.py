"""Plain reference of the training loss of the RichSem recipe, in float32.

One-to-one matching of each prediction set to the GT by the least total cost
(focal class cost, L1 and GIoU of the boxes; ``scipy``'s Hungarian solver),
then for each set the sigmoid focal loss over the federated classes (every
GT class of the batch, then classes drawn by Gumbel top-k from the step's
uniforms up to the table's width), the L1 and GIoU of the matched boxes, and
on the final set (and the CDN final set) the KL distillation of the CLIP
logits against the teacher's at the GT boxes. The CDN sets are matched by
construction. Sets: the final layer (uniforms row 0), the CDN final layer (1)
and aux layers (2 + i), the aux layers (8 + i), the two-stage set (14). Every
term is normalised by the batch's valid GT count (CDN: times its groups),
and weighted as the recipe weighs it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from benchmark.reference.detector import cxcywh_to_xyxy

Tensor = torch.Tensor


def giou(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise generalized IoU of xyxy boxes."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt, rb = torch.maximum(a[..., :2], b[..., :2]), torch.minimum(a[..., 2:], b[..., 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a + area_b - inter
    iou = inter / (union + 1e-8)
    lt, rb = torch.minimum(a[..., :2], b[..., :2]), torch.maximum(a[..., 2:], b[..., 2:])
    encl = (rb - lt).clamp(min=0).prod(-1)
    return iou - (encl - union) / (encl + 1e-8)


def match_cost(logits: Tensor, boxes: Tensor, labels: Tensor, gt_boxes: Tensor, w: Dict
               ) -> Tensor:
    """-> cost ``[B, G, Q]``: 2 x focal class cost + 5 x L1 + 2 x (-GIoU)."""
    prob = torch.sigmoid(torch.gather(logits, 2, labels[:, None, :].expand(-1, logits.shape[1], -1)))
    prob = prob.transpose(1, 2)
    a, gamma = w["focal_alpha"], 2.0
    cls = a * (1 - prob) ** gamma * -torch.log(prob + 1e-8) \
        - (1 - a) * prob ** gamma * -torch.log(1 - prob + 1e-8)
    l1 = (gt_boxes[:, :, None] - boxes[:, None]).abs().sum(-1)
    g = giou(cxcywh_to_xyxy(gt_boxes)[:, :, None], cxcywh_to_xyxy(boxes)[:, None])
    return w["set_cost_class"] * cls + w["set_cost_bbox"] * l1 - w["set_cost_giou"] * g


def hungarian(cost: Tensor, valid: Tensor) -> Tensor:
    """The least-cost one-to-one assignment of each image's valid GT rows to
    queries -> ``col [B, G]`` (-1 for invalid rows)."""
    from scipy.optimize import linear_sum_assignment

    c, v = cost.detach().double().cpu().numpy(), valid.cpu().numpy()
    col = np.full(v.shape, -1, np.int64)
    for i in range(c.shape[0]):
        rows = np.nonzero(v[i])[0]
        if len(rows):
            r, q = linear_sum_assignment(c[i, rows])
            col[i, rows[r]] = q
    return torch.from_numpy(col).to(cost.device)


def fed_classes(u: Tensor, appeared: Tensor, n: int, num_classes: int, k: int
                ) -> Tuple[Tensor, Tensor]:
    """The federated loss's classes: every appeared class first, then by
    Gumbel top-k of ``u``; ``W = min(C, max(k, n))`` ids, the first
    ``max(k, #appeared)`` of them active."""
    width = min(num_classes, max(k, n))
    score = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    score = torch.where(appeared, torch.full_like(score, 1e9), score)
    ids = torch.sort(score, descending=True, stable=True).indices[:width]
    active = torch.arange(width, device=u.device) < torch.clamp(appeared.sum(), min=k)
    return ids, active


def focal(x: Tensor, t: Tensor, alpha: float) -> Tensor:
    p = torch.sigmoid(x)
    ce = torch.nn.functional.binary_cross_entropy_with_logits(x, t, reduction="none")
    pt = p * t + (1 - p) * (1 - t)
    return (alpha * t + (1 - alpha) * (1 - t)) * ce * (1 - pt) ** 2


def set_losses(logits: Tensor, boxes: Tensor, col: Tensor, labels: Tensor, gt_boxes: Tensor,
               valid: Tensor, norm: Tensor, fed: Tuple[Tensor, Tensor], alpha: float,
               query_mask: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Focal over the federated classes, L1 and GIoU of one set matched by ``col``."""
    b, q, c = logits.shape
    hit = valid & (col >= 0)
    target = torch.zeros(b, q + 1, c, device=logits.device)  # unmatched rows land in row q
    bi = torch.arange(b, device=col.device)[:, None].expand_as(col)
    target[bi, torch.where(hit, col, q), labels.clamp(min=0)] = hit.float()
    target = target[:, :q]
    ids, active = fed
    f = focal(logits[..., ids], target[..., ids], alpha) * active.float()
    if query_mask is not None:
        f = f * query_mask[..., None].float()
    sel = torch.gather(boxes, 1, col.clamp(min=0)[..., None].expand(-1, -1, 4))
    m = hit.float()
    l1 = ((sel - gt_boxes).abs().sum(-1) * m).sum() / norm
    g = ((1 - giou(cxcywh_to_xyxy(sel), cxcywh_to_xyxy(gt_boxes))) * m).sum() / norm
    return {"loss_ce": f.sum() / norm, "loss_bbox": l1, "loss_giou": g}


def kl_distill(student: Tensor, col: Tensor, valid: Tensor, teacher: Tensor, norm: Tensor
               ) -> Tensor:
    """KL(teacher || student) of the CLIP logits at each GT's matched query."""
    s = torch.gather(student, 1, col.clamp(min=0)[..., None].expand(-1, -1, student.shape[-1]))
    t = torch.softmax(teacher, -1)
    kl = (t * (torch.log(t.clamp(min=1e-20)) - torch.log_softmax(s, -1))).sum(-1)
    return (kl * (valid & (col >= 0)).float()).sum() / norm


def cdn_meta(labels: Tensor, boxes: Tensor, valid: Tensor, clip_logits: Tensor,
             clip_valid: Tensor, match_gt: Tensor):
    """Each positive CDN slot as its own supervised row: its slot, GT label,
    box, validity, teacher logits and their validity."""
    b, p = match_gt.shape
    pos = match_gt >= 0
    safe = match_gt.clamp(min=0)
    slots = torch.where(pos, torch.arange(p, device=pos.device)[None].expand(b, p), -1)
    take = lambda x: torch.gather(x, 1, safe if x.dim() == 2 else
                                  safe[..., None].expand(-1, -1, x.shape[-1]))
    pv = pos & take(valid)
    return slots, take(labels), take(boxes), pv, take(clip_logits), pv & take(clip_valid)


def weights(cfg: dict) -> Dict[str, float]:
    """Each loss term's weight, as the recipe's weight dict sets them."""
    base = {"loss_ce": cfg["cls_loss_coef"], "loss_bbox": cfg["bbox_loss_coef"],
            "loss_giou": cfg["giou_loss_coef"]}
    w = dict(base)
    w.update({f"{k}_dn": v for k, v in base.items()})
    w["loss_distill_dn"] = w["loss_distill"] = cfg["distill_loss_coef"]
    clean = dict(w)
    for i in range(cfg["dec_layers"] - 1):
        w.update({f"{k}_{i}": v for k, v in clean.items()})
    w.update({f"{k}_interm": v * cfg["interm_loss_coef"] for k, v in base.items()})
    return w


def loss(out: Dict[str, Tensor], batch: Dict[str, Tensor], clip_logits: Tensor,
         clip_valid: Tensor, dn: Dict[str, Tensor], fed_u: Tensor, cfg: dict,
         assign: Callable[[Tensor, Tensor], Tensor] = hungarian) -> Tuple[Tensor, Dict[str, Tensor]]:
    """-> (the weighted total, every term)."""
    labels, gt_boxes, valid = batch["labels"], batch["boxes"], batch["valid"]
    b, g = labels.shape
    c = cfg["num_classes"]
    alpha = cfg["focal_alpha"]
    counts = valid.sum(1)
    norm = counts.sum().float().clamp(min=1)
    slot = torch.arange(g, device=labels.device)[None]
    in_dn = valid & (slot < counts.clamp(max=2 * cfg["dn_number"])[:, None])

    def classes(mask):  # the classes of the GT under ``mask``
        seen = torch.zeros(c + 1, dtype=torch.bool, device=labels.device)
        return seen.index_fill(0, torch.where(mask, labels, c).reshape(-1), True)[:c]

    appeared, dn_appeared = classes(valid), classes(in_dn)
    k = cfg["fed_num_sample_cats"]

    def fed(i, n, app):
        return fed_classes(fed_u[i], app, n, c, k)

    terms: Dict[str, Tensor] = {}
    layers = out["pred_logits"].shape[0]
    for lid in range(layers):
        lg, bx = out["pred_logits"][lid], out["pred_boxes"][lid]
        col = assign(match_cost(lg.detach(), bx.detach(), labels, gt_boxes, cfg), valid)
        i = 0 if lid == layers - 1 else 8 + lid
        d = set_losses(lg, bx, col, labels, gt_boxes, valid, norm, fed(i, b * g, appeared), alpha)
        if lid == layers - 1:
            d["loss_distill"] = kl_distill(out["clip_logits"][:, -out["pred_logits"].shape[2]:],
                                           col, clip_valid, clip_logits, norm)
            terms.update(d)
        else:
            terms.update({f"{n}_{lid}": v for n, v in d.items()})

    slots, pl, pb, pv, pcl, pcv = cdn_meta(labels, gt_boxes, valid, clip_logits, clip_valid,
                                           dn["match_gt"])
    groups = dn["num_groups"].float()
    dn_norm = norm * groups
    for lid in range(layers):
        lg, bx = out["dn_logits"][lid], out["dn_boxes"][lid]
        i = 1 if lid == layers - 1 else 2 + lid
        d = set_losses(lg, bx, slots, pl, pb, pv, dn_norm, fed(i, slots.numel(), dn_appeared),
                       alpha, query_mask=dn["slot_in_use"])
        if lid == layers - 1:
            num_dn = out["dn_logits"].shape[2]
            d["loss_distill"] = kl_distill(out["clip_logits"][:, :num_dn], slots, pcv, pcl, dn_norm)
            terms.update({f"{n}_dn" if n != "loss_distill" else "loss_distill_dn": v
                          for n, v in d.items()})
        else:
            terms.update({f"{n}_dn_{lid}": v for n, v in d.items()})

    lg, bx = out["interm_logits"], out["interm_boxes"]
    col = assign(match_cost(lg.detach(), bx.detach(), labels, gt_boxes, cfg), valid)
    d = set_losses(lg, bx, col, labels, gt_boxes, valid, norm, fed(14, b * g, appeared), alpha)
    terms.update({f"{n}_interm": v for n, v in d.items()})
    w = weights(cfg)
    total = sum(terms[n] * w[n] for n in w if n in terms)
    return total, terms
