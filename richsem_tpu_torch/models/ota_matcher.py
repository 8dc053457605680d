"""simOTA matcher (counterpart of ``richsem_tpu/models/ota_matcher.py``).

The reference's ``OptMatcher`` (many-to-one dynamic-k assignment): each GT
takes its ``k = clamp(int(sum of its top-10 IoUs), 1, 10)`` lowest-cost
queries, from a top-10 candidate list; a query claimed by several GT keeps its
lowest-cost GT; one repair round gives each GT left without a query its
lowest-cost free query. The cost is the focal class cost at the GT's label
minus 3 GIoU, plus 100 outside "in box and in centre" and 10,000 for a query
whose centre lies in no GT box or centre region; invalid GT cost 1e9.

-> ``gt_of_query [B, nq]``, the GT of each query (-1: background).

JAX's ``lax.top_k`` puts equal values in index order; so does the stable sort
here, on the CPU and on the card (``torch.topk`` promises no order for ties).
Matching is not differentiated.
"""

from __future__ import annotations

import torch

from richsem_tpu_torch.utils import boxes as box_ops


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: the ``k`` largest, ties in index order."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _in_boxes_info(pred_boxes, gt_xyxy, gt_cxcywh, expanded_strides: float = 32.0):
    """[B, nq] query centre in some GT's box or centre region; [B, nq, G] in both."""
    cx, cy = pred_boxes[..., 0:1], pred_boxes[..., 1:2]  # [B, nq, 1]
    gx0, gy0, gx1, gy1 = (gt_xyxy[:, None, :, i] for i in range(4))
    in_box = (cx > gx0) & (cx < gx1) & (cy > gy0) & (cy < gy1)
    r = 2.5 / expanded_strides
    gcx, gcy = gt_cxcywh[:, None, :, 0], gt_cxcywh[:, None, :, 1]
    in_center = (cx > gcx - r) & (cx < gcx + r) & (cy > gcy - r) & (cy < gcy + r)
    return in_box.any(2) | in_center.any(2), in_box & in_center


@torch.no_grad()
def ota_match(
    pred_logits: torch.Tensor,  # [B, nq, C]
    pred_boxes: torch.Tensor,  # [B, nq, 4] cxcywh
    gt_labels: torch.Tensor,  # [B, G]
    gt_boxes: torch.Tensor,  # [B, G, 4] cxcywh
    gt_valid: torch.Tensor,  # [B, G]
    cost_giou_weight: float = 3.0,
    n_candidate_k: int = 10,
    focal_alpha: float = 0.25,
) -> torch.Tensor:
    """Batched simOTA -> ``gt_of_query [B, nq]`` (int64, -1 for background)."""
    b, nq, _ = pred_logits.shape
    g = gt_labels.shape[1]
    dev = pred_logits.device
    labels = gt_labels.clamp(min=0).long()
    logits = torch.gather(pred_logits.float(), 2, labels[:, None, :].expand(-1, nq, -1))
    prob = torch.sigmoid(logits)  # [B, nq, G]: the focal cost at each GT's label
    neg = (1 - focal_alpha) * prob**2 * (-torch.log(1 - prob + 1e-8))
    pos = focal_alpha * (1 - prob) ** 2 * (-torch.log(prob + 1e-8))
    cls_cost = pos - neg

    gt = gt_boxes.float()
    pb = pred_boxes.float()
    gt_xyxy, pred_xyxy = box_ops.box_cxcywh_to_xyxy(gt), box_ops.box_cxcywh_to_xyxy(pb)
    giou = torch.stack([box_ops.generalized_box_iou(p, t) for p, t in zip(pred_xyxy, gt_xyxy)])
    iou = torch.stack([box_ops.box_iou(p, t)[0] for p, t in zip(pred_xyxy, gt_xyxy)])

    fg, in_both = _in_boxes_info(pb, gt_xyxy, gt)
    cost = cls_cost - cost_giou_weight * giou + 100.0 * (~in_both).float()
    cost = cost + torch.where(fg, 0.0, 10000.0)[..., None]
    cost = torch.where(gt_valid[:, None, :], cost, 1e9)  # [B, nq, G]

    k = min(n_candidate_k, nq)
    dyn_k = _top_k(iou.transpose(1, 2), k)[0].sum(-1).int().clamp(1, n_candidate_k)  # [B, G]
    topi = _top_k(-cost.transpose(1, 2), k)[1]  # [B, G, k]: the lowest costs
    sel = torch.arange(k, device=dev) < dyn_k[..., None]
    matching = torch.zeros((b, g, nq), dtype=torch.uint8, device=dev)
    matching.scatter_reduce_(2, topi, sel.to(torch.uint8), "amax")
    matching = matching.bool() & gt_valid[..., None]

    # a query claimed by several GT keeps its lowest-cost GT
    conflict = matching.sum(1) > 1  # [B, nq]
    best_gt = cost.argmin(2)  # [B, nq], the first minimum
    onehot_best = torch.arange(g, device=dev)[None, :, None] == best_gt[:, None, :]
    matching = torch.where(conflict[:, None, :], matching & onehot_best, matching)

    # one repair round: a GT without a query takes its lowest-cost free query
    free_q = matching.sum(1) == 0  # [B, nq]
    unmatched = gt_valid & (matching.sum(2) == 0)  # [B, G]
    repair_cost = torch.where(free_q[:, None, :], cost.transpose(1, 2), 1e18)
    repair_q = repair_cost.argmin(2)  # [B, G]
    matching = matching.to(torch.uint8)
    matching.scatter_reduce_(2, repair_q[..., None], unmatched[..., None].to(torch.uint8),
                             "amax")
    gt_of_query = matching.argmax(1)  # [B, nq], the first GT that holds the query
    return torch.where(matching.bool().any(1), gt_of_query, -1)
