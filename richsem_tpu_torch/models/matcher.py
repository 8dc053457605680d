"""Set-prediction matchers (counterpart of ``richsem_tpu/models/matcher.py``).

``match_cost_matrix`` builds the ``HungarianMatcher`` cost (focal class cost
at each GT's label + L1 + GIoU) as a padded ``[B, G, nq]`` tensor; ``match``
solves it with the auction of :mod:`richsem_tpu_torch.ops.lap` (K4 on the
card), exactly on the host with SciPy (``HungarianMatcherCPU``, which a CUDA
graph cannot hold), or takes each row's argmin (``SimpleMinsumMatcher``). The
many-to-one ``OptMatcher`` is :mod:`richsem_tpu_torch.models.ota_matcher`,
which the criterion calls itself. Matching is not differentiated.
"""

from __future__ import annotations

import torch

from richsem_tpu_torch.ops.lap import (batched_min_cost_assignment, greedy_assignment,
                                      scipy_assignment)
from richsem_tpu_torch.utils import boxes as box_ops


@torch.no_grad()
def match_cost_matrix(
    pred_logits: torch.Tensor,  # [B, nq, C]
    pred_boxes: torch.Tensor,  # [B, nq, 4] cxcywh
    gt_labels: torch.Tensor,  # [B, G]
    gt_boxes: torch.Tensor,  # [B, G, 4] cxcywh
    gt_valid: torch.Tensor,  # [B, G]
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
    gamma: float = 2.0,
) -> torch.Tensor:
    """Cost ``[B, G, nq]`` (GT rows x query columns); invalid rows are 0."""
    nq = pred_logits.shape[1]
    labels = gt_labels.clamp(min=0).long()
    # the focal cost is elementwise, so it is taken at the gathered logits only
    logits = torch.gather(pred_logits.float(), 2, labels[:, None, :].expand(-1, nq, -1))
    prob = torch.sigmoid(logits).transpose(1, 2)  # [B, G, nq]
    neg = (1 - focal_alpha) * prob**gamma * (-torch.log(1 - prob + 1e-8))
    pos = focal_alpha * (1 - prob) ** gamma * (-torch.log(prob + 1e-8))
    cls = pos - neg
    gt, pred = gt_boxes.float(), pred_boxes.float()
    l1 = (gt[:, :, None, :] - pred[:, None, :, :]).abs().sum(-1)
    giou = box_ops.generalized_box_iou_elementwise(
        box_ops.box_cxcywh_to_xyxy(gt)[:, :, None, :],
        box_ops.box_cxcywh_to_xyxy(pred)[:, None, :, :],
    )
    cost = cost_class * cls + cost_bbox * l1 + cost_giou * (-giou)
    cost = torch.nan_to_num(cost, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.where(gt_valid[..., None], cost, cost.new_zeros(()))


@torch.no_grad()
def match(
    pred_logits: torch.Tensor,
    pred_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
    focal_alpha: float = 0.25,
    matcher_type: str = "HungarianMatcher",
) -> torch.Tensor:
    """-> ``col [B, G]``: the query matched to each GT (-1 for invalid)."""
    cost = match_cost_matrix(pred_logits, pred_boxes, gt_labels, gt_boxes, gt_valid,
                             cost_class, cost_bbox, cost_giou, focal_alpha)
    if matcher_type == "HungarianMatcher":
        return batched_min_cost_assignment(cost, gt_valid)
    if matcher_type == "SimpleMinsumMatcher":
        return greedy_assignment(cost, gt_valid)
    if matcher_type == "HungarianMatcherCPU":
        return scipy_assignment(cost, gt_valid)
    raise ValueError(f"unknown matcher_type {matcher_type!r}")
