"""DIoU and CIoU box losses (counterpart of ``richsem_tpu/utils/box_losses.py``),
elementwise over ``[..., 4]`` xyxy boxes and differentiable in both. The CIoU
trade-off ``alpha`` is differentiated through, as in JAX."""

from __future__ import annotations

import math

import torch

from richsem_tpu_torch.utils.boxes import box_iou_elementwise

_EPS = 1e-7


def diou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """1 - IoU + squared centre distance / squared enclosing diagonal."""
    iou, _ = box_iou_elementwise(boxes1, boxes2)
    c1 = (boxes1[..., :2] + boxes1[..., 2:]) * 0.5
    c2 = (boxes2[..., :2] + boxes2[..., 2:]) * 0.5
    rho2 = ((c1 - c2) ** 2).sum(-1)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    diag2 = ((rb - lt) ** 2).sum(-1) + _EPS
    return 1.0 - iou + rho2 / diag2


def ciou_loss(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """DIoU + the aspect-ratio consistency term where IoU >= 0.5."""
    iou, _ = box_iou_elementwise(boxes1, boxes2)
    d = diou_loss(boxes1, boxes2)
    w1 = (boxes1[..., 2] - boxes1[..., 0]).clamp(min=_EPS)
    h1 = (boxes1[..., 3] - boxes1[..., 1]).clamp(min=_EPS)
    w2 = (boxes2[..., 2] - boxes2[..., 0]).clamp(min=_EPS)
    h2 = (boxes2[..., 3] - boxes2[..., 1]).clamp(min=_EPS)
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = v / (1.0 - iou + v).clamp(min=_EPS)
    return d + torch.where(iou >= 0.5, alpha * v, torch.zeros_like(v))
