"""Box coordinate utilities (PyTorch counterpart of ``richsem_tpu/utils/boxes.py``).

All functions take ``[..., 4]`` tensors and broadcast over leading dims.
Pairwise variants take ``[N, 4]`` x ``[M, 4]`` -> ``[N, M]``. Degenerate boxes
are handled by clamping denominators, as in the JAX package.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def box_cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([(x0 + x1) * 0.5, (y0 + y1) * 0.5, x1 - x0, y1 - y0], dim=-1)


def box_area(b: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, ``[..., 4] -> [...]``; negative extents clamp to 0."""
    w = (b[..., 2] - b[..., 0]).clamp(min=0)
    h = (b[..., 3] - b[..., 1]).clamp(min=0)
    return w * h


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of xyxy boxes. ``[N,4] x [M,4] -> ([N,M] iou, [N,M] union)``."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / (union + _EPS), union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU of xyxy boxes, ``[N,4] x [M,4] -> [N,M]``."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - (enclose - union) / (enclose + _EPS)


def box_iou_elementwise(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of xyxy boxes, ``[...,4] x [...,4] -> ([...], [...])``."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / (union + _EPS), union


def generalized_box_iou_elementwise(
    boxes1: torch.Tensor, boxes2: torch.Tensor
) -> torch.Tensor:
    """Elementwise GIoU of xyxy boxes, ``[...,4] x [...,4] -> [...]``."""
    iou, union = box_iou_elementwise(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - (enclose - union) / (enclose + _EPS)


def masks_to_boxes(masks: torch.Tensor) -> torch.Tensor:
    """``[N, H, W]`` binary masks -> ``[N, 4]`` xyxy boxes (zeros if empty)."""
    n, h, w = masks.shape
    ys = torch.arange(h, dtype=torch.float32, device=masks.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=masks.device)[None, None, :]
    on = masks > 0
    big = torch.tensor(1e8, dtype=torch.float32, device=masks.device)
    any_ = on.flatten(1).any(-1)
    x_min = torch.where(on, xs, big).amin(dim=(1, 2))
    y_min = torch.where(on, ys, big).amin(dim=(1, 2))
    x_max = torch.where(on, xs, -big).amax(dim=(1, 2)) + 1
    y_max = torch.where(on, ys, -big).amax(dim=(1, 2)) + 1
    boxes = torch.stack([x_min, y_min, x_max, y_max], dim=-1)
    return torch.where(any_[:, None], boxes, torch.zeros_like(boxes))
