"""PostProcess: model outputs -> top-k scored boxes in image coordinates.

Counterpart of ``richsem_tpu/models/postprocess.py``: sigmoid over all
(query, class) pairs, flat top-``num_select``, label = idx mod C, query =
idx div C, cxcywh -> xyxy, scaled to the original image size. With
``nms_iou_threshold > 0`` greedy NMS over each image's ``num_select`` boxes
(:func:`richsem_tpu_torch.ops.nms.nms_mask`, K7 on the card) sets the scores
of the dropped boxes to -1 instead of dropping them (static shapes).
"""

from __future__ import annotations

from typing import Dict

import torch

from richsem_tpu_torch.ops.nms import nms_mask
from richsem_tpu_torch.utils.boxes import box_cxcywh_to_xyxy


def postprocess(
    pred_logits: torch.Tensor,  # [B, nq, C]
    pred_boxes: torch.Tensor,  # [B, nq, 4] normalized cxcywh
    target_sizes: torch.Tensor,  # [B, 2] (h, w) original image sizes
    num_select: int = 300,
    nms_iou_threshold: float = -1.0,
) -> Dict[str, torch.Tensor]:
    b, nq, c = pred_logits.shape
    prob = torch.sigmoid(pred_logits.float()).reshape(b, nq * c)
    scores, idx = torch.topk(prob, num_select, dim=1)  # [B, K], sorted
    labels = idx % c
    qidx = idx // c
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    boxes = torch.gather(boxes, 1, qidx[..., None].expand(-1, -1, 4))
    target_sizes = target_sizes.float()
    h, w = target_sizes[:, 0], target_sizes[:, 1]
    boxes = boxes * torch.stack([w, h, w, h], dim=-1)[:, None, :]
    if nms_iou_threshold > 0:
        keep = nms_mask(boxes, scores, nms_iou_threshold)
        scores = torch.where(keep, scores, -1.0)
    return {"scores": scores, "labels": labels, "boxes": boxes}
