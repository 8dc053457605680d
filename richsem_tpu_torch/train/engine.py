"""Eval step (counterpart of ``make_eval_step`` in ``richsem_tpu/train/engine.py``).

The train step, its loss and its optimizer come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from richsem_tpu_torch.models.postprocess import postprocess


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
            "ported yet (ROADMAP.md queue 1, item 4)"
        )

    @torch.inference_mode()
    def eval_step(batch, text_embed=None):
        outputs = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        return postprocess(
            outputs["pred_logits"], outputs["pred_boxes"], batch["orig_size"],
            num_select=cfg.num_select, nms_iou_threshold=cfg.nms_iou_threshold,
        )

    return eval_step
