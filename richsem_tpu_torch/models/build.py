"""Model assembly: the registry entry for 'richsem' (counterpart of ``richsem_tpu/models/build.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.dino import DINO, DINOConfig
from richsem_tpu_torch.models.registry import register_model


@register_model("richsem")
def build_richsem(
    cfg, device=None, generator: Optional[torch.Generator] = None
) -> Tuple[DINO, Dict[str, Any]]:
    """-> (model, postprocess_kwargs), the model on ``device`` in eval mode.

    With ``generator`` the weights are drawn from it (random weights from a
    seed); without, they stay uninitialized until a state dict is loaded. The
    JAX builder also returns the loss weight dict; the port's comes with the
    criterion, in the training slice.
    """
    model = DINO(DINOConfig.from_config(cfg), device=device).eval()
    if generator is not None:
        model.init_weights(generator)
    post_kwargs = dict(
        num_select=cfg.num_select,
        nms_iou_threshold=cfg.nms_iou_threshold,
    )
    return model, post_kwargs
