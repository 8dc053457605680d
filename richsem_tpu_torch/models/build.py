"""Model assembly: the registry entry for 'richsem' (counterpart of ``richsem_tpu/models/build.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from richsem_tpu_torch.models.criterion import build_weight_dict
from richsem_tpu_torch.models.dino import DINO, DINOConfig
from richsem_tpu_torch.models.registry import register_model


@register_model("richsem")
def build_richsem(
    cfg, device="cuda", generator: Optional[torch.Generator] = None
) -> Tuple[DINO, Dict[str, float], Dict[str, Any]]:
    """-> (model, loss weight dict, postprocess_kwargs), as the JAX ``build_richsem``.

    The model is built on ``device`` (the card unless the caller asks for the
    CPU), in eval mode. With ``generator`` the weights are drawn from it
    (random weights from a seed); without, they stay uninitialized until a
    state dict is loaded.
    """
    model = DINO(DINOConfig.from_config(cfg), device=device).eval()
    if generator is not None:
        model.init_weights(generator)
    post_kwargs = dict(
        num_select=cfg.num_select,
        nms_iou_threshold=cfg.nms_iou_threshold,
    )
    return model, build_weight_dict(cfg), post_kwargs
