"""Model assembly: the registry entry for 'richsem' (counterpart of
``richsem_tpu/models/build.py``) and the frozen CLIP teacher."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig
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


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_clip_teacher(
    cfg, dtype: Union[None, str, torch.dtype] = None, device="cuda",
    generator: Optional[torch.Generator] = None,
) -> CLIP:
    """The frozen CLIP teacher of ``cfg.clip_model`` (RN50), its vision tower
    computing in ``dtype`` (None: f32), on ``device`` (the card unless the caller
    asks for the CPU), in eval mode with no parameter requiring a gradient.

    With ``generator`` the weights are drawn from it (random weights from a
    seed); without, they stay uninitialized until a state dict is loaded
    (``utils/convert.py:clip_params_from_jax``)."""
    name = getattr(cfg, "clip_model", "RN50")
    if name != "RN50" or not getattr(cfg, "use_cnn_clip", True):
        raise NotImplementedError(
            f"the CLIP teacher {name!r} is not ported to richsem_tpu_torch yet "
            "(ROADMAP.md queue 1, item 11)")
    dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    ccfg = dataclasses.replace(
        CLIPConfig.rn50(), dtype=dtype,
        image_resolution=getattr(cfg, "clip_visual_resolution", 224))
    teacher = CLIP(ccfg, device=device)
    if generator is not None:
        teacher.init_weights(generator)
    return teacher.eval().requires_grad_(False)
