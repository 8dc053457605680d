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
    model = DINO(DINOConfig.from_config(cfg), device=device,
                 clip_spatial_dim=clip_spatial_width(cfg)).eval()
    if generator is not None:
        model.init_weights(generator)
    post_kwargs = dict(
        num_select=cfg.num_select,
        nms_iou_threshold=cfg.nms_iou_threshold,
    )
    return model, build_weight_dict(cfg), post_kwargs


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_TOWERS = {"RN50": CLIPConfig.rn50, "ViT-B/32": CLIPConfig.vit_b32}


def clip_spatial_width(cfg) -> int:
    """The width of the teacher's spatial map (``encode_image(ret_sp=True)``),
    the input of ``use_clip_visual_query``'s ``clip_query_proj``: RN50's map
    before the attention pool is 2048 wide, ViT-B/32's after ``proj``
    ``embed_dim`` 512 wide. ``cfg.clip_spatial_dim`` (a tiny test teacher's)
    takes precedence."""
    if getattr(cfg, "clip_spatial_dim", None) is not None:
        return cfg.clip_spatial_dim
    return 512 if getattr(cfg, "clip_model", "RN50") == "ViT-B/32" else 2048


def build_clip_teacher(
    cfg, dtype: Union[None, str, torch.dtype] = None, device="cuda",
    generator: Optional[torch.Generator] = None,
) -> CLIP:
    """The frozen CLIP teacher of ``cfg.clip_model`` (``"RN50"`` or
    ``"ViT-B/32"``), its vision tower computing in ``dtype`` (None: f32) at
    ``cfg.clip_visual_resolution``, on ``device`` (the card unless the caller
    asks for the CPU), in eval mode with no parameter requiring a gradient.

    With ``generator`` the weights are drawn from it (random weights from a
    seed); without, they stay uninitialized until a state dict is loaded
    (``utils/convert.py:clip_params_from_jax``)."""
    name = getattr(cfg, "clip_model", "RN50")
    if name not in _TOWERS:
        raise ValueError(f"unknown clip_model {name!r}: the towers are {sorted(_TOWERS)}")
    dtype = _DTYPES[dtype] if isinstance(dtype, str) else dtype
    ccfg = dataclasses.replace(
        _TOWERS[name](), dtype=dtype,
        image_resolution=getattr(cfg, "clip_visual_resolution", 224))
    teacher = CLIP(ccfg, device=device)
    if generator is not None:
        teacher.init_weights(generator)
    return teacher.eval().requires_grad_(False)
