"""Convert a flax parameter tree of ``richsem_tpu`` into a state dict of the port.

The port names its modules after the flax tree, so a leaf's state-dict key is
its flax path joined by dots, with the leaf renamed to PyTorch's idiom, and
its value is the flax array reshaped or transposed:

=========================  ======================  =================================
flax leaf                  state-dict leaf         value
=========================  ======================  =================================
conv ``kernel`` [H,W,I,O]  ``weight`` [O,I,H,W]    transpose
dense ``kernel`` [in,out]  ``weight`` [out,in]     transpose
MHA ``query|key|value``    ``weight`` [h*hd,in]    ``[in,h,hd]`` -> ``[in,h*hd]``, transpose
``kernel`` / ``bias``      ``bias`` [h*hd]         ``[h,hd]`` -> ``[h*hd]``
MHA ``out`` ``kernel``     ``weight`` [out,h*hd]   ``[h,hd,out]`` -> ``[h*hd,out]``, transpose
``bias``                   ``bias``                as is
``scale`` (LN, GN, BN)     ``weight``              as is
``mean`` / ``var`` (BN)    ``running_mean|var``    as is
top-level arrays           the same name           as is (``level_embed``, ``tgt_embed``,
                                                   ``logit_scale``, ``cls_kernel`` ...)
``positional_embedding``   the same name           as is (the CLIP attention pool's and ViT's)
``class_embedding``, ``proj`` the same name        as is (the CLIP ViT tower's)
``rel_pos_bias`` [T,H]     the same name           as is (Swin's window attention)
``gamma`` [C]              the same name           as is (ConvNeXt's layer scale)
=========================  ======================  =================================

A depthwise kernel (flax ``[kh, kw, 1, C]``, ``feature_group_count=C``) takes
the convolution rule and becomes PyTorch's ``[C, 1, kh, kw]``.

The semantic-branch knobs' leaves take the same rules: ``share_vl_proj``'s
``vl_proj/layer{0..3}`` (dense; neither ``class_embed`` nor
``clip_visual_proj`` has leaves then), ``enc_cls_agn``'s top-level
``enc_cls_kernel`` and ``enc_cls_bias``, and ``use_clip_visual_query``'s
``clip_query_proj`` (dense, no bias); ``distill_aux_layers`` reuses the
distillation projection for every layer and adds none.

So do the masks path's: DETRsegm's ``mask_attention.q_proj`` (dense) and
``k_proj`` (a 1x1 conv), ``mask_head.lay{1..5}_conv``, ``adapter4``,
``adapter3`` and ``out_conv`` (convs) and ``lay{1..5}_gn`` (group norms);
CondInst's ``cond_inst.controller.layer{0..2}`` (dense) and
``cond_inst.mask_branch.{refine,tower}{i}_conv``, ``tower_out`` (convs) and
``*_ln`` (layer norms).

Flax's attention divides the query by sqrt(head_dim) at run time; the port does
the same in ``MultiHeadAttention``, so no weight is rescaled. Real RichSem
checkpoints reach the port through ``tools/convert_detector.py`` (reference
checkpoint -> flax tree) and then this module.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var",
           "bias": "bias"}
# named leaves kept as they are
_KEPT = ("positional_embedding", "rel_pos_bias", "gamma", "class_embedding", "proj")


def _shape(v) -> Tuple[int, ...]:
    return tuple(v.shape) if hasattr(v, "shape") else tuple(v)


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def _convert_leaf(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    if len(path) == 1 or path[-1] in _KEPT:
        return ".".join(path), arr
    *parents, leaf = path
    module = ".".join(parents)
    mha = parents[-1] in ("query", "key", "value", "out")
    if leaf == "kernel":
        if arr.ndim == 4:
            return f"{module}.weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 2:
            return f"{module}.weight", arr.T
        if arr.ndim == 3 and mha and parents[-1] == "out":
            return f"{module}.weight", arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 3 and mha:
            return f"{module}.weight", arr.reshape(arr.shape[0], -1).T
    elif leaf == "bias" and arr.ndim == 2 and mha:
        return f"{module}.bias", arr.reshape(-1)
    elif leaf in _RENAME and arr.ndim == 1:
        return f"{module}.{_RENAME[leaf]}", arr
    raise ValueError(f"no port mapping for flax leaf {'/'.join(path)} {arr.shape}")


def params_from_jax(
    flax_params: Mapping[str, Any],
    expected: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """flax params (nested dicts of numpy arrays, with or without the top
    ``"params"`` collection) -> float32 state dict of the port.

    Every flax leaf maps to exactly one key, or this raises. With ``expected``
    (a state dict, or any mapping of names to tensors or shapes), every key on
    either side must be matched, with equal shapes, or this raises. A
    ``positional_embedding``, ``rel_pos_bias`` or ``gamma`` array below the top
    level (the CLIP attention pool's, Swin's, ConvNeXt's) keeps its name, as
    the top-level arrays do.
    """
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(flax_params):
        name, arr = _convert_leaf(path, np.asarray(value))
        if name in out:
            raise ValueError(f"two flax leaves map to {name!r}")
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    if expected is not None:
        missing = sorted(set(expected) - set(out))
        unexpected = sorted(set(out) - set(expected))
        wrong = sorted(
            f"{k}: flax {tuple(out[k].shape)} vs port {_shape(expected[k])}"
            for k in set(out) & set(expected)
            if tuple(out[k].shape) != _shape(expected[k])
        )
        if missing or unexpected or wrong:
            raise ValueError(
                f"flax tree does not match the port: missing {missing}, "
                f"unexpected {unexpected}, wrong shapes {wrong}"
            )
    return out


def clip_params_from_jax(
    flax_params: Mapping[str, Any],
    expected: Optional[Mapping[str, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """The flax tree of ``richsem_tpu.models.clip.CLIP`` (``tools/convert_clip.py``
    makes one from an OpenAI checkpoint) -> state dict of
    :class:`richsem_tpu_torch.models.clip.CLIP`: for RN50 the convolutions,
    frozen batch norms, attention-pool projections and ``positional_embedding``
    of the vision tower; for ViT-B/32 its ``conv1`` (no bias),
    ``class_embedding``, ``positional_embedding``, ``ln_pre``, ``block{i}``
    (the text blocks' leaves), ``ln_post`` and ``proj``; the text blocks'
    ``MultiHeadDotProductAttention`` (``query|key|value`` kernels ``[width,
    heads, head_dim]``, ``out`` ``[heads, head_dim, width]``) and the top-level
    embeddings, projection and ``logit_scale``, every leaf exactly once, as
    :func:`params_from_jax`."""
    return params_from_jax(flax_params, expected)
