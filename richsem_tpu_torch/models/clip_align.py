"""The CLIP teacher's side of RichSem (counterpart of ``richsem_tpu/models/clip_align.py``).

* :func:`build_text_embedding` -- the class text bank: 81 prompt templates per
  class name through the frozen text tower, averaged before normalization
  (richsem.py:127-151). It is an input of the train and eval steps.
* :func:`clip_spatial_features` -- one teacher forward over the padded,
  CLIP-renormalized image: the stride-32 map before the attention pool.
* :func:`clip_teacher_box_targets` -- 7x7 RoIAlign crops of that map at the
  ground-truth boxes, attention-pooled to one CLIP embedding per box, and its
  logits against the text bank: the distillation targets. With ``valid`` and
  ``max_boxes`` only the first ``max_boxes`` valid slots of each image are
  cropped (a stable partition moves them to the front) and the results are
  scattered back to ``[B, G]``, with ``clip_valid`` marking the slots that got
  a target.
* :func:`clip_pseudo_labels` / :func:`clip_pseudo_labels_multi` -- the
  teacher's weak labels for extra data.

The teacher runs under ``torch.no_grad()``: JAX stops its gradient, and the
teacher's parameters are never differentiated.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from richsem_tpu_torch.models.clip.model import CLIP, denorm_imagenet_to_clip
from richsem_tpu_torch.models.clip.tokenizer import tokenize
from richsem_tpu_torch.ops.roi_align import roi_align
from richsem_tpu_torch.utils.boxes import box_cxcywh_to_xyxy
from richsem_tpu_torch.utils.misc import l2_normalize

Tensor = torch.Tensor

_TEMPLATE_PATH = os.path.join(os.path.dirname(__file__), "clip", "prompt_templates.txt")


def load_prompt_templates() -> Sequence[str]:
    with open(_TEMPLATE_PATH) as f:
        return [line.rstrip("\n") for line in f if line.strip()]


@torch.no_grad()
def build_text_embedding(clip_model: CLIP, cats: Dict[int, dict], tokenizer,
                         context_length: int = 77, batch_size: int = 256) -> Tensor:
    """-> ``[max_id + 1, embed_dim]`` prompt-ensembled class text bank; ids
    missing from ``cats`` encode as the literal 'none'."""
    templates = load_prompt_templates()
    max_id = max(cats.keys())
    names = [cats.get(i, {"name": "none"})["name"].replace("_", " ")
             for i in range(max_id + 1)]
    dev = clip_model.token_embedding.device
    acc = None
    for tpl in templates:
        texts = [tpl.format(n) if n != "none" else n for n in names]
        toks = torch.from_numpy(tokenize(texts, tokenizer, context_length).astype(np.int64))
        emb = torch.cat([clip_model.encode_text(toks[s:s + batch_size].to(dev))
                         for s in range(0, len(toks), batch_size)])
        acc = emb if acc is None else acc + emb
    return acc / len(templates)


@torch.no_grad()
def clip_spatial_features(clip_model: CLIP, images: Tensor) -> Tensor:
    """ImageNet-normalized ``[B, H, W, 3]`` -> ``[B, H/32, W/32, Dv]``."""
    return clip_model.encode_image(denorm_imagenet_to_clip(images), ret_sp=True)


@torch.no_grad()
def clip_teacher_box_targets(
    clip_model: CLIP,
    images: Tensor,  # [B, H, W, 3] ImageNet-normalized
    gt_boxes: Tensor,  # [B, G, 4] normalized cxcywh
    sizes: Tensor,  # [B, 2] valid (h, w) in the canvas
    text_embed: Tensor,  # [C, D]
    logit_scale: Tensor,
    valid: Optional[Tensor] = None,  # [B, G] bool
    max_boxes: Optional[int] = None,
    spatial: Optional[Tensor] = None,  # clip_spatial_features, if already computed
) -> Tuple[Tensor, Tensor, Tensor]:
    """-> ``(clip_embed [B, G, D] normalized, clip_logits [B, G, C], clip_valid [B, G])``.

    Boxes are scaled by the image's valid size into canvas pixels and cropped
    at 1/32, the RN50 map's stride, on the attention pool's 7x7 grid."""
    if spatial is None:
        spatial = clip_spatial_features(clip_model, images)
    b, g = gt_boxes.shape[:2]
    k = g if (valid is None or max_boxes is None) else min(int(max_boxes), g)
    sel = None
    boxes_k, valid_k = gt_boxes, valid
    if k < g:
        order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
        sel = order[:, :k]
        boxes_k = torch.gather(gt_boxes, 1, sel[..., None].expand(-1, -1, 4))
        valid_k = torch.gather(valid, 1, sel)
    h, w = sizes[:, 0], sizes[:, 1]
    scale = torch.stack([w, h, w, h], -1).float()[:, None, :]
    boxes_xyxy = box_cxcywh_to_xyxy(boxes_k.float()) * scale
    grid = clip_model.cfg.image_resolution // 32
    crops = roi_align(spatial.float(), boxes_xyxy, output_size=grid,
                      spatial_scale=1.0 / 32.0, sampling_ratio=0, method="matmul")
    pooled = clip_model.attnpool(
        crops.reshape(b * k, grid, grid, crops.shape[-1])).reshape(b, k, -1)
    pooled = l2_normalize(pooled)  # in the tower's dtype, as JAX keeps it
    t = l2_normalize(text_embed.float())
    # a bf16 pooled embedding meets the f32 bank in f32, as JAX promotes it
    logits = torch.exp(logit_scale) * (pooled.float() @ t.t())
    if valid_k is not None:
        pooled = pooled * valid_k[..., None]
        logits = logits * valid_k[..., None]
    clip_valid = torch.ones(b, g, dtype=torch.bool, device=gt_boxes.device) \
        if valid is None else valid
    if sel is not None:
        bidx = torch.arange(b, device=sel.device)[:, None]
        full = pooled.new_zeros(b, g, pooled.shape[-1])
        full[bidx, sel] = pooled
        pooled = full
        full = logits.new_zeros(b, g, logits.shape[-1])
        full[bidx, sel] = logits
        logits = full
        clip_valid = torch.zeros(b, g, dtype=torch.bool, device=sel.device)
        clip_valid[bidx, sel] = valid_k
    return pooled, logits, clip_valid


def clip_pseudo_labels(clip_logits: Tensor, gt_valid: Tensor, threshold: float = 0.05):
    """Weak labels for extra data, one a slot: -> (the teacher's argmax class,
    keep = valid and its probability above ``threshold``)."""
    probs = torch.softmax(clip_logits, dim=-1)
    top, labels = probs.max(dim=-1)
    return labels, gt_valid & (top > threshold)


def _top_k(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, ties by lower index."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return torch.gather(x, -1, order), order


def clip_pseudo_labels_multi(clip_logits: Tensor, gt_boxes: Tensor, gt_valid: Tensor,
                             threshold: float = 0.05, expand_topk: int = 4):
    """Multi-label weak labels (richsem.py:631-670): every valid slot proposes its
    top-``expand_topk`` classes above ``threshold``; each slot's argmax ranks
    above every runner-up, runner-ups by probability, and the first ``G``
    candidates fill the slots.

    -> (labels [B, G], boxes [B, G, 4], keep [B, G], slot [B, G]: the source
    slot of each pair, to permute per-slot side data)."""
    b, g, _ = clip_logits.shape
    k = expand_topk
    probs = torch.softmax(clip_logits.float(), dim=-1)
    topp, topi = _top_k(probs, k)  # [B, G, K]
    cand_valid = gt_valid[..., None] & (topp > threshold)
    is_argmax = torch.arange(k, device=probs.device) == 0
    score = torch.where(cand_valid, topp + 2.0 * is_argmax, float("-inf"))
    _, sel = _top_k(score.reshape(b, g * k), g)
    slot = sel // k
    labels = torch.gather(topi.reshape(b, g * k), 1, sel)
    boxes = torch.gather(gt_boxes, 1, slot[..., None].expand(-1, -1, gt_boxes.shape[-1]))
    keep = torch.gather(cand_valid.reshape(b, g * k), 1, sel)
    return labels, boxes, keep, slot
