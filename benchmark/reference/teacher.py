"""Plain reference of the frozen CLIP-RN50 teacher's distillation targets, in
float32.

The visual tower (three stem convolutions, anti-aliased bottlenecks whose
stride is an average pool) gives a stride-32 map of the images; each image's
first ``max_boxes`` valid GT boxes, in canvas pixels, are cropped from it by
RoIAlign on the attention pool's grid (adaptive sampling, aligned corners,
taps outside the map zero); the attention pool embeds each crop, and the
target logits are exp(logit_scale) times the cosine with the text bank.
``T`` holds the teacher's leaves under their names (``visual.*``,
``logit_scale``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.detector import conv_nchw, cxcywh_to_xyxy, dense, frozen_bn, l2n

Tensor = torch.Tensor
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def spatial(T: Dict[str, Tensor], images: Tensor) -> Tensor:
    """ImageNet-normalised ``[B, H, W, 3]`` -> the stride-32 map ``[B, H/32, W/32, 2048]``."""
    dev = images.device
    raw = images * torch.tensor(IMAGENET_STD, device=dev) + torch.tensor(IMAGENET_MEAN, device=dev)
    x = ((raw - torch.tensor(CLIP_MEAN, device=dev)) / torch.tensor(CLIP_STD, device=dev))
    x = x.permute(0, 3, 1, 2)
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = torch.relu(frozen_bn(T, f"visual.bn{i}", conv_nchw(T, f"visual.conv{i}", x, stride, 1)))
    x = F.avg_pool2d(x, 2)
    for li, (blocks, stride) in enumerate(zip((3, 4, 6, 3), (1, 2, 2, 2))):
        for bi in range(blocks):
            n = f"visual.layer{li + 1}_block{bi}"
            s = stride if bi == 0 else 1
            y = torch.relu(frozen_bn(T, f"{n}.bn1", conv_nchw(T, f"{n}.conv1", x)))
            y = torch.relu(frozen_bn(T, f"{n}.bn2", conv_nchw(T, f"{n}.conv2", y, 1, 1)))
            if s > 1:
                y = F.avg_pool2d(y, s)
            y = frozen_bn(T, f"{n}.bn3", conv_nchw(T, f"{n}.conv3", y))
            if bi == 0:
                idn = F.avg_pool2d(x, s) if s > 1 else x
                x = frozen_bn(T, f"{n}.downsample_bn", conv_nchw(T, f"{n}.downsample_conv", idn))
            x = torch.relu(y + x)
    return x.permute(0, 2, 3, 1)


def _axis(start: Tensor, extent: Tensor, size: int, o: int) -> Tensor:
    """[B, R] box starts and extents on one axis -> [B, R, o, size]: each bin's
    average over ``ceil(extent / o)`` bilinear samples (at least 1, at most
    ``ceil(size / o)``), zero for a box of no extent."""
    nmax = max(1, math.ceil(size / o))
    ng = torch.clamp(torch.ceil(extent / o), 1.0, float(nmax))
    j = torch.arange(nmax, device=start.device, dtype=torch.float32)
    used = (j < ng[..., None]).float() / ng[..., None] * (extent > 0)[..., None].float()
    pos = (torch.arange(o, device=start.device, dtype=torch.float32)[:, None]
           + (j + 0.5)[None, :] / ng[..., None, None])  # [B, R, o, nmax]
    coord = start[..., None, None] + extent[..., None, None] / o * pos
    cells = torch.arange(size, device=start.device, dtype=torch.float32)
    tap = torch.clamp(1.0 - (coord[..., None] - cells).abs(), min=0.0)  # [B, R, o, nmax, size]
    return (tap * used[:, :, None, :, None]).sum(3)


def roi_align(feat: Tensor, boxes: Tensor, o: int, scale: float) -> Tensor:
    """``feat [B, H, W, C]``, ``boxes [B, R, 4]`` xyxy -> ``[B, R, o, o, C]``."""
    b, h, w, c = feat.shape
    bx = boxes * scale
    ay = _axis(bx[..., 1] - 0.5, bx[..., 3] - bx[..., 1], h, o)
    ax = _axis(bx[..., 0] - 0.5, bx[..., 2] - bx[..., 0], w, o)
    out = torch.einsum("briy,brjx,byxc->brijc", ay, ax, feat)
    return out


def attnpool(T: Dict[str, Tensor], x: Tensor, heads: int = 32) -> Tensor:
    """CLIP's attention pool of ``[N, h, w, C]`` -> ``[N, 1024]``."""
    n, h, w, c = x.shape
    tok = x.reshape(n, h * w, c)
    tok = torch.cat([tok.mean(1, keepdim=True), tok], 1)
    tok = tok + T["visual.attnpool.positional_embedding"][None, :h * w + 1]
    hd = c // heads
    q = dense(T, "visual.attnpool.q_proj", tok[:, :1]).reshape(n, 1, heads, hd)
    k = dense(T, "visual.attnpool.k_proj", tok).reshape(n, -1, heads, hd)
    v = dense(T, "visual.attnpool.v_proj", tok).reshape(n, -1, heads, hd)
    a = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd), -1)
    out = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(n, c)
    return dense(T, "visual.attnpool.c_proj", out)


def box_targets(T: Dict[str, Tensor], images: Tensor, boxes: Tensor, sizes: Tensor,
                valid: Tensor, text: Tensor, max_boxes: int, grid: int = 7
                ) -> Tuple[Tensor, Tensor]:
    """-> (``clip_logits [B, G, C]``, ``clip_valid [B, G]``): the teacher at
    each image's first ``max_boxes`` valid GT boxes (normalised cxcywh of the
    valid extent ``sizes`` (h, w)); the other slots zero and not valid."""
    with torch.no_grad():
        sp = spatial(T, images)
        b, g = boxes.shape[:2]
        k = min(max_boxes, g)
        sel = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)[:, :k]
        bk = torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4))
        vk = torch.gather(valid, 1, sel)
        h, w = sizes[:, 0].float(), sizes[:, 1].float()
        xyxy = cxcywh_to_xyxy(bk) * torch.stack([w, h, w, h], -1)[:, None]
        crops = roi_align(sp, xyxy, grid, 1.0 / 32)
        pooled = l2n(attnpool(T, crops.reshape(b * k, grid, grid, -1))).reshape(b, k, -1)
        logits = torch.exp(T["logit_scale"]) * (pooled @ l2n(text).t()) * vk[..., None]
        full = torch.zeros(b, g, text.shape[0], device=images.device)
        full.scatter_(1, sel[..., None].expand(-1, -1, text.shape[0]), logits)
        cv = torch.zeros(b, g, dtype=torch.bool, device=images.device).scatter(1, sel, vk)
    return full, cv
