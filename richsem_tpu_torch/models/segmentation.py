"""Instance segmentation heads (counterpart of ``richsem_tpu/models/segmentation.py``).

The DETRsegm pattern: per-query multi-head attention maps over the C5 feature
(:class:`MHAttentionMap`) feed an FPN-style small conv head
(:class:`MaskHeadSmallConv`) that upsamples through C4/C3 adapters to
stride-8 per-query masks; the focal and dice mask losses on the matched
queries (:func:`loss_masks`) and the resize-and-threshold of
``PostProcessSegm`` (:func:`postprocess_segm`).

No flax module of the JAX heads sets ``dtype=``, so flax computes them in the
f32 of their parameters even on bf16 features: here the convolutions and
products promote to f32 in the same way (``Conv`` and ``Dense`` with no
compute dtype), with TF32 off (:func:`exact_f32`). Feature maps come in
channel-last ``[B, H, W, C]``; the conv head runs channel-first with the
queries folded into the batch axis, its ``GroupNorm(min(8, ch))`` with flax's
epsilon 1e-6 (PyTorch's group norm takes the two-pass variance where flax
takes the mean of squares less the squared mean: the same function up to
f32 rounding, and a third of the saved activations).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from richsem_tpu_torch.models.layers import Conv, Dense, GroupNorm


@contextlib.contextmanager
def exact_f32():
    """TF32 off for cuDNN's convolutions and cuBLAS's products while the block
    runs, the flags put back after: the mask heads' f32 work is f32, as
    flax's. The train step's backward runs under it too."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def _exact(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with exact_f32():
            return fn(*args, **kw)
    return run


class MHAttentionMap(nn.Module):
    """Per-query spatial attention maps (a softmax over all positions a head)."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Dense(hidden_dim, hidden_dim, device=device)
        self.k_proj = Conv(hidden_dim, hidden_dim, 1, device=device)

    @_exact
    def forward(self, queries: Tensor, feature: Tensor, pad_mask=None) -> Tensor:
        """queries [B, Q, C], feature [B, H, W, C] -> [B, Q, heads, H, W] f32."""
        b, q_n, _ = queries.shape
        _, h, w, _ = feature.shape
        hd = self.q_proj.out_features // self.num_heads
        q = self.q_proj(queries).reshape(b, q_n, self.num_heads, hd)
        k = self.k_proj(feature).reshape(b, h * w, self.num_heads, hd)
        logits = torch.einsum("bqnd,bsnd->bqns", q, k) * (hd**-0.5)
        if pad_mask is not None:
            logits = logits.masked_fill(pad_mask.reshape(b, 1, 1, h * w), -1e9)
        attn = torch.softmax(logits, dim=-1)
        return attn.reshape(b, q_n, self.num_heads, h, w)

    def init_weights(self, g: torch.Generator) -> None:
        self.q_proj.init_weights(g)
        self.k_proj.init_weights(g)


def nearest_index(src: int, dst: int, device=None) -> Tensor:
    """``jax.image.resize(..., "nearest")``'s source index along one axis:
    ``floor((i + 0.5) * src / dst)``, the half-pixel centres (PyTorch's
    ``nearest-exact``), in exact integer arithmetic."""
    i = torch.arange(dst, device=device)
    return ((2 * i + 1) * src) // (2 * dst)


def upsample_nearest(x: Tensor, hw: Tuple[int, int]) -> Tensor:
    """[N, C, H, W] -> [N, C, h, w], ``jax.image.resize(..., "nearest")``."""
    ys = nearest_index(x.shape[2], hw[0], x.device)
    xs = nearest_index(x.shape[3], hw[1], x.device)
    return x.index_select(2, ys).index_select(3, xs)


def upsample_bilinear(x: Tensor, hw: Tuple[int, int]) -> Tensor:
    """[..., H, W] -> [..., h, w], ``jax.image.resize(..., "bilinear")`` for a
    size not below the input's: half-pixel centres, edges clamped."""
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, *x.shape[-2:]), size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return y.reshape(*lead, *hw)


class MaskHeadSmallConv(nn.Module):
    """FPN-style conv mask head: (C5 projection ++ attention maps) up to C4 and
    C3 -> one channel. Its modules carry the flax names (``lay1_conv``,
    ``lay1_gn``, ..., ``adapter4``, ``adapter3``, ``out_conv``)."""

    def __init__(self, hidden_dim: int, num_heads: int = 8, device=None):
        super().__init__()
        d = hidden_dim
        widths = (("lay1", d, d), ("lay2", d + num_heads, d), ("lay3", d, d // 2),
                  ("lay4", d // 2, d // 4), ("lay5", d // 4, d // 8))
        for name, cin, ch in widths:  # 3x3 conv -> GroupNorm(min(8, ch)) -> relu
            self.add_module(f"{name}_conv", Conv(cin, ch, 3, padding=1, device=device))
            self.add_module(f"{name}_gn", GroupNorm(ch, num_groups=min(8, ch), eps=1e-6,
                                                    device=device))
        self.adapter4 = Conv(d, d // 2, 1, device=device)
        self.adapter3 = Conv(d, d // 4, 1, device=device)
        self.out_conv = Conv(d // 8, 1, 3, padding=1, device=device)

    def _block(self, x: Tensor, name: str) -> Tensor:
        """conv -> GroupNorm -> relu on [N, C, H, W]."""
        gn = getattr(self, f"{name}_gn")
        y = getattr(self, f"{name}_conv").forward_nchw(x)
        return torch.relu_(F.group_norm(y, gn.num_groups, gn.weight, gn.bias, gn.eps))

    @_exact
    def forward(self, attn_maps: Tensor, c5: Tensor, c4: Tensor, c3: Tensor) -> Tensor:
        """attn_maps [B, Q, heads, H5, W5], c5/c4/c3 [B, H, W, C] -> mask logits
        [B, Q, H3, W3] (stride 8), f32."""
        b, q_n, heads, h5, w5 = attn_maps.shape

        def fold(t):  # [B, C, H, W] -> the same map for each query, [B * Q, C, H, W]
            return t[:, None].expand(b, q_n, *t.shape[1:]).reshape(b * q_n, *t.shape[1:])

        c5_p = self._block(c5.permute(0, 3, 1, 2), "lay1")  # [B, d, H5, W5]
        # the C5 projection first, then the heads' maps (flax's channel order)
        x = self._block(torch.cat([fold(c5_p), attn_maps.reshape(b * q_n, heads, h5, w5)
                                   .to(c5_p.dtype)], dim=1), "lay2")
        for level, adapter, name in ((c4, self.adapter4, "lay3"), (c3, self.adapter3, "lay4")):
            a = adapter.forward_nchw(level.permute(0, 3, 1, 2))  # [B, d', H, W]
            x = upsample_nearest(self._block(x, name), level.shape[1:3]) + fold(a)
        out = self.out_conv.forward_nchw(self._block(x, "lay5"))
        return out.reshape(b, q_n, c3.shape[1], c3.shape[2])

    def init_weights(self, g: torch.Generator) -> None:
        for m in self.children():
            m.init_weights(g)


def dice_loss(logits: Tensor, targets: Tensor, valid: Tensor, num_boxes) -> Tensor:
    """logits/targets [N, H, W], valid [N] -> the dice loss over ``num_boxes``."""
    p = torch.sigmoid(logits.float()).reshape(logits.shape[0], -1)
    t = targets.float().reshape(targets.shape[0], -1)
    num = 2.0 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    loss = 1.0 - (num + 1.0) / (den + 1.0)
    return (loss * valid.float()).sum() / num_boxes


def mask_focal_loss(logits: Tensor, targets: Tensor, valid: Tensor, num_boxes,
                    alpha: float = 0.25, gamma: float = 2.0) -> Tensor:
    """The sigmoid focal loss a pixel, its mean a mask, over ``num_boxes``."""
    lg = logits.float()
    t = targets.float()
    ce = lg.clamp(min=0) - lg * t + torch.log1p(torch.exp(-lg.abs()))
    p = torch.sigmoid(lg)
    p_t = p * t + (1 - p) * (1 - t)
    a_t = alpha * t + (1 - alpha) * (1 - t)
    loss = (a_t * ce * (1 - p_t) ** gamma).mean(dim=(-2, -1))
    return (loss * valid.float()).sum() / num_boxes


def loss_masks(pred_masks: Tensor, col: Tensor, gt_masks: Tensor, gt_valid: Tensor,
               num_boxes) -> Dict[str, Tensor]:
    """The mask losses of the matched queries: ``pred_masks [B, Q, Hm, Wm]``,
    ``col [B, G]`` (the query matched to each GT slot, -1 none), ``gt_masks
    [B, G, Hm, Wm]``, ``gt_valid [B, G]``."""
    b, g = col.shape
    idx = col.clamp(min=0)[:, :, None, None].expand(-1, -1, *pred_masks.shape[2:])
    sel = torch.gather(pred_masks, 1, idx).reshape(b * g, *pred_masks.shape[2:])
    m = (gt_valid & (col >= 0)).reshape(-1)
    tgt = gt_masks.reshape(b * g, *gt_masks.shape[2:])
    return {"loss_mask": mask_focal_loss(sel, tgt, m, num_boxes),
            "loss_dice": dice_loss(sel, tgt, m, num_boxes)}


def postprocess_segm(mask_logits: Tensor, target_sizes: Tensor, canvas_hw: Tuple[int, int],
                     threshold: float = 0.5) -> Tensor:
    """mask logits of the selected queries ``[B, K, Hm, Wm]`` -> binary masks at
    the padded canvas ``[B, K, H, W]`` (bilinear, then sigmoid above
    ``threshold``), as ``PostProcessSegm``; the crop and resize of each image
    to its own size is a host step, since the sizes vary. ``target_sizes`` is
    not read, as in the JAX package."""
    del target_sizes
    return torch.sigmoid(upsample_bilinear(mask_logits.float(), canvas_hw)) > threshold
