"""CondInst dynamic-convolution mask head (counterpart of ``richsem_tpu/models/cond_inst.py``).

* a **controller** MLP maps each query embedding to the flattened weights and
  biases of a tiny per-instance network of 1x1 convolutions
  (:func:`dynamic_param_layout`, :func:`parse_dynamic_params`);
* a **mask branch** fuses the stride-8/16/32 encoder features into one stride-8
  mask feature map of ``hidden_dim // channel_div`` channels
  (:class:`CondInstMaskBranch`);
* an instance's mask is its dynamic network applied a pixel to [relative
  coordinates to the instance centre ++ mask features]
  (:func:`dynamic_mask_logits`).

The dynamic 1x1 convolutions are batched products over ``[B, K, H*W, C]``; the
instances are static slots (the criterion's matched GT slots), so every shape
is static. The relative coordinates and the dynamic network compute in f32;
the branch's convolutions promote to the f32 of their parameters, as flax's
modules without ``dtype=`` do, and run as im2col products
(:func:`conv_gemm`): for a 256-channel 3x3 f32 convolution (TF32 off) on
the stride-8 map cuDNN picks an FFT algorithm hundreds of times slower
than the product (``chip_smoke.py`` phase 25 times both).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from richsem_tpu_torch.models.layers import MLP, Conv, LayerNorm
from richsem_tpu_torch.models.segmentation import _exact, upsample_bilinear


def dynamic_param_layout(in_channels: int, dy_channels: int, layers: int = 3,
                         rel_coord: bool = True) -> Tuple[List[int], List[int]]:
    """The weight and bias element counts of each dynamic layer."""
    weight_nums, bias_nums = [], []
    for i in range(layers):
        if i == 0:
            weight_nums.append((in_channels + (2 if rel_coord else 0)) * dy_channels)
            bias_nums.append(dy_channels)
        elif i == layers - 1:
            weight_nums.append(dy_channels)
            bias_nums.append(1)
        else:
            weight_nums.append(dy_channels * dy_channels)
            bias_nums.append(dy_channels)
    return weight_nums, bias_nums


def parse_dynamic_params(params: Tensor, in_channels: int, dy_channels: int, layers: int = 3,
                         rel_coord: bool = True) -> List[Tuple[Tensor, Tensor]]:
    """``params [B, K, n]`` -> (w [B, K, cin, cout], b [B, K, cout]) a dynamic
    layer; each layer's weights are laid out as a conv weight ``[cout, cin]``."""
    weight_nums, bias_nums = dynamic_param_layout(in_channels, dy_channels, layers, rel_coord)
    out, pos = [], 0
    cin = in_channels + (2 if rel_coord else 0)
    for wn, bn in zip(weight_nums, bias_nums):
        w = params[..., pos:pos + wn].reshape(*params.shape[:-1], bn, cin).transpose(-1, -2)
        pos += wn
        out.append((w, params[..., pos:pos + bn]))
        pos += bn
        cin = bn
    return out


def compute_locations(h: int, w: int, stride: int, device=None) -> Tensor:
    """Pixel-centre coordinates ``stride * i + stride // 2`` of a grid,
    ``[h, w, 2]`` in (x, y) order."""
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride + stride // 2
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride + stride // 2
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


@_exact
def dynamic_mask_logits(mask_feats: Tensor, params: Tensor, centers_px: Tensor,
                        dy_channels: int = 8, layers: int = 3, rel_coord: bool = True,
                        mask_feat_stride: int = 8, sizes_px: Tensor = None) -> Tensor:
    """``mask_feats [B, Hm, Wm, Cm]``, ``params [B, K, n]``, instance centres
    ``[B, K, 2]`` in image pixels (x, y) -> mask logits ``[B, K, Hm, Wm]``;
    ``sizes_px [B, K, 2]`` (w, h) scales the relative coordinates
    (``use_relative_hw``)."""
    b, hm, wm, cm = mask_feats.shape
    k = params.shape[1]
    feats = mask_feats.reshape(b, 1, hm * wm, cm).expand(b, k, hm * wm, cm).float()
    if rel_coord:
        loc = compute_locations(hm, wm, mask_feat_stride, mask_feats.device)
        rel = centers_px.float()[:, :, None, :] - loc.reshape(1, 1, hm * wm, 2)
        if sizes_px is not None:
            rel = rel / sizes_px[:, :, None, :].clamp(min=1e-3) * 2.0
        x = torch.cat([rel, feats], dim=-1)
    else:
        x = feats
    for i, (w, bias) in enumerate(parse_dynamic_params(params.float(), cm, dy_channels,
                                                       layers, rel_coord)):
        x = torch.einsum("bksc,bkcd->bksd", x, w) + bias[:, :, None, :]
        if i < layers - 1:
            x = torch.relu(x)
    return x[..., 0].reshape(b, k, hm, wm)


def box_centers_px(boxes: Tensor, mask_feats: Tensor, stride: int) -> Tensor:
    """The centres of normalized cxcywh ``boxes [B, K, 4]`` in the pixels of the
    canvas that ``mask_feats [B, Hm, Wm, Cm]`` covers at ``stride``."""
    hm, wm = mask_feats.shape[1:3]
    return torch.stack([boxes[..., 0].float() * float(wm * stride),
                        boxes[..., 1].float() * float(hm * stride)], dim=-1)


def aligned_upsample(x: Tensor, factor: int) -> Tensor:
    """[B, K, H, W] -> [B, K, H*f, W*f], bilinear (``aligned_bilinear``)."""
    if factor == 1:
        return x
    return upsample_bilinear(x, (x.shape[-2] * factor, x.shape[-1] * factor))


def conv_gemm(conv: Conv, x: Tensor) -> Tensor:
    """``conv`` (stride 1, ``padding`` k // 2) of channel-last ``x`` [B, H, W,
    C] in f32 as one product of its weight [O, C*k*k] and the unfolded
    patches [B, C*k*k, H*W] -> [B, H, W, O]."""
    b, h, w, _ = x.shape
    k = conv.kernel_size[0]
    cols = F.unfold(x.permute(0, 3, 1, 2).float(), k, padding=k // 2)
    y = conv.weight.reshape(conv.out_channels, -1).float() @ cols + conv.bias.float()[:, None]
    return y.reshape(b, -1, h, w).permute(0, 2, 3, 1)


class CondInstMaskBranch(nn.Module):
    """The stride-8 mask feature map from the projected levels: a 3x3 conv +
    LayerNorm + relu refine a level (``refine{i}_conv``, ``refine{i}_ln``),
    upsampled onto the first level and summed, a tower of ``num_convs`` such
    blocks (``tower{i}_*``) and a 1x1 conv to ``out_channels`` (``tower_out``)."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int = 128,
                 num_convs: int = 4, levels: int = 3, device=None):
        super().__init__()
        self.levels, self.num_convs = levels, num_convs
        blocks = [(f"refine{i}", in_channels) for i in range(levels)]
        blocks += [(f"tower{i}", hidden_channels) for i in range(num_convs)]
        for name, cin in blocks:
            self.add_module(f"{name}_conv", Conv(cin, hidden_channels, 3, padding=1,
                                                 device=device))
            self.add_module(f"{name}_ln", LayerNorm(hidden_channels, 1e-5, device=device))
        self.tower_out = Conv(hidden_channels, out_channels, 1, device=device)

    def _block(self, x: Tensor, name: str) -> Tensor:
        return torch.relu(getattr(self, f"{name}_ln")(conv_gemm(getattr(self, f"{name}_conv"), x)))

    @_exact
    def forward(self, srcs: Sequence[Tensor]) -> Tensor:
        """``srcs`` [B, H, W, C] a level, finest first -> [B, H0, W0, out]."""
        x = None
        for i, s in enumerate(srcs):
            r = self._block(s, f"refine{i}")
            if x is None:
                x = r
            else:
                r = upsample_bilinear(r.permute(0, 3, 1, 2), x.shape[1:3]).permute(0, 2, 3, 1)
                x = x + r
        for i in range(self.num_convs):
            x = self._block(x, f"tower{i}")
        return conv_gemm(self.tower_out, x)

    def init_weights(self, g: torch.Generator) -> None:
        for m in self.children():
            m.init_weights(g)


class CondInstHead(nn.Module):
    """The controller and the mask branch (``cond_inst.controller``,
    ``cond_inst.mask_branch``)."""

    def __init__(self, hidden_dim: int, channel_div: int = 32, dy_channels: int = 8,
                 controller_layers: int = 3, rel_coord: bool = True,
                 mask_feat_stride: int = 8, device=None):
        super().__init__()
        self.dy_channels, self.controller_layers = dy_channels, controller_layers
        self.rel_coord, self.mask_feat_stride = rel_coord, mask_feat_stride
        self.mask_channels = max(hidden_dim // channel_div, 1)
        wn, bn = dynamic_param_layout(self.mask_channels, dy_channels, controller_layers,
                                      rel_coord)
        self.num_gen_params = sum(wn) + sum(bn)
        self.controller = MLP(hidden_dim, hidden_dim, self.num_gen_params, 3, device=device)
        self.mask_branch = CondInstMaskBranch(hidden_dim, self.mask_channels, device=device)

    def layout(self) -> dict:
        """The dynamic networks' layout, which the criterion reads."""
        return {"dy_channels": self.dy_channels, "layers": self.controller_layers,
                "rel_coord": self.rel_coord}

    def mask_features(self, srcs: Sequence[Tensor]) -> Tensor:
        return self.mask_branch(srcs)

    def controller_params(self, hs: Tensor) -> Tensor:
        return self.controller(hs)

    def instance_masks(self, mask_feats: Tensor, params: Tensor, boxes: Tensor) -> Tensor:
        """Mask logits of instances at normalized cxcywh ``boxes [B, K, 4]``."""
        return dynamic_mask_logits(mask_feats, params, box_centers_px(boxes, mask_feats,
                                                                   self.mask_feat_stride),
                                   dy_channels=self.dy_channels, layers=self.controller_layers,
                                   rel_coord=self.rel_coord,
                                   mask_feat_stride=self.mask_feat_stride)

    def init_weights(self, g: torch.Generator) -> None:
        self.controller.init_weights(g)
        self.mask_branch.init_weights(g)
