"""CLIP-RN50, the frozen teacher (counterpart of ``richsem_tpu/models/clip/model.py``).

* :class:`ModifiedResNet` -- the 3-conv stem and average pool, anti-aliased
  bottlenecks (an average pool takes the stride) and the
  :class:`AttentionPool2d` head, whose mean-token query gives the image
  embedding. ``encode_image(..., ret_sp=True)`` returns the stride-32 map
  before the pool, which the distillation crops.
* The text tower: causal residual attention blocks with QuickGELU, pooled at
  the end-of-text token (the largest token id) through ``text_projection``.

Precision follows the flax modules cast for cast: the vision tower's convs and
attention-pool projections compute in ``CLIPConfig.dtype`` (bf16 for the
flagship teacher, as the reference runs it in fp16), the attention-pool
softmax in f32 cast back, the frozen batch norms in the input's dtype; the
text tower computes in f32. Module and parameter names follow the flax tree,
so :func:`richsem_tpu_torch.utils.convert.clip_params_from_jax` is reshapes
and transposes only. The ViT tower is not ported (ROADMAP.md queue 1, item 11).

Images are channel-last ``[B, H, W, 3]``, CLIP-normalized.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from richsem_tpu_torch.models.layers import (
    Conv,
    Dense,
    LayerNorm,
    MultiHeadAttention,
    normal_,
)
from richsem_tpu_torch.models.resnet import FrozenBatchNorm

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
# the detector's input normalization (richsem_tpu/data/transforms.py:30-31)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    name: str = "RN50"
    embed_dim: int = 1024  # joint space
    vision_layers: Tuple[int, ...] = (3, 4, 6, 3)
    vision_width: int = 64
    vision_heads: int = 32
    image_resolution: int = 224
    vision_patch_size: int = 32  # ViT only
    is_vit: bool = False
    context_length: int = 77
    vocab_size: int = 49408
    transformer_width: int = 512
    transformer_heads: int = 8
    transformer_layers: int = 12
    # vision-tower compute dtype (parameters stay f32; None = f32)
    dtype: Optional[torch.dtype] = None

    @classmethod
    def rn50(cls) -> "CLIPConfig":
        return cls()


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class ClipBottleneck(nn.Module):
    """Anti-aliased bottleneck: the stride is an average pool; NCHW in and out."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        out_ch = planes * 4
        kw = dict(bias=False, dtype=dtype, device=device)
        self.stride = stride
        self.conv1 = Conv(in_ch, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv(planes, out_ch, 1, **kw)
        self.bn3 = FrozenBatchNorm(out_ch, device=device)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_ch, out_ch, 1, **kw)
            self.downsample_bn = FrozenBatchNorm(out_ch, device=device)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(x, self.stride) if self.stride > 1 else x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1.forward_nchw(x)))
        y = torch.relu(self.bn2(self.conv2.forward_nchw(y)))
        y = self.bn3(self.conv3.forward_nchw(self._pool(y)))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv.forward_nchw(self._pool(x)))
        return torch.relu(y + identity)


class AttentionPool2d(nn.Module):
    """Mean-token-query attention pooling of ``[B, H, W, C]`` with ``H*W`` the
    positional grid (the 7x7 RoI crops and a 224 input alike)."""

    def __init__(self, embed_dim: int, num_heads: int, output_dim: int,
                 spacial_dim: int = 7, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial_dim ** 2 + 1, embed_dim, device=device))
        for name in ("q_proj", "k_proj", "v_proj"):
            self.add_module(name, Dense(embed_dim, embed_dim, dtype=dtype, device=device))
        self.c_proj = Dense(embed_dim, output_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
        tokens = tokens + self.positional_embedding[None, : h * w + 1]  # promotes to f32
        hd = self.embed_dim // self.num_heads
        q = self.q_proj(tokens[:, :1]).reshape(b, 1, self.num_heads, hd)
        k = self.k_proj(tokens).reshape(b, -1, self.num_heads, hd)
        v = self.v_proj(tokens).reshape(b, -1, self.num_heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)  # f32 whatever the tower
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, 1, self.embed_dim)
        return self.c_proj(out[:, 0])

    def init_weights(self, g: torch.Generator) -> None:
        normal_(self.positional_embedding, g, self.embed_dim ** -0.5)
        for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
            getattr(self, name).init_weights(g)


class ModifiedResNet(nn.Module):
    def __init__(self, cfg: CLIPConfig, device=None):
        super().__init__()
        w, dt = cfg.vision_width, cfg.dtype
        in_ch = 3
        for i, (ch, stride) in enumerate([(w // 2, 2), (w // 2, 1), (w, 1)]):
            self.add_module(f"conv{i + 1}", Conv(in_ch, ch, 3, stride=stride, padding=1,
                                                 bias=False, dtype=dt, device=device))
            self.add_module(f"bn{i + 1}", FrozenBatchNorm(ch, device=device))
            in_ch = ch
        self.block_names = []
        for li, (n_blocks, planes, stride) in enumerate(
                zip(cfg.vision_layers, (w, w * 2, w * 4, w * 8), (1, 2, 2, 2))):
            for bi in range(n_blocks):
                name = f"layer{li + 1}_block{bi}"
                self.add_module(name, ClipBottleneck(
                    in_ch, planes, stride=stride if bi == 0 else 1, downsample=bi == 0,
                    dtype=dt, device=device))
                in_ch = planes * 4
                self.block_names.append(name)
        self.attnpool = AttentionPool2d(w * 32, cfg.vision_heads, cfg.embed_dim,
                                        cfg.image_resolution // 32, dt, device)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, H, W, 3]`` -> the stride-32 map ``[B, H/32, W/32, 32 * width]``."""
        y = x.permute(0, 3, 1, 2)
        for i in range(1, 4):
            conv, bn = getattr(self, f"conv{i}"), getattr(self, f"bn{i}")
            y = torch.relu(bn(conv.forward_nchw(y)))
        y = F.avg_pool2d(y, 2)
        for name in self.block_names:
            y = getattr(self, name)(y)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, ret_sp: bool = False) -> torch.Tensor:
        y = self.features(x)
        return y if ret_sp else self.attnpool(y)

    def init_weights(self, g: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (Conv, FrozenBatchNorm)):
                mod.init_weights(g)
        self.attnpool.init_weights(g)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention block of the text tower (f32)."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, 1e-5, device=device)
        self.attn = MultiHeadAttention(width, heads, torch.float32, device=device)
        self.ln_2 = LayerNorm(width, 1e-5, device=device)
        self.mlp_c_fc = Dense(width, width * 4, dtype=torch.float32, device=device)
        self.mlp_c_proj = Dense(width * 4, width, dtype=torch.float32, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        h = self.ln_1(x)
        mask = None
        if causal:
            n = x.shape[1]
            mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))[None, None]
        x = x + self.attn(h, h, h, mask=mask)
        return x + self.mlp_c_proj(quick_gelu(self.mlp_c_fc(self.ln_2(x))))

    def init_weights(self, g: torch.Generator) -> None:
        for mod in (self.ln_1, self.attn, self.ln_2, self.mlp_c_fc, self.mlp_c_proj):
            mod.init_weights(g)


class CLIP(nn.Module):
    """Build with ``CLIP(cfg, device)``, then ``init_weights(generator)`` or load a
    converted state dict; the teacher is used frozen, in eval mode."""

    def __init__(self, cfg: CLIPConfig, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CLIP builds on 'cuda' unless asked otherwise, and no CUDA device is "
                "available; pass device='cpu' to build on the CPU")
        if cfg.is_vit:
            raise NotImplementedError(
                "the CLIP ViT tower is not ported to richsem_tpu_torch yet "
                "(ROADMAP.md queue 1, item 11)")
        self.cfg = cfg
        self.visual = ModifiedResNet(cfg, device)
        for i in range(cfg.transformer_layers):
            self.add_module(f"text_block{i}", ResidualAttentionBlock(
                cfg.transformer_width, cfg.transformer_heads, device))
        self.token_embedding = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.transformer_width, device=device))
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.transformer_width, device=device))
        self.ln_final = LayerNorm(cfg.transformer_width, 1e-5, device=device)
        self.text_projection = nn.Parameter(
            torch.empty(cfg.transformer_width, cfg.embed_dim, device=device))
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    def text_blocks(self):
        return [getattr(self, f"text_block{i}") for i in range(self.cfg.transformer_layers)]

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Random weights from ``g``, following the flax initializers."""
        self.visual.init_weights(g)
        for blk in self.text_blocks():
            blk.init_weights(g)
        normal_(self.token_embedding, g, 0.02)
        normal_(self.positional_embedding, g, 0.01)
        self.ln_final.init_weights(g)
        normal_(self.text_projection, g, self.cfg.transformer_width ** -0.5)
        self.logit_scale.fill_(math.log(1 / 0.07))

    def encode_image(self, images: torch.Tensor, ret_sp: bool = False) -> torch.Tensor:
        """images ``[B, H, W, 3]`` CLIP-normalized."""
        return self.visual(images, ret_sp=ret_sp)

    def attnpool(self, spatial: torch.Tensor) -> torch.Tensor:
        """Pool a stride-32 map, or RoI crops flattened into the batch."""
        return self.visual.attnpool(spatial)

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``[B, context_length]`` int -> ``[B, embed_dim]``."""
        x = self.token_embedding[tokens] + self.positional_embedding[None, : tokens.shape[1]]
        for blk in self.text_blocks():
            x = blk(x, causal=True)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # the end-of-text token has the largest id
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection


def denorm_imagenet_to_clip(images: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalized -> CLIP-normalized (``clip/model.py:338-343``)."""
    def const(a):
        return torch.as_tensor(a, device=images.device)

    raw = images * const(IMAGENET_STD) + const(IMAGENET_MEAN)
    return (raw - const(CLIP_MEAN)) / const(CLIP_STD)
