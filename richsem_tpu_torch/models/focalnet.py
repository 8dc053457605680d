"""FocalNet backbone (counterpart of ``richsem_tpu/models/focalnet.py``).

4x4 patch embedding, four stages of focal-modulation blocks (a query
projection modulated by hierarchical gated depthwise-convolution contexts and
a global context), a 2x2 stride-2 convolution then a LN between stages (the
reverse of ConvNeXt's order), and a LN on each output stage. Channel-last
throughout; the convolutions take NCHW views.

Precision follows the flax modules: the LNs return f32; the projections, the
focal convolutions (no bias) and the 1x1 ``h`` convolution compute in
``dtype``, and so does the gating arithmetic between them. The global context
is the mean over every position of the map, padding included.

Stochastic depth is never drawn (the JAX detector calls its backbone with
``deterministic`` True), as in :mod:`richsem_tpu_torch.models.swin`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from richsem_tpu_torch.models.layers import Conv, Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class FocalNetConfig:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    focal_level: int = 3
    focal_window: int = 3
    drop_path_rate: float = 0.3
    out_indices: Tuple[int, ...] = (1, 2, 3)
    dtype: Any = None  # conv/matmul compute dtype (params and norms stay f32)

    @classmethod
    def variant(cls, name: str) -> "FocalNetConfig":
        table = {
            "focalnet_L_384_22k": cls(),
            "focalnet_L_384_22k_fl4": cls(focal_level=4),
            "focalnet_XL_384_22k": cls(embed_dim=256),
            "focalnet_XL_384_22k_fl4": cls(embed_dim=256, focal_level=4),
            "focalnet_H_224_22k": cls(embed_dim=352),
            "focalnet_H_224_22k_fl4": cls(embed_dim=352, focal_level=4),
        }
        if name not in table:
            raise KeyError(f"unknown focalnet variant {name}")
        return table[name]

    def num_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2**i for i in self.out_indices)


class FocalModulation(nn.Module):
    def __init__(self, dim: int, focal_level: int, focal_window: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dim, self.focal_level = dim, focal_level
        self.f = Dense(dim, 2 * dim + focal_level + 1, dtype=dtype, device=device)
        for lvl in range(focal_level):
            k = focal_window + 2 * lvl
            self.add_module(f"focal_conv{lvl}", Conv(
                dim, dim, k, padding=k // 2, groups=dim, bias=False, dtype=dtype,
                device=device))
        self.h = Conv(dim, dim, 1, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, H, W, C]."""
        d, levels = self.dim, self.focal_level
        f = self.f(x)
        q, ctx, gates = f[..., :d], f[..., d:2 * d], f[..., 2 * d:]
        ctx_all = torch.zeros_like(ctx)
        for lvl in range(levels):
            ctx = F.gelu(getattr(self, f"focal_conv{lvl}")(ctx), approximate="tanh")
            ctx_all = ctx_all + ctx * gates[..., lvl:lvl + 1]
        # jnp.mean sums a bf16 array in f32 and divides before rounding once
        ctx_global = F.gelu(torch.mean(ctx, dim=(1, 2), keepdim=True, dtype=torch.float32)
                            .to(ctx.dtype), approximate="tanh")
        ctx_all = ctx_all + ctx_global * gates[..., levels:]
        return self.proj(q * self.h(ctx_all))

    def init_weights(self, g: torch.Generator) -> None:
        for mod in self.children():
            mod.init_weights(g)


class FocalBlock(nn.Module):
    def __init__(self, dim: int, focal_level: int, focal_window: int, drop_path: float,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.drop_path = drop_path  # never drawn (module docstring)
        self.norm1 = LayerNorm(dim, device=device)
        self.modulation = FocalModulation(dim, focal_level, focal_window, dtype=dtype,
                                          device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp_fc1 = Dense(dim, 4 * dim, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(4 * dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.modulation(self.norm1(x))
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))

    def init_weights(self, g: torch.Generator) -> None:
        for mod in self.children():
            mod.init_weights(g)


class FocalNet(nn.Module):
    """Images ``[B, H, W, 3]`` -> the ``out_indices`` stages, each ``[B, h, w, C]`` f32."""

    def __init__(self, cfg: FocalNetConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dims = [c.embed_dim * 2**i for i in range(len(c.depths))]
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths)).tolist()
        self.patch_embed = Conv(3, dims[0], 4, stride=4, padding="same", dtype=c.dtype,
                                device=device)
        self.patch_norm = LayerNorm(dims[0], device=device)
        blk = 0
        for stage, depth in enumerate(c.depths):
            if stage > 0:
                self.add_module(f"down{stage}", Conv(
                    dims[stage - 1], dims[stage], 2, stride=2, padding="same",
                    dtype=c.dtype, device=device))
                self.add_module(f"down_norm{stage}", LayerNorm(dims[stage], device=device))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", FocalBlock(
                    dims[stage], c.focal_level, c.focal_window, dpr[blk], dtype=c.dtype,
                    device=device))
                blk += 1
            if stage in c.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dims[stage], device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.cfg
        y = self.patch_norm(self.patch_embed(x))
        outs = []
        for stage, depth in enumerate(c.depths):
            if stage > 0:
                y = getattr(self, f"down_norm{stage}")(getattr(self, f"down{stage}")(y))
            for i in range(depth):
                y = getattr(self, f"stage{stage}_block{i}")(y)
            if stage in c.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(y))
        return tuple(outs)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Random weights from ``g`` after the flax initializers (lecun-normal
        kernels, zero biases, unit norms)."""
        for mod in self.children():
            mod.init_weights(g)
