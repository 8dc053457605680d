"""ConvNeXt backbone (counterpart of ``richsem_tpu/models/convnext.py``).

4x4 patch stem, then four stages of blocks (depthwise 7x7 -> LN -> 4x
pointwise -> GELU -> pointwise -> layer scale ``gamma`` -> residual), a LN and
a 2x2 stride-2 convolution between stages (in that order), and a LN on each
output stage. Channel-last throughout; the convolutions take NCHW views.

Precision follows the flax modules: the LNs return f32, the convolutions and
``Dense`` layers compute in ``dtype``, and ``y * gamma`` (f32) brings each
block's branch back to f32 before the residual add.

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
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    drop_path_rate: float = 0.4
    layer_scale_init: float = 1e-6
    out_indices: Tuple[int, ...] = (1, 2, 3)
    dtype: Any = None  # conv/matmul compute dtype (params and norms stay f32)

    @classmethod
    def variant(cls, name: str) -> "ConvNeXtConfig":
        table = {
            "convnext_tiny": cls(),
            "convnext_small": cls(depths=(3, 3, 27, 3)),
            "convnext_base": cls(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
            "convnext_large": cls(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
            "convnext_xlarge_22k": cls(
                depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)
            ),
        }
        if name not in table:
            raise KeyError(f"unknown convnext variant {name}")
        return table[name]

    def num_channels(self) -> Tuple[int, ...]:
        return tuple(self.dims[i] for i in self.out_indices)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float, layer_scale_init: float,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.drop_path = drop_path  # never drawn (module docstring)
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv(dim, dim, 7, padding=3, groups=dim, dtype=dtype, device=device)
        self.norm = LayerNorm(dim, device=device)
        self.pwconv1 = Dense(dim, 4 * dim, dtype=dtype, device=device)
        self.pwconv2 = Dense(4 * dim, dim, dtype=dtype, device=device)
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x))), approximate="tanh"))
        return x + y * self.gamma

    def init_weights(self, g: torch.Generator) -> None:
        for mod in (self.dwconv, self.norm, self.pwconv1, self.pwconv2):
            mod.init_weights(g)
        nn.init.constant_(self.gamma, self.layer_scale_init)


class ConvNeXt(nn.Module):
    """Images ``[B, H, W, 3]`` -> the ``out_indices`` stages, each ``[B, h, w, C]`` f32."""

    def __init__(self, cfg: ConvNeXtConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths)).tolist()
        self.stem = Conv(3, c.dims[0], 4, stride=4, padding="same", dtype=c.dtype,
                         device=device)
        self.stem_norm = LayerNorm(c.dims[0], device=device)
        blk = 0
        for stage, depth in enumerate(c.depths):
            if stage > 0:
                self.add_module(f"down_norm{stage}", LayerNorm(c.dims[stage - 1], device=device))
                self.add_module(f"down{stage}", Conv(
                    c.dims[stage - 1], c.dims[stage], 2, stride=2, padding="same",
                    dtype=c.dtype, device=device))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", ConvNeXtBlock(
                    c.dims[stage], dpr[blk], c.layer_scale_init, dtype=c.dtype,
                    device=device))
                blk += 1
            if stage in c.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(c.dims[stage], device=device))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.cfg
        y = self.stem_norm(self.stem(x))
        outs = []
        for stage, depth in enumerate(c.depths):
            if stage > 0:
                y = getattr(self, f"down{stage}")(getattr(self, f"down_norm{stage}")(y))
            for i in range(depth):
                y = getattr(self, f"stage{stage}_block{i}")(y)
            if stage in c.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(y))
        return tuple(outs)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Random weights from ``g`` after the flax initializers (lecun-normal
        kernels, zero biases, unit norms, ``gamma`` at ``layer_scale_init``)."""
        for mod in self.children():
            mod.init_weights(g)
