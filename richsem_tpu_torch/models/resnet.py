"""ResNet backbone with frozen batch-norm (counterpart of ``richsem_tpu/models/resnet.py``).

torchvision-v1.5 geometry (stride on the 3x3), frozen BN, C3/C4/C5 outputs.
The module boundary is channel-last like the JAX package (images
``[B, H, W, 3]`` in, ``[B, H/s, W/s, C]`` out); inside, the convs run on NCHW
views of channel-last memory, which is the layout cuDNN's fast bf16 kernels
take.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from richsem_tpu_torch.models.layers import Conv


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine (buffers, never trained).

    The folded scale and shift are computed in f32, then applied in the input's
    dtype, so a bf16 backbone stays bf16 through the norm. Operates on NCHW.
    """

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * w
        return x * w.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]

    def init_weights(self, g: torch.Generator) -> None:
        for name, value in (("weight", 1.0), ("bias", 0.0),
                            ("running_mean", 0.0), ("running_var", 1.0)):
            getattr(self, name).fill_(value)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1, expansion 4; NCHW in and out."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        out_ch = planes * 4
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv(in_ch, planes, 1, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv(planes, out_ch, 1, **kw)
        self.bn3 = FrozenBatchNorm(out_ch, device=device)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride=stride, **kw)
            self.downsample_bn = FrozenBatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1.forward_nchw(x)))
        y = torch.relu(self.bn2(self.conv2.forward_nchw(y)))
        y = self.bn3(self.conv3.forward_nchw(y))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(self.downsample_conv.forward_nchw(x))
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """Returns the features at ``return_strides`` (default C3, C4, C5), NHWC."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3),
                 return_strides: Sequence[int] = (8, 16, 32),
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.return_strides = tuple(return_strides)
        self.stem_conv = Conv(3, 64, 7, stride=2, padding=3, bias=False, dtype=dtype,
                              device=device)
        self.stem_bn = FrozenBatchNorm(64, device=device)
        self.stages = []
        in_ch = 64
        for stage, (n_blocks, planes, stride) in enumerate(
            zip(block_counts, (64, 128, 256, 512), (1, 2, 2, 2))
        ):
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_block{b}"
                self.add_module(name, Bottleneck(
                    in_ch, planes, stride=stride if b == 0 else 1, downsample=(b == 0),
                    dtype=dtype, device=device,
                ))
                in_ch = planes * 4
                names.append(name)
            self.stages.append((names, stride))

    @staticmethod
    def out_channels(return_strides: Sequence[int]) -> Tuple[int, ...]:
        return tuple({4: 256, 8: 512, 16: 1024, 32: 2048}[s] for s in return_strides)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        y = torch.relu(self.stem_bn(self.stem_conv.forward_nchw(x.permute(0, 3, 1, 2))))
        # flax max_pool pads with -inf, as F.max_pool2d does
        y = F.max_pool2d(y, 3, stride=2, padding=1)
        feats = {}
        out_stride = 4
        for names, stride in self.stages:
            for name in names:
                y = getattr(self, name)(y)
            out_stride *= stride
            feats[out_stride] = y
        return tuple(feats[s].permute(0, 2, 3, 1) for s in self.return_strides)

    def init_weights(self, g: torch.Generator) -> None:
        for mod in self.modules():
            if isinstance(mod, (Conv, FrozenBatchNorm)):
                mod.init_weights(g)
