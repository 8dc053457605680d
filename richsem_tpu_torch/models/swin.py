"""Swin Transformer backbone (counterpart of ``richsem_tpu/models/swin.py``).

4x4 patch embedding, four stages of shifted-window attention with a relative
position bias, patch merging between stages, and a LayerNorm on each output
stage (C3, C4, C5 for the detector). Channel-last throughout: the LayerNorms
and Linears act on the last dimension, the patch convolution takes an NCHW
view. Inputs that are not a multiple of the window are padded after ``norm1``
and masked as in JAX.

Precision follows the flax modules cast for cast: the LayerNorms return f32,
every ``Dense`` and the patch convolution compute in ``dtype``; the attention
scores meet the f32 bias, take an f32 softmax and are cast back to the
values' dtype. So the residual stream of the first stage is f32 and, after a
``merge_reduce`` in ``dtype``, that of the later stages is ``dtype``, as in
JAX.

The relative-position index and the shifted-window masks are constants that
``jit`` folds in JAX. Here they are made once for each window (and padded
extent) and device, outside inference mode, and cached, so that a forward
(or a CUDA graph's capture of it, after the warm-up that fills the cache)
copies nothing from the host.

Stochastic depth is never drawn: the JAX detector calls its backbone with
``deterministic`` left True (``richsem_tpu/models/dino.py:678``), so
``drop_path_rate`` is read and does nothing, here as there.

Variants (``SwinConfig.variant``): T (96, [2,2,6,2], [3,6,12,24]),
B (128, [2,2,18,2], [4,8,16,32]), L (192, [2,2,18,2], [6,12,24,48]), with a
window of 7 (``_224``) or 12 (``_384``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from richsem_tpu_torch.models.layers import Conv, Dense, LayerNorm, normal_


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    out_indices: Tuple[int, ...] = (1, 2, 3)
    dtype: Any = None  # matmul compute dtype (params and norms stay f32)

    @classmethod
    def variant(cls, name: str) -> "SwinConfig":
        table = {
            "swin_T_224_1k": cls(),
            "swin_B_224_22k": cls(embed_dim=128, depths=(2, 2, 18, 2),
                                  num_heads=(4, 8, 16, 32)),
            "swin_B_384_22k": cls(embed_dim=128, depths=(2, 2, 18, 2),
                                  num_heads=(4, 8, 16, 32), window_size=12),
            "swin_L_224_22k": cls(embed_dim=192, depths=(2, 2, 18, 2),
                                  num_heads=(6, 12, 24, 48)),
            "swin_L_384_22k": cls(embed_dim=192, depths=(2, 2, 18, 2),
                                  num_heads=(6, 12, 24, 48), window_size=12),
        }
        if name not in table:
            raise KeyError(f"unknown swin variant {name}; options {sorted(table)}")
        return table[name]

    def num_channels(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2**i for i in self.out_indices)


def _rel_pos_index(ws: int) -> np.ndarray:
    """Relative-position index table for a ws x ws window -> [ws^2, ws^2]."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int32)


def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Additive mask isolating the 9 shifted regions of a padded ``hp x wp``
    map (-100 off-region) -> [nW, ws^2, ws^2] float32."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for ws_ in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, ws_, :] = cnt
            cnt += 1
    wins = img.reshape(1, hp // ws, ws, wp // ws, ws, 1).transpose(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(-1, ws * ws)
    diff = wins[:, :, None] - wins[:, None, :]
    return np.where(diff == 0, 0.0, -100.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rel_pos_index_on(ws: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_rel_pos_index(ws).reshape(-1).astype(np.int64)).to(device)


@functools.lru_cache(maxsize=None)
def _shift_mask_on(hp: int, wp: int, ws: int, shift: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(device)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(wins: torch.Tensor, ws: int, b: int, h: int, w: int) -> torch.Tensor:
    x = wins.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


@functools.lru_cache(maxsize=None)
def _rounded(s: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(s, dtype=dtype))


def scale_in(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` as JAX multiplies an array by a Python float: ``s`` rounded to
    the array's dtype first (PyTorch would keep it in f32 for a bf16 tensor)."""
    return x * _rounded(s, x.dtype)


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative-position bias
    ``rel_pos_bias`` [(2 ws - 1)^2, heads] and an optional additive mask."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads, device=device))
        self.proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [nW, ws^2, C]; mask: [nGroups, ws^2, ws^2] additive or None."""
        n, l, c = x.shape
        heads = self.num_heads
        hd = self.dim // heads
        qkv = self.qkv(x).reshape(n, l, 3, heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))  # [n, H, l, hd]
        attn = scale_in(q @ k.transpose(-2, -1), hd**-0.5)
        idx = _rel_pos_index_on(self.window_size, x.device)
        bias = self.rel_pos_bias[idx].reshape(l, l, heads)
        attn = attn + bias.permute(2, 0, 1)[None]
        if mask is not None:
            g = mask.shape[0]
            attn = attn.reshape(n // g, g, heads, l, l) + mask[None, :, None]
            attn = attn.reshape(n, heads, l, l)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(n, l, c)
        return self.proj(out)

    def init_weights(self, g: torch.Generator) -> None:
        self.qkv.init_weights(g)
        normal_(self.rel_pos_bias, g, 0.02)
        self.proj.init_weights(g)


class SwinBlock(nn.Module):
    """norm1 -> (pad, shift) window attention -> residual; norm2 -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float, drop_path: float, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.drop_path = drop_path  # never drawn (module docstring)
        hidden = int(dim * mlp_ratio)
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, num_heads, window_size, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp_fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.mlp_fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws, sh = self.window_size, self.shift
        pad_b, pad_r = (-h) % ws, (-w) % ws
        y = F.pad(self.norm1(x), (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if sh:
            y = torch.roll(y, (-sh, -sh), dims=(1, 2))
            mask = _shift_mask_on(hp, wp, ws, sh, x.device)
        y = _window_reverse(self.attn(_window_partition(y, ws), mask), ws, b, hp, wp)
        if sh:
            y = torch.roll(y, (sh, sh), dims=(1, 2))
        x = x + y[:, :h, :w]
        z = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="tanh"))
        return x + z

    def init_weights(self, g: torch.Generator) -> None:
        for mod in (self.norm1, self.attn, self.norm2, self.mlp_fc1, self.mlp_fc2):
            mod.init_weights(g)


class SwinTransformer(nn.Module):
    """Images ``[B, H, W, 3]`` -> the ``out_indices`` stages, each ``[B, h, w, C]`` f32."""

    def __init__(self, cfg: SwinConfig, device=None):
        super().__init__()
        c = self.cfg = cfg
        dims = [c.embed_dim * 2**i for i in range(len(c.depths))]
        dpr = np.linspace(0, c.drop_path_rate, sum(c.depths)).tolist()
        self.patch_embed = Conv(3, c.embed_dim, 4, stride=4, padding="same", dtype=c.dtype,
                                device=device)
        self.patch_norm = LayerNorm(c.embed_dim, device=device)
        blk = 0
        for stage, depth in enumerate(c.depths):
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", SwinBlock(
                    dims[stage], c.num_heads[stage], c.window_size,
                    0 if i % 2 == 0 else c.window_size // 2, c.mlp_ratio, dpr[blk],
                    dtype=c.dtype, device=device))
                blk += 1
            if stage in c.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dims[stage], device=device))
            if stage < len(c.depths) - 1:
                self.add_module(f"merge_norm{stage}", LayerNorm(4 * dims[stage], device=device))
                self.add_module(f"merge_reduce{stage}", Dense(
                    4 * dims[stage], 2 * dims[stage], bias=False, dtype=c.dtype,
                    device=device))

    @staticmethod
    def merge(y: torch.Tensor) -> torch.Tensor:
        """Patch merging's 2 x 2 neighbourhood concat (odd sides padded first)."""
        b, h, w, ch = y.shape
        pad_b, pad_r = h % 2, w % 2
        if pad_b or pad_r:
            y = F.pad(y, (0, 0, 0, pad_r, 0, pad_b))
            h, w = h + pad_b, w + pad_r
        y = y.reshape(b, h // 2, 2, w // 2, 2, ch).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(b, h // 2, w // 2, 4 * ch)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.cfg
        y = self.patch_norm(self.patch_embed(x))
        outs = []
        for stage, depth in enumerate(c.depths):
            for i in range(depth):
                y = getattr(self, f"stage{stage}_block{i}")(y)
            if stage in c.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(y))
            if stage < len(c.depths) - 1:
                y = getattr(self, f"merge_norm{stage}")(self.merge(y))
                y = getattr(self, f"merge_reduce{stage}")(y)
        return tuple(outs)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """Random weights from ``g`` after the flax initializers (lecun-normal
        kernels, zero biases, unit norms, N(0, 0.02) position bias)."""
        for mod in self.children():
            mod.init_weights(g)
