"""Sinusoidal position embeddings (counterpart of ``richsem_tpu/ops/position_encoding.py``).

Interleaved (sin, cos) pairs, channel-last output ``[B, H, W, 2*num_pos_feats]``
ordered (y-features, x-features), exactly as the JAX package lays them out.
"""

from __future__ import annotations

import math

import torch


def _interleaved_sincos(x: torch.Tensor, temperature: float, num_feats: int) -> torch.Tensor:
    """``[...]`` coords -> ``[..., num_feats]``; pair k uses ``temperature ** (2k / num_feats)``."""
    k = torch.arange(num_feats // 2, dtype=torch.float32, device=x.device)
    div = temperature ** (2.0 * k / num_feats)
    angles = x[..., None] / div
    return torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(
        *x.shape, num_feats
    )


def sine_position_embedding(
    mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature_h: float = 20.0,
    temperature_w: float = 20.0,
    normalize: bool = True,
    scale: float = 2.0 * math.pi,
) -> torch.Tensor:
    """Padding-mask-aware sine embedding; ``mask[B,H,W]`` True on padding."""
    not_mask = (~mask).float()
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    pos_y = _interleaved_sincos(y_embed, temperature_h, num_pos_feats)
    pos_x = _interleaved_sincos(x_embed, temperature_w, num_pos_feats)
    return torch.cat([pos_y, pos_x], dim=-1)


def gen_sineembed_for_position(pos: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """Reference point -> query position embedding (temperature 10000, scale 2pi).

    ``pos [..., 2]`` gives (y, x) embeddings, ``pos [..., 4]`` gives (y, x, w, h).
    """
    scale = 2.0 * math.pi
    x = _interleaved_sincos(pos[..., 0] * scale, 10000.0, num_feats)
    y = _interleaved_sincos(pos[..., 1] * scale, 10000.0, num_feats)
    if pos.shape[-1] == 2:
        return torch.cat([y, x], dim=-1)
    if pos.shape[-1] == 4:
        w = _interleaved_sincos(pos[..., 2] * scale, 10000.0, num_feats)
        h = _interleaved_sincos(pos[..., 3] * scale, 10000.0, num_feats)
        return torch.cat([y, x, w, h], dim=-1)
    raise ValueError(f"pos last dim must be 2 or 4, got {pos.shape[-1]}")
