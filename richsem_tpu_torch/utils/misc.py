"""Small numeric helpers (PyTorch counterpart of ``richsem_tpu/utils/misc.py``).

A padded batch is a plain ``(images [B,H,W,3], pad_mask [B,H,W])`` pair with
``pad_mask`` True on padding, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + eps^2)``: finite value and gradient at x == 0."""
    sq = x.square().sum(dim=-1, keepdim=True)
    return x * torch.rsqrt(sq + eps * eps)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1) - torch.log(x2)


def resize_mask(mask: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of a [B,H,W] bool mask to (h, w).

    Sample index ``floor(i * H / h)`` in float32, as ``richsem_tpu`` computes
    it (and the reference's ``F.interpolate(mode='nearest')``).
    """
    _, h0, w0 = mask.shape
    h, w = hw
    dev = mask.device
    ys = torch.floor(torch.arange(h, dtype=torch.float32, device=dev) * (h0 / h)).long()
    xs = torch.floor(torch.arange(w, dtype=torch.float32, device=dev) * (w0 / w)).long()
    return mask[:, ys][:, :, xs]


def valid_ratios(mask: torch.Tensor) -> torch.Tensor:
    """[B,H,W] padding mask -> [B,2] (w_ratio, h_ratio) of valid content."""
    not_mask = ~mask
    valid_h = not_mask[:, :, 0].sum(dim=1)
    valid_w = not_mask[:, 0, :].sum(dim=1)
    h, w = mask.shape[1], mask.shape[2]
    return torch.stack([valid_w.float() / w, valid_h.float() / h], dim=-1)
