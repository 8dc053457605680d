"""Deformable-transformer data flow (counterpart of ``richsem_tpu/models/transformer_utils.py``).

Invalid two-stage proposals carry the finite sentinel ``1e6`` plus an explicit
validity mask, as in the JAX package, so top-k and sigmoids stay NaN-free.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_INVALID_LOGIT = 1e6


def flatten_levels(
    srcs: Sequence[torch.Tensor],  # [B, H, W, C] per level
    masks: Sequence[torch.Tensor],  # [B, H, W] True=pad
    pos_embeds: Sequence[torch.Tensor],  # [B, H, W, C]
    level_embed: torch.Tensor,  # [L, C]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Tuple[Tuple[int, int], ...]]:
    """-> (src_flat [B,S,C], mask_flat [B,S], pos_flat [B,S,C], shapes)."""
    src_flat, mask_flat, pos_flat, shapes = [], [], [], []
    for lvl, (src, mask, pos) in enumerate(zip(srcs, masks, pos_embeds)):
        b, h, w, c = src.shape
        shapes.append((h, w))
        src_flat.append(src.reshape(b, h * w, c))
        mask_flat.append(mask.reshape(b, h * w))
        pos_flat.append(pos.reshape(b, h * w, c) + level_embed[lvl][None, None, :])
    return (
        torch.cat(src_flat, dim=1),
        torch.cat(mask_flat, dim=1),
        torch.cat(pos_flat, dim=1),
        tuple(shapes),
    )


def encoder_reference_points(
    spatial_shapes: Sequence[Tuple[int, int]],
    valid_ratios: torch.Tensor,  # [B, L, 2] (w_ratio, h_ratio)
) -> torch.Tensor:
    """-> [B, S, L, 2] normalized (x, y) refs, scaled by each level's valid ratio."""
    dev = valid_ratios.device
    refs: List[torch.Tensor] = []
    for lvl, (h, w) in enumerate(spatial_shapes):
        ry = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None]
        rx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :]
        ry = ry.expand(h, w).reshape(-1)
        rx = rx.expand(h, w).reshape(-1)
        ry = ry[None, :] / (valid_ratios[:, None, lvl, 1] * h)
        rx = rx[None, :] / (valid_ratios[:, None, lvl, 0] * w)
        refs.append(torch.stack([rx, ry], dim=-1))  # [B, hw, 2]
    ref = torch.cat(refs, dim=1)  # [B, S, 2]
    return ref[:, :, None, :] * valid_ratios[:, None, :, :]


def gen_encoder_output_proposals(
    memory: torch.Tensor,  # [B, S, C]
    mask_flat: torch.Tensor,  # [B, S] True=pad
    spatial_shapes: Sequence[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (output_memory [B,S,C], output_proposals [B,S,4] unsigmoid, valid [B,S]).

    Anchors per level with wh = 0.05 * 2^lvl, normalized by the valid extent;
    proposals outside (0.01, 0.99) or on padding are invalid.
    """
    b = memory.shape[0]
    dev = memory.device
    proposals = []
    cur = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        level_mask = mask_flat[:, cur : cur + h * w].reshape(b, h, w)
        valid_h = (~level_mask[:, :, 0]).sum(dim=1).float()
        valid_w = (~level_mask[:, 0, :]).sum(dim=1).float()
        gy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
        gx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
        grid = torch.stack([gx, gy], -1)[None]  # [1, h, w, 2]
        scale = torch.stack([valid_w, valid_h], -1).reshape(b, 1, 1, 2)
        grid = (grid + 0.5) / scale
        wh = torch.full_like(grid, 0.05 * (2.0**lvl))
        proposals.append(torch.cat([grid, wh], -1).reshape(b, h * w, 4))
        cur += h * w
    props = torch.cat(proposals, dim=1)
    in_range = ((props > 0.01) & (props < 0.99)).all(-1)
    valid = in_range & ~mask_flat
    props_unsig = torch.log(props / (1.0 - props).clamp(min=1e-9))
    props_unsig = torch.where(
        valid[..., None], props_unsig, _INVALID_LOGIT
    )
    out_memory = torch.where(valid[..., None], memory, memory.new_zeros(()))
    return out_memory, props_unsig, valid
