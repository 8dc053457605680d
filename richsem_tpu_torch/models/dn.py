"""Contrastive denoising (CDN) queries, budget branch (counterpart of
``richsem_tpu/models/dn.py:prepare_cdn``).

The pad is the static ``2 * dn_number`` slots; slot ``s`` belongs to group
``s // (2m)`` (``m`` the batch's largest GT count), is negative when
``s % (2m) >= m`` and maps to GT ``s % m``; slots past ``2*m*groups`` are
inactive (label -1, masked out of attention and loss). Label noise flips a
label to a uniform class with probability ``label_noise_ratio / 2``; box noise
moves each xyxy corner by ``+-U * (w/2, h/2) * box_noise_scale``, with ``U`` in
[0, 1) for positives and [1, 2) for negatives, then clamps to [0, 1].

The four random draws of the JAX version (``dn.py:88-101``) are tensors here:
:func:`cdn_draws` takes them from a ``torch.Generator``, and a test hands both
sides the same numbers.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from richsem_tpu_torch.utils.misc import inverse_sigmoid


def cdn_draws(batch: int, dn_number: int, num_classes: int,
              generator: torch.Generator, device="cuda") -> Dict[str, torch.Tensor]:
    """The four draws for a pad of ``2 * dn_number`` slots: ``flip`` uniform
    [B, P], ``new_label`` int [B, P] in [0, num_classes), ``sign`` +-1 [B, P, 4]
    and ``part`` uniform [B, P, 4]."""
    pad = 2 * dn_number
    kw = dict(generator=generator, device=device)
    return {
        "flip": torch.rand((batch, pad), **kw),
        "new_label": torch.randint(0, num_classes, (batch, pad), **kw),
        "sign": torch.randint(0, 2, (batch, pad, 4), **kw).float() * 2 - 1,
        "part": torch.rand((batch, pad, 4), **kw),
    }


def prepare_cdn(
    gt_labels: torch.Tensor,  # [B, G] int
    gt_boxes: torch.Tensor,  # [B, G, 4] normalized cxcywh
    gt_valid: torch.Tensor,  # [B, G] bool
    draws: Dict[str, torch.Tensor],
    dn_number: int = 100,
    label_noise_ratio: float = 0.5,
    box_noise_scale: float = 1.0,
    num_queries: int = 900,
    check_pos_dn: bool = False,
    group_mode: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """-> (dn_labels [B,P], dn_boxes_unsig [B,P,4], attn_mask [B,QT,QT] True =
    may attend, dn_meta) with P = 2 * dn_number and QT = P + num_queries.

    ``dn_meta``: ``match_gt`` [B,P] (GT index of active positive slots, else
    -1), ``slot_active``, ``slot_in_use`` and ``num_groups`` (a 0-d tensor)."""
    if group_mode:
        raise NotImplementedError(
            "the CDN group-count branch (dn_number < 50) is not ported yet "
            "(ROADMAP.md queue 1, item 11)")
    if check_pos_dn:
        raise NotImplementedError(
            "check_pos_dn is not ported yet (ROADMAP.md queue 1, item 11)")
    b, g_slots = gt_labels.shape
    pad = 2 * dn_number
    dev = gt_labels.device

    counts = gt_valid.sum(dim=1)  # [B]
    m = counts.max().clamp(min=1)
    groups = (dn_number // m).clamp(1, dn_number)

    slot = torch.arange(pad, device=dev)
    group_id = slot // (2 * m)
    within = slot % (2 * m)
    is_neg = within >= m
    gt_idx = within % m
    active = (group_id < groups)[None, :] & (gt_idx[None, :] < counts[:, None])

    safe_idx = gt_idx.clamp(0, g_slots - 1)
    labels = gt_labels[:, safe_idx]
    boxes = gt_boxes[:, safe_idx].float()

    flip = draws["flip"] < label_noise_ratio * 0.5
    noised_labels = torch.where(flip, draws["new_label"].to(labels.dtype), labels)
    dn_labels = torch.where(active, noised_labels, noised_labels.new_full((), -1))

    cxcy, wh = boxes[..., :2], boxes[..., 2:]
    xyxy = torch.cat([cxcy - wh / 2, cxcy + wh / 2], dim=-1)
    half = torch.cat([wh / 2, wh / 2], dim=-1)
    part = draws["part"] + is_neg[None, :, None].float()
    noised = (xyxy + draws["sign"] * part * half * box_noise_scale).clamp(0.0, 1.0)
    dn_boxes = torch.cat([(noised[..., :2] + noised[..., 2:]) / 2,
                          noised[..., 2:] - noised[..., :2]], dim=-1)
    dn_boxes_unsig = torch.where(active[..., None], inverse_sigmoid(dn_boxes),
                                 dn_boxes.new_zeros(()))

    qt = pad + num_queries
    is_dn = torch.arange(qt, device=dev) < pad
    mask = ~(~is_dn[:, None] & is_dn[None, :])  # matching queries never see DN
    same_group = group_id[:, None] == group_id[None, :]
    mask[:pad, :pad] &= same_group  # DN groups never see each other
    attn_mask = mask[None].expand(b, qt, qt)

    match_gt = torch.where(active & ~is_neg[None, :], gt_idx[None, :],
                           gt_idx.new_full((), -1))
    dn_meta = {
        "match_gt": match_gt,
        "slot_active": active,
        "slot_in_use": (group_id < groups)[None, :].expand(b, pad),
        "num_groups": groups,
    }
    return dn_labels, dn_boxes_unsig, attn_mask, dn_meta
