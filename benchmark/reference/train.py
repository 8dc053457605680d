"""Plain reference of the RichSem training step, in float32.

A step: the teacher's targets at the GT boxes (``teacher.py``); the CDN
queries from the step's draws (``dn_number`` budget: groups of the positive
and negative copies of every GT, labels flipped and boxes moved by the
draws); the detector's training forward (``detector.py``); the loss
(``criterion.py``); the gradient of every leaf, the frozen ones and the
frozen batch-norm statistics included, whose global norm clips the gradient
to ``clip_max_norm``; then AdamW (decoupled weight decay, bias correction)
on the trainable leaves, each at its learning-rate scale.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from benchmark.reference import criterion, detector, teacher

Tensor = torch.Tensor
B1, B2, EPS = 0.9, 0.999, 1e-8


def lr_scale(name: str, cfg: dict) -> float:
    """A leaf's learning-rate scale: 0 for the frozen batch-norms, the CLIP
    temperature and the backbone's stem and first stage (no pretrained
    backbone), ``lr_backbone / lr`` for the rest of the backbone, else 1."""
    parts = name.split(".")
    if any(p.startswith("bn") or p.endswith("_bn") for p in parts) or parts[-1] == "logit_scale":
        return 0.0
    if parts[0] == "backbone":
        if parts[1].startswith(("stem_", "layer1_")):
            return 0.0
        return cfg["lr_backbone"] / cfg["lr"]
    return 1.0


def cdn(labels: Tensor, boxes: Tensor, valid: Tensor, draws: Dict[str, Tensor], cfg: dict):
    """The CDN queries: -> (labels [B, P], boxes in logit space [B, P, 4],
    attention mask [B, QT, QT] True where a query may attend, and
    ``match_gt``, ``slot_in_use``, ``num_groups``). Slot ``s`` belongs to
    group ``s // 2m`` (``m`` the batch's largest GT count), is a negative copy
    when ``s % 2m >= m``, and copies GT ``s % m``; ``dn_number // m`` groups."""
    n_dn, nq = cfg["dn_number"], cfg["num_queries"]
    b, g = labels.shape
    pad = 2 * n_dn
    dev = labels.device
    counts = valid.sum(1)
    m = counts.max().clamp(min=1)
    groups = (n_dn // m).clamp(1, n_dn)
    slot = torch.arange(pad, device=dev)
    gid, within = slot // (2 * m), slot % (2 * m)
    neg = within >= m
    gt = (within % m).clamp(0, g - 1)
    active = (gid < groups)[None] & ((within % m)[None] < counts[:, None])
    lab = labels[:, gt]
    flip = draws["flip"] < cfg["dn_label_noise_ratio"] * 0.5
    lab = torch.where(flip, draws["new_label"].to(lab.dtype), lab)
    lab = torch.where(active, lab, torch.full_like(lab, -1))
    bx = boxes[:, gt]
    xyxy = detector.cxcywh_to_xyxy(bx)
    half = torch.cat([bx[..., 2:] / 2, bx[..., 2:] / 2], -1)
    part = draws["part"] + neg[None, :, None].float()
    noised = (xyxy + draws["sign"] * part * half * cfg["dn_box_noise_scale"]).clamp(0.0, 1.0)
    nb = torch.cat([(noised[..., :2] + noised[..., 2:]) / 2, noised[..., 2:] - noised[..., :2]], -1)
    unsig = torch.where(active[..., None], detector.inverse_sigmoid(nb), torch.zeros_like(nb))
    qt = pad + nq
    is_dn = torch.arange(qt, device=dev) < pad
    mask = ~(~is_dn[:, None] & is_dn[None, :])
    mask[:pad, :pad] &= gid[:, None] == gid[None, :]
    match_gt = torch.where(active & ~neg[None], (within % m)[None].expand(b, -1),
                           torch.full_like(lab, -1))
    meta = {"match_gt": match_gt, "slot_in_use": (gid < groups)[None].expand(b, pad),
            "num_groups": groups}
    return lab, unsig, mask[None].expand(b, qt, qt), meta


def loss(P: Dict[str, Tensor], T: Dict[str, Tensor], batch: Dict[str, Tensor],
         draws: Dict, text: Tensor, cfg: dict,
         assign: Callable = criterion.hungarian) -> Tuple[Tensor, Dict[str, Tensor]]:
    """The step's weighted loss and its terms."""
    clip_logits, clip_valid = teacher.box_targets(
        T, batch["images"], batch["boxes"], batch["size"], batch["valid"], text,
        cfg["distill_max_boxes"])
    lab, unsig, mask, meta = cdn(batch["labels"], batch["boxes"], batch["valid"], draws["dn"], cfg)
    out = detector.detector(P, cfg, batch["images"], batch["pad_mask"], text,
                            dn={"labels": lab, "boxes_unsig": unsig, "attn_mask": mask},
                            train=True)
    return criterion.loss(out, batch, clip_logits, clip_valid, meta, draws["fed_uniforms"], cfg,
                          assign)


class AdamW:
    """The recipe's optimizer over the reference's leaves ``P`` (all float32)."""

    def __init__(self, P: Dict[str, Tensor], cfg: dict):
        self.cfg = cfg
        self.scales = {n: lr_scale(n, cfg) for n in P}
        self.trainable = [n for n in sorted(P) if self.scales[n] > 0]
        self.m = {n: torch.zeros_like(P[n]) for n in self.trainable}
        self.v = {n: torch.zeros_like(P[n]) for n in self.trainable}
        self.t = 0

    @torch.no_grad()
    def step(self, P: Dict[str, Tensor], grads: Dict[str, Tensor]) -> Tuple[float, Dict[str, Tensor]]:
        """One update from ``grads`` (every leaf's) -> (the global norm, the
        clipped gradients of the trainable leaves)."""
        cfg = self.cfg
        self.t += 1
        gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        clip = torch.clamp(cfg["clip_max_norm"] / gnorm, max=1.0)
        c1, c2 = 1 - B1 ** self.t, 1 - B2 ** self.t
        clipped = {}
        for n in self.trainable:
            g = grads[n] * clip
            clipped[n] = g
            self.m[n].mul_(B1).add_(g * (1 - B1))
            self.v[n].mul_(B2).add_(g * g * (1 - B2))
            u = (self.m[n] / c1) / (torch.sqrt(self.v[n] / c2) + EPS) + P[n] * cfg["weight_decay"]
            P[n].sub_(u * (self.scales[n] * cfg["lr"]))
        return float(gnorm), clipped


def steps(P: Dict[str, Tensor], T: Dict[str, Tensor], batches: List[Dict[str, Tensor]],
          draws: List[Dict], text: Tensor, cfg: dict) -> Dict:
    """The reference's first ``len(batches)`` steps from the leaves ``P``
    (updated in place) -> each step's loss, the first step's clipped gradient
    of every trainable leaf, and the trainable leaves' change over the steps."""
    opt = AdamW(P, cfg)
    start = {n: P[n].detach().clone() for n in opt.trainable}
    losses, first = [], None
    leaves = sorted(P)
    for batch, d in zip(batches, draws):
        with torch.enable_grad():
            for n in leaves:
                P[n].requires_grad_(True)
            total, _ = loss(P, T, batch, d, text, cfg)
            grads = dict(zip(leaves, torch.autograd.grad(total, [P[n] for n in leaves],
                                                         allow_unused=True)))
        for n in leaves:
            P[n].requires_grad_(False)
            if grads[n] is None:
                grads[n] = torch.zeros_like(P[n])
        losses.append(float(total.detach()))
        _, clipped = opt.step(P, grads)
        if first is None:
            first = clipped
        del grads, total
    return {"losses": losses, "grad": first,
            "delta": {n: P[n] - start[n] for n in opt.trainable}}
