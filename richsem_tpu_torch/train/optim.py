"""Optimizer: parameter groups, AdamW with a global-norm clip, LR schedules
(counterpart of ``richsem_tpu/train/optim.py``).

The JAX chain (``optim.py:178-184``) is, per step:

    g  = grads * min(1, clip_max_norm / global_norm(grads))
    u  = adam(g)                    mu/(1-b1^t) / (sqrt(nu/(1-b2^t)) + eps)
    u += weight_decay * p           trainable leaves only
    u *= group scale                lr_backbone / lr, 1.0, or 0 when frozen
    p -= lr(step) * u

The global norm covers every leaf, frozen ones included: the stem, ``layer1``
and every FrozenBN tensor. FrozenBN tensors are flax *params* in the JAX
package and *buffers* here, so :func:`frozen_leaves` lists them and the train
step has autograd compute their gradients for the norm (and for the
``grad_norm`` metric); no state is kept for them and they never change. With
``clip_max_norm = 0.1`` the clip binds on every step, so this norm sets the
step size of every trainable leaf.

Frozen leaves (group scale 0) get no update at all, which is what the chain
gives them: a zero scale multiplies both the Adam term and the decay.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn


def lr_scale(name: str, cfg) -> float:
    """LR multiplier of one parameter by its dotted name (``optim.py:31-58``):
    FrozenBN tensors and ``logit_scale`` 0; the backbone ``lr_backbone / lr``,
    with the stem and ``layer1`` at 0 unless a backbone checkpoint is given;
    ``sampling_offsets`` / ``reference_points`` the projection multiplier under
    ``param_dict_type='ddetr_in_mmdet'``, else 1."""
    parts = name.split(".")
    if any(p.startswith("bn") or p.endswith("_bn") for p in parts):
        return 0.0  # every FrozenBN tensor (bn1-3, stem_bn, downsample_bn)
    if parts[-1] == "logit_scale":
        return 0.0
    if parts[0] == "backbone":
        freeze_early = not getattr(cfg, "resnet_pretrain_path", "")
        if freeze_early and (parts[1].startswith("stem_") or parts[1].startswith("layer1_")):
            return 0.0
        return cfg.lr_backbone / cfg.lr if cfg.lr > 0 else 0.0
    if any(p in ("sampling_offsets", "reference_points") for p in parts):
        if getattr(cfg, "param_dict_type", "default") == "ddetr_in_mmdet":
            return cfg.lr_linear_proj_mult
    return 1.0


def frozen_leaves(model: nn.Module) -> List[Tuple[str, torch.Tensor]]:
    """Buffers that are flax params in the JAX package (the FrozenBN tensors)."""
    return [(n, b) for n, b in model.named_buffers() if b.is_floating_point()]


def make_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """Epoch-granular schedules (``optim.py:61-85``): StepLR at ``lr_drop``,
    MultiStepLR over ``lr_drop_list``, or optax's cosine one-cycle."""
    base = cfg.lr
    if getattr(cfg, "onecyclelr", False):
        total = cfg.epochs * steps_per_epoch
        div, final_div = 25.0, 1e4
        bounds = [(0, base / div), (int(0.2 * total), base),
                  (int(total), base / div / final_div)]

        def onecycle(step: int) -> float:
            for (b0, v0), (b1, v1) in zip(bounds, bounds[1:]):
                if step < b1:
                    pct = (step - b0) / max(b1 - b0, 1)
                    return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * pct) + 1)
            return bounds[-1][1]

        return onecycle
    if getattr(cfg, "multi_step_lr", False):
        drops = list(cfg.lr_drop_list)
        return lambda step: base * 0.1 ** sum(step // steps_per_epoch >= d for d in drops)
    return lambda step: base * (0.1 if step // steps_per_epoch >= cfg.lr_drop else 1.0)


class AdamW:
    """The JAX chain over named parameter groups; see the module docstring."""

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.clip_max_norm = cfg.clip_max_norm
        self.weight_decay = cfg.weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        named = list(model.named_parameters())
        self.scales = {n: lr_scale(n, cfg) for n, _ in named}
        self.trainable = [(n, p) for n, p in named if self.scales[n] > 0]
        self.frozen = [(n, p) for n, p in named if self.scales[n] == 0]
        self.frozen += frozen_leaves(model)
        self.mu = [torch.zeros_like(p) for _, p in self.trainable]
        self.nu = [torch.zeros_like(p) for _, p in self.trainable]

    def grad_leaves(self) -> List[torch.Tensor]:
        """Every leaf's gradient (a missing one is zero, as in JAX's tree)."""
        return [t.grad if t.grad is not None else torch.zeros_like(t)
                for _, t in self.trainable + self.frozen]

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """One update from the ``.grad`` of every leaf -> the pre-clip global norm."""
        grads = self.grad_leaves()
        # squares summed in float64: a float32 norm of a leaf of millions of
        # entries is off by ~1e-5, and the clip binds on every step
        sq = torch.stack([torch.sum(g.float().square(), dtype=torch.float64) for g in grads])
        gnorm = sq.sum().sqrt().float()
        clip = torch.where(gnorm < self.clip_max_norm, gnorm.new_ones(()),
                           self.clip_max_norm / gnorm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        g = torch._foreach_mul(grads[: len(self.trainable)], clip)
        torch._foreach_lerp_(self.mu, g, 1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - self.b2)
        for (name, p), m, v in zip(self.trainable, self.mu, self.nu):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps) + self.weight_decay * p
            p.add_(u * (-self.scales[name] * lr))
        return gnorm

    def zero_grad(self) -> None:
        for _, t in self.trainable + self.frozen:
            t.grad = None


def build_optimizer(model: nn.Module, cfg, steps_per_epoch: int = 1) -> AdamW:
    if getattr(cfg, "fused_adamw", False):
        raise NotImplementedError(
            "fused_adamw is a TPU formulation of the same chain; the port runs the "
            "chain (ROADMAP.md queue 1, item 12)")
    return AdamW(model, cfg, steps_per_epoch)


def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """``e = e * d + (1 - d) * p`` over every parameter (``engine.py:292-297``)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            ema[name].mul_(decay).add_(p, alpha=1.0 - decay)


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}
