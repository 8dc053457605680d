"""Optimizer: parameter groups, AdamW with a global-norm clip, LR schedules
(counterpart of ``richsem_tpu/train/optim.py``).

The JAX package has two forms of the same AdamW, and so has the port
(:class:`AdamW`'s ``order``); both run on the kernels of ``ops/adamw.py``
on the card (K5, the norm; K6, the update) and on their plain versions on
the CPU. Per step, with ``gnorm`` the global norm of every gradient:

* ``"chain"`` (the default), the optax chain of ``optim.py:178-184``::

      g  = g if gnorm < clip_max_norm else (g / gnorm) * clip_max_norm
                                       clip_by_global_norm
      m  = (1-b1) g + b1 m;  v = (1-b2) g^2 + b2 v       scale_by_adam
      u  = (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps)
      u += weight_decay * p            add_decayed_weights (trainable leaves)
      u *= group scale                 lr_backbone / lr or 1 (where not 1)
      p -= lr(step) * u                scale_by_learning_rate, apply_updates

* ``"fused"``, ``fused_adamw`` (``optim.py:99-149``, ``cfg.fused_adamw``)::

      clip = 1 if gnorm < clip_max_norm else clip_max_norm / gnorm     :126
      g  = g * clip;  m and v as above                                :133-139
      p += ((-s) * lr) * ((m / c1) / (sqrt(v / c2) + eps) + weight_decay * p)
                                                                      :141-144

The two compute the same function with other roundings. Each operation is
rounded on its own in f32 as JAX rounds it (``ops/adamw.py``). The state is
the same in both (``mu``, ``nu`` of the trainable leaves and ``count``), so a
checkpoint of either order restores into the other.

The global norm covers every leaf, frozen ones included: the stem, ``layer1``
and every FrozenBN tensor. FrozenBN tensors are flax *params* in the JAX
package and *buffers* here, so :func:`frozen_leaves` lists them and the train
step has autograd compute their gradients for the norm (and for the
``grad_norm`` metric); no state is kept for them and they never change. With
``clip_max_norm = 0.1`` the clip binds on every step, so this norm sets the
step size of every trainable leaf. The port sums the squares in float64 (JAX
sums them in f32): a float32 norm of a leaf of millions of entries is off by
~1e-5. A leaf without a gradient counts as zero, as in JAX's tree.

Frozen leaves (group scale 0) get no update at all, which is what the chain
gives them: a zero scale multiplies both the Adam term and the decay.

The step's lr and bias corrections change with every step. They are computed
on the host in float32, as the JAX chain computes them, and reach the update
only through a small device tensor (:attr:`AdamW.hyper`), so that a CUDA
graph of the update replays with each step's values.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from richsem_tpu_torch.ops.adamw import adamw_update, global_norm_clip


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
    """AdamW over named parameter groups, in the chain's or ``fused_adamw``'s
    ``order``; see the module docstring.

    A step has three parts: :meth:`prepare` (host: the step's lr and bias
    corrections written into :attr:`hyper`), :meth:`update` (device: the
    norm, the clip and the update, which read ``hyper`` and no Python number
    that changes from step to step, so that a CUDA graph can hold it) and
    :meth:`advance` (host: the count). :meth:`step` runs the three."""

    def __init__(self, model: nn.Module, cfg, steps_per_epoch: int = 1,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, order: str = "chain"):
        self.order = order  # "chain" or "fused" (ops/adamw.py:ORDERS)
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
        # lr, 1 - b1^t and 1 - b2^t of the step in progress, on the parameters' device
        self.hyper = torch.zeros(3, device=named[0][1].device if named else "cpu")

    def scalars(self) -> Tuple[float, float, float]:
        """lr, ``1 - b1^t`` and ``1 - b2^t`` of the next step (``t = count + 1``),
        in float32 as the JAX chain computes them (``optax.scale_by_adam``'s
        bias correction raises the float32 decay to the step)."""
        t, one = np.float32(self.count + 1), np.float32(1.0)
        return (float(np.float32(self.schedule(self.count))),
                float(one - np.float32(self.b1) ** t), float(one - np.float32(self.b2) ** t))

    def prepare(self) -> None:
        """Write the next step's :meth:`scalars` into :attr:`hyper` (three fills,
        no host-to-device copy)."""
        for dst, value in zip(self.hyper.unbind(), self.scalars()):
            dst.fill_(value)

    def advance(self) -> None:
        self.count += 1

    def leaves(self) -> List[torch.Tensor]:
        """Every leaf whose gradient the global norm reads: the trainable
        parameters, then the frozen ones and the FrozenBN buffers."""
        return [t for _, t in self.trainable + self.frozen]

    @torch.no_grad()
    def update(self) -> torch.Tensor:
        """The update from the ``.grad`` of every leaf and :attr:`hyper` (K5,
        then K6 on the card) -> the pre-clip global norm."""
        grads = [t.grad for t in self.leaves()]
        gnorm, clip_state = global_norm_clip(grads, self.clip_max_norm, self.hyper.device)
        n = len(self.trainable)
        adamw_update([p for _, p in self.trainable], grads[:n], self.mu, self.nu, self.hyper,
                     clip_state, [self.scales[name] for name, _ in self.trainable],
                     b1=self.b1, b2=self.b2, eps=self.eps, weight_decay=self.weight_decay,
                     max_norm=self.clip_max_norm, order=self.order)
        return gnorm

    def step(self) -> torch.Tensor:
        """One whole update (:meth:`prepare`, :meth:`update`, :meth:`advance`)
        -> the pre-clip global norm."""
        self.prepare()
        gnorm = self.update()
        self.advance()
        return gnorm

    def zero_grad(self) -> None:
        for t in self.leaves():
            t.grad = None


def build_optimizer(model: nn.Module, cfg, steps_per_epoch: int = 1) -> AdamW:
    """The chain, or ``fused_adamw``'s order when ``cfg.fused_adamw`` is set
    (``optim.py:152-184``)."""
    order = "fused" if getattr(cfg, "fused_adamw", False) else "chain"
    return AdamW(model, cfg, steps_per_epoch, order=order)


def ema_update(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """``e = e * d + (1 - d) * p`` over every parameter (``engine.py:292-297``)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            ema[name].mul_(decay).add_(p, alpha=1.0 - decay)


def ema_init(model: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}
