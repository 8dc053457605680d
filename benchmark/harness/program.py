"""The system under test: the port's detector, steps and teacher, built from
a benchmark configuration and fed the benchmark's weights.

This is the one module of the harness that imports the measured package,
``richsem_tpu_torch``; it takes from it the entry points that the port's own
trainer and evaluator drive (``train/engine.py:make_eval_step`` and
``make_train_step``, ``train/optim.py:build_optimizer``,
``models/build.py``), and its kernel wrappers' launch counters and
``ops/lap.py:device_rounds``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import torch

from benchmark.harness import weights

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port_config(conf: Dict[str, Any]):
    """The port's ``Config`` of a benchmark configuration: its ``base`` file
    through ``richsem_tpu_torch.config.Config`` with its ``overrides``. Every
    key of the file's ``config`` must read the same there, so a change to the
    base file cannot change the cell unseen."""
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(os.path.join(ROOT, conf["base"]))
    cfg.update(conf.get("overrides", {}))
    for key, want in conf["config"].items():
        if key == "swin":
            continue
        have = cfg[key]
        if isinstance(have, (list, tuple)):
            have = list(have)
        if have != want:
            raise ValueError(f"configuration {conf['name']}: {key} is {have!r} in the run, "
                             f"{want!r} in its file")
    if "swin" in conf["config"]:
        from richsem_tpu_torch.models.swin import SwinConfig

        v = dataclasses.asdict(SwinConfig.variant(cfg.backbone))
        for key, want in conf["config"]["swin"].items():
            have = list(v[key]) if isinstance(v[key], tuple) else v[key]
            if have != want:
                raise ValueError(f"configuration {conf['name']}: swin {key} is {have!r} in "
                                 f"the run, {want!r} in its file")
    return cfg


def teacher_needed(cfg) -> bool:
    return bool(getattr(cfg, "use_visual_distill", False))


@dataclasses.dataclass
class Program:
    cfg: Any
    model: Any
    teacher: Optional[Any]
    text: torch.Tensor


def leaf_specs(model):
    """(name, shape) of every leaf of the detector the benchmark makes: its
    parameters and buffers."""
    return [(k, tuple(v.shape)) for k, v in model.state_dict().items()]


def teacher_specs(teacher):
    """(name, shape) of the teacher's leaves that a step reads: its visual
    tower and its temperature (the text tower does not run)."""
    return [(k, tuple(v.shape)) for k, v in teacher.state_dict().items()
            if k.startswith("visual.") or k == "logit_scale"]


def detector_leaves(specs, seed: int, device):
    return weights.make(specs, weights.seed_of(seed, 0), device)


def teacher_leaves(specs, seed: int, device):
    return weights.make(specs, weights.seed_of(seed, 4), device)


@torch.no_grad()
def load(module, leaves: Dict[str, torch.Tensor]) -> None:
    """Copy the benchmark's leaves into ``module``'s parameters and buffers."""
    for k, v in module.state_dict().items():
        if k in leaves:
            v.copy_(leaves[k])


def build(conf: Dict[str, Any], seed: int, device, with_teacher: bool = False) -> Program:
    """The port's detector (and, ``with_teacher``, the bf16 teacher) on
    ``device`` with the benchmark's weights from ``seed``, and the text bank
    ``[C, D]`` from ``seed``."""
    import richsem_tpu_torch.models.build as build_mod  # registers "richsem"
    from richsem_tpu_torch.models import build_model

    cfg = port_config(conf)
    model, _, _ = build_model("richsem", cfg, device=device)
    load(model, detector_leaves(leaf_specs(model), seed, device))
    teacher = None
    if with_teacher and teacher_needed(cfg):
        teacher = build_mod.build_clip_teacher(cfg, dtype=torch.bfloat16, device=device)
        load(teacher, teacher_leaves(teacher_specs(teacher), seed, device))
    c, d = conf["text_bank"]
    g = torch.Generator(device=device).manual_seed(weights.seed_of(seed, 2))
    text = torch.randn(c, d, generator=g, device=device)
    return Program(cfg, model, teacher, text)


def launch_counters() -> Dict[str, Any]:
    """The port's kernel wrappers, each with its ``.launches``."""
    from richsem_tpu_torch.bench import launch_counters as counters

    return counters()


def kernel_names() -> Dict[str, str]:
    """Each kernel wrapper's counter name -> the ``__global__`` function a
    profile shows once a launch, as the port names them."""
    from richsem_tpu_torch.bench import KERNELS

    return {k: v[2] for k, v in KERNELS.items()}


def guarded_profile(fn):
    """A profile of ``fn`` whose kernel counts match the wrappers' launches
    (``profiling.guarded``); None without a card."""
    import torch

    from benchmark.harness import profiling

    if not torch.cuda.is_available():
        return None
    return profiling.guarded(fn, kernel_names(), launch_counters())
