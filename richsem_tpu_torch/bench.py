"""Benchmark: the flagship train step's images/s on one card, through the
PyTorch port (counterpart of the root ``bench.py``).

    python -m richsem_tpu_torch.bench                # on the card
    python -m richsem_tpu_torch.bench --device cpu   # only when asked

Prints ONE JSON line in the root bench's schema, ``metric``, ``value``,
``unit`` and ``vs_baseline``, with the fields that say how the number was
steadied and what the card did (:func:`bench_line`).

The measured program is the full flagship train step of
``configs/richsem/richsem_4scale_lvis.py`` in bf16: a frozen bf16 CLIP-RN50
teacher with random weights from a seed (throughput does not depend on weight
values), the CLIP-text classifier over a 1204 x 1024 text bank, visual
distillation, CDN, the auction matcher, every loss and AdamW, through
``train/engine.py:make_train_step``. The batch is the root bench's, drawn with
``numpy.random.default_rng(0)`` in its order (:func:`draw_batch`): bs2 on an
896 x 1344 canvas with a valid extent of 800 x 1224, 300 GT slots of which 16
are valid (LVIS has 11.2 instances an image).

Timing: 3 warm-up steps, then 20 steps, each timed on the host and ended by
``torch.cuda.synchronize()``; ``value`` is the batch over the median step. On
the card the step is a CUDA graph (``train/engine.py:TrainStep``): the first
warm-up step runs eagerly and captures it, and every later step is a replay.
The line says so (``graph``) and carries the warm-up and capture's host ms
(``capture_ms``) and the device memory of the graphs' pool (``pool_gb``); on
the CPU the step runs eagerly, ``graph`` is false and the other two null.
One more step runs under ``torch.profiler`` for the card's busy time, its
operations and its idle share. A profile can lose operations, so its count
of each hand-written kernel must equal the launches its wrapper counted in
that step (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K4, the auction, 7: one a
matching, and K5 and K6, the optimizer's norm and update, 1 each; with
``BENCH_DEC_IMPL=sep_pallas`` 6 of each of the six model kernels); the
profile is taken again up to 3 times, the retakes are reported, and the
bench fails if the counts still differ. The line also
carries the auction's rounds a step, read from K4's device counter after the
timed steps (``ops/lap.py:device_rounds``), and K4's device ms in the
profiled step.

``vs_baseline`` is the multiple of 4.4 images/s: the commonly reported
DINO-4scale R50 training rate on an NVIDIA A100 (about 55 min an epoch on
8 A100s for COCO's 117k images), as the root bench states. It is an A100
figure, not one measured here.

Settings from the environment, as the root bench reads them: ``BENCH_BATCH``
(from 3 images on, ``backbone_remat`` and ``enc_selective_remat`` are on),
``BENCH_REMAT=1`` (``use_checkpoint``), ``BENCH_BB_REMAT=1``
(``backbone_remat``), ``BENCH_SEL_REMAT=1`` (``enc_selective_remat``),
``BENCH_VALID``, ``BENCH_DEC_IMPL`` (``sep``, whose decoder runs K1, or
``sep_pallas``, which runs K3 and K3-bwd), ``BENCH_NO_DN``,
``BENCH_NO_DISTILL``, ``BENCH_MATCHER``, ``BENCH_MONITOR``,
``BENCH_ENC_LAYERS``, ``BENCH_DEC_LAYERS`` and ``BENCH_FUSED_OPT`` (``1``
sets ``cfg.fused_adamw``: AdamW in ``fused_adamw``'s order, on the same
kernels K5 and K6). Those the port does not implement raise
``NotImplementedError`` naming their ROADMAP item: ``BENCH_IMPL`` other than
the config's, ``BENCH_TILE`` and ``BENCH_MARGIN`` (the TPU's windowed
kernels, item 12).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from richsem_tpu_torch.ops.lap import device_rounds
from richsem_tpu_torch.train.engine import train_graph_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "richsem", "richsem_4scale_lvis.py")
A100_IMAGES_PER_SEC = 4.4
CANVAS = (896, 1344)
MAX_GT = 300  # configs/richsem/base_data_aug.py max_gt_per_image
NUM_LABELS = 1203  # the root bench draws GT labels from [0, 1203)
WARMUP, STEPS = 3, 20
RETAKES = 3  # profiles taken again, at most, when the launch guard trips
SHORT_DTYPE = {"bfloat16": "bf16", "float32": "f32"}

# The hand-written kernels of the model: counter name -> (module of
# richsem_tpu_torch.ops, wrapper counting its launches, the __global__ function
# a profile shows once a launch).
KERNELS = {
    "K1": ("ms_deform_attn", "ms_deform_attn", "msda_fwd_kernel"),
    "K1-bwd": ("ms_deform_attn", "ms_deform_attn_backward", "msda_bwd_kernel"),
    "K2": ("fused_ffn", "encoder_tail", "encoder_tail_fwd_kernel"),
    "K2-bwd": ("fused_ffn", "encoder_tail_backward", "row_pass_kernel"),
    "K3": ("ms_deform_attn_sep", "ms_deform_attn_sep", "msda_sep_fwd_kernel"),
    "K3-bwd": ("ms_deform_attn_sep", "ms_deform_attn_sep_backward", "msda_sep_bwd_kernel"),
    "K4": ("lap", "batched_min_cost_assignment", "auction_kernel"),
    "K5": ("adamw", "global_norm_clip", "sumsq_kernel"),
    "K6": ("adamw", "adamw_update", "adamw_kernel"),
    "K7": ("nms", "nms_mask", "nms_kernel"),
}


class LaunchGuardError(RuntimeError):
    """A profile's kernel counts differ from the wrappers' launches."""


def launch_counters() -> Dict[str, Callable]:
    """The hand-written kernels' wrappers, by counter name; each has ``.launches``."""
    import importlib

    return {name: getattr(importlib.import_module(f"richsem_tpu_torch.ops.{mod}"), fn)
            for name, (mod, fn, _) in KERNELS.items()}


def check_device(device: str) -> torch.device:
    """The device a bench runs on: the card unless the caller asks for the CPU;
    raises when asked for the card and none is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the bench runs on 'cuda' unless asked otherwise, and no CUDA "
                           "device is available; pass --device cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the bench runs on cuda or cpu, not {dev}")
    return dev


def card(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card; None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[(device.index or 0)]


def text_dim(cfg) -> int:
    """The width of the text bank: the detector's CLIP embedding (1024 for RN50)."""
    from richsem_tpu_torch.models.dino import DINOConfig

    return DINOConfig.from_config(cfg).clip_embed_dim


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported to richsem_tpu_torch yet "
                              f"(ROADMAP.md queue 1, {item})")


def bench_config(env: Optional[Mapping[str, str]] = None, overrides: Optional[dict] = None):
    """-> (cfg, batch size, valid GT count): the flagship config in bf16 with the
    ``BENCH_*`` settings of ``env`` (the process environment by default) applied
    as the root bench applies them, then ``overrides`` (the tests' tiny widths)."""
    from richsem_tpu_torch.config import Config

    env = os.environ if env is None else env
    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    batch = int(env.get("BENCH_BATCH", "2"))
    if env.get("BENCH_IMPL") and env["BENCH_IMPL"] != cfg.msda_impl:
        _refuse(f"BENCH_IMPL={env['BENCH_IMPL']} (the port's encoder runs K1 for every "
                "windowed implementation)", "item 12")
    for var, what in (("BENCH_TILE", "the windowed kernels' tile"),
                      ("BENCH_MARGIN", "the windowed kernels' margin")):
        if env.get(var):
            _refuse(f"{var} ({what})", "item 12")
    # the memory knobs as the root bench sets them (bench.py:75-81): larger
    # batches turn the backbone's and the encoder's remat on
    cfg.use_checkpoint = env.get("BENCH_REMAT", "") == "1"
    cfg.backbone_remat = batch >= 3 or env.get("BENCH_BB_REMAT") == "1"
    cfg.enc_selective_remat = batch >= 3 or env.get("BENCH_SEL_REMAT") == "1"
    if env.get("BENCH_MONITOR"):
        cfg.monitor_msda_offsets = env["BENCH_MONITOR"] == "1"
    if env.get("BENCH_NO_DN") == "1":
        cfg.use_dn = False
    if env.get("BENCH_NO_DISTILL") == "1":
        cfg.use_visual_distill = False
        cfg.use_clip_visual_query = False
    if env.get("BENCH_MATCHER"):
        cfg.matcher_type = env["BENCH_MATCHER"]
    if env.get("BENCH_FUSED_OPT"):
        cfg.fused_adamw = env["BENCH_FUSED_OPT"] == "1"
    if env.get("BENCH_DEC_IMPL"):
        if env["BENCH_DEC_IMPL"] not in ("sep", "sep_pallas"):
            _refuse(f"BENCH_DEC_IMPL={env['BENCH_DEC_IMPL']} (the decoder runs K1 for "
                    "'sep' and K3 for 'sep_pallas')", "item 12")
        cfg.dec_msda_impl = env["BENCH_DEC_IMPL"]
    if env.get("BENCH_ENC_LAYERS"):
        cfg.enc_layers = int(env["BENCH_ENC_LAYERS"])
    if env.get("BENCH_DEC_LAYERS"):
        cfg.dec_layers = int(env["BENCH_DEC_LAYERS"])
    cfg.update(overrides or {})
    return cfg, batch, int(env.get("BENCH_VALID", "16"))


def draw_batch(batch_size: int, n_valid: int, num_classes: int, text_dim: int,
               canvas: Tuple[int, int] = CANVAS,
               max_gt: int = MAX_GT) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The root bench's batch and text bank (``bench.py:90-126``), drawn from
    ``numpy.random.default_rng(0)`` in its order: images, labels, boxes, then
    the text bank. -> (numpy batch in the root bench's dtypes, text [C, D] f32)."""
    h, w = canvas
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    pad_mask = np.ones((batch_size, h, w), bool)
    pad_mask[:, : h - 96, : w - 120] = False
    batch = {
        "images": images,
        "pad_mask": pad_mask,
        "labels": rng.integers(0, NUM_LABELS, (batch_size, max_gt)).astype(np.int32),
        "boxes": np.clip(rng.uniform(0.1, 0.7, (batch_size, max_gt, 4)), 0.02,
                         0.9).astype(np.float32),
        "valid": (np.arange(max_gt)[None] < n_valid).repeat(batch_size, 0),
        "size": np.asarray([[h - 96, w - 120]] * batch_size, np.int32),
        "is_extra": np.zeros((batch_size,), bool),
    }
    text = rng.normal(size=(num_classes, text_dim)).astype(np.float32)
    return batch, text


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The numpy batch on ``device``, labels as int64 (the port's index dtype)."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if "labels" in out:
        out["labels"] = out["labels"].long()
    return out


def build_train(cfg, device, teacher=None):
    """-> (state, train_step, teacher): the detector from seed 0, AdamW, and the
    frozen bf16 RN50 teacher from seed 2 when distillation is on (or
    ``teacher``, the tests' tiny one), as the root bench seeds them."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    model, _, _ = build_model("richsem", cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(0))
    if teacher is None and cfg.use_visual_distill:
        teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=device,
                                     generator=torch.Generator(device=device).manual_seed(2))
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=device, clip_model=teacher)
    return state, step, teacher


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn: Callable[[], Any], device: torch.device, warmup: int, n: int,
               before_timed: Optional[Callable[[], Any]] = None
               ) -> Tuple[List[float], Dict[str, int]]:
    """``warmup`` calls, then ``n`` calls each timed on the host and ended by a
    synchronise (``before_timed``, if given, is called between the two).
    -> (ms of each timed call, launches of each kernel over them)."""
    for _ in range(warmup):
        fn()
    if before_timed is not None:
        before_timed()
    _sync(device)
    counters = launch_counters()
    before = {k: c.launches for k, c in counters.items()}
    times = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t) * 1e3)
    return times, {k: c.launches - before[k] for k, c in counters.items()}


def guarded_profile(fn: Callable[[], Any], retakes: int = RETAKES, log=print):
    """Profile one call of ``fn`` (``utils/profiling.py:profile_call``) and hold
    the profile's count of each hand-written model kernel to the launches its
    wrapper counted in that call. When they differ the profile lost
    operations: take it again, at most ``retakes`` times. -> (profile, retakes
    taken); raises :class:`LaunchGuardError` if the counts still differ."""
    from richsem_tpu_torch.utils.profiling import profile_call

    counters = launch_counters()
    for attempt in range(retakes + 1):
        before = {k: c.launches for k, c in counters.items()}
        prof = profile_call(fn)
        launched = {k: c.launches - before[k] for k, c in counters.items()}
        seen = prof.kernels() if prof is not None else {}
        counted = {k: seen.get(KERNELS[k][2], (0, 0.0))[0] for k in KERNELS}
        if prof is not None and counted == launched:
            return prof, attempt
        log(f"  profile: kernel counts {counted} differ from the launches {launched} "
            f"(attempt {attempt + 1} of {retakes + 1})")
    raise LaunchGuardError(f"the profile's kernel counts {counted} still differ from the "
                           f"launches {launched} after {retakes} retakes")


def steadied(times: List[float], launches: Dict[str, int], n_calls: int, warmup: int,
             device: torch.device, prof=None, retakes: Optional[int] = None,
             unit: str = "step") -> Dict[str, Any]:
    """The fields every bench line carries: the median, min and max ms a
    ``unit``, the warm-up and timed counts, the launches of each kernel a call,
    and what the card did in the profiled call (null on the CPU: not measured),
    its peak memory and its name and power limit."""
    on_card = device.type == "cuda"
    per = {k: (n // n_calls if n % n_calls == 0 else n / n_calls) for k, n in launches.items()}
    return {
        f"ms_per_{unit}_median": statistics.median(times),
        f"ms_per_{unit}_min": min(times),
        f"ms_per_{unit}_max": max(times),
        "warmup": warmup,
        "timed": len(times),
        f"launches_per_{unit}": per,
        "device_busy_ms": prof.busy_ms if on_card else None,
        "device_ops": prof.n_ops if on_card else None,
        "idle_share": prof.idle_share if on_card else None,
        "profile_retakes": retakes if on_card else None,
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
        "card": card(device),
        "device": str(device),
    }


def bench_line(device="cuda", env=None, overrides=None, canvas=CANVAS, teacher=None,
               warmup: int = WARMUP, steps: int = STEPS) -> Dict[str, Any]:
    """Build the flagship step, draw the batch, take ``warmup`` and ``steps``
    timed steps and one guarded profiled step (on the card). -> the JSON line."""
    dev = check_device(device)
    cfg, batch_size, n_valid = bench_config(env, overrides)
    batch_np, text_np = draw_batch(batch_size, n_valid, cfg.num_classes, text_dim(cfg),
                                   canvas)
    state, step, teacher = build_train(cfg, dev, teacher)
    batch, text = to_device(batch_np, dev), torch.from_numpy(text_np).to(dev)
    del batch_np
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    rounds = device_rounds(dev) if on_card else None
    times, launches = time_calls(lambda: step(state, batch, text), dev, warmup, steps,
                                 before_timed=rounds.zero_ if on_card else None)
    rounds = int(rounds) / steps if on_card else None  # time_calls synchronised
    prof, retakes = guarded_profile(lambda: step(state, batch, text)) if on_card else (None, None)
    ips = batch_size * 1e3 / statistics.median(times)
    h, w = canvas
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    line = {
        "metric": f"train images/sec/chip (RichSem-R50 4-scale LVIS flagship on the PyTorch "
                  f"port: CLIP teacher + distill, bs{batch_size}, {h}x{w}, "
                  f"{SHORT_DTYPE[cfg.compute_dtype]}"
                  f"{', fused AdamW' if getattr(cfg, 'fused_adamw', False) else ''}; {where})",
        "value": ips,
        "unit": "images/sec/chip" if dev.type == "cuda" else "images/sec",
        "vs_baseline": ips / A100_IMAGES_PER_SEC,
    }
    line.update(steadied(times, launches, steps, warmup, dev, prof, retakes))
    graph = getattr(step, "graphs", {}).get(train_graph_key(batch, text, state.ema is not None))
    line.update(graph=graph is not None, capture_ms=graph.capture_ms if graph else None,
                pool_gb=step.pool_bytes / 1e9 if graph else None)
    line["auction_rounds_per_step"] = rounds
    line["auction_device_ms"] = (prof.kernels().get(KERNELS["K4"][2], (0, 0.0))[1]
                                 if on_card else None)
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    print(json.dumps(bench_line(ap.parse_args(argv).device)), flush=True)


if __name__ == "__main__":
    main()
