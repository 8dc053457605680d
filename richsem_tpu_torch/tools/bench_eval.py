"""Eval-path throughput on one card, through the PyTorch port (counterpart of
``tools/bench_eval.py``).

    python -m richsem_tpu_torch.tools.bench_eval            # one point, on the card
    python -m richsem_tpu_torch.tools.bench_eval --sweep    # the operating curve
    python -m richsem_tpu_torch.tools.bench_eval --device cpu

Times the flagship inference step (``configs/richsem/richsem_4scale_lvis.py``
in bf16, random weights from a seed, the CLIP-text classifier over a
1204 x 1024 text bank) plus ``PostProcess`` top-``num_select``, through
``train/engine.py:make_eval_step``, at the production eval bucket 896 x 1344
and bs2 (``BENCH_EVAL_BATCH``). The batch is the JAX tool's: images drawn
from ``numpy.random.default_rng(0)``, the valid extent 800 x 1224,
``orig_size`` [640, 480]; the text bank from another ``default_rng(0)``.

Timing as ``richsem_tpu_torch/bench.py`` steadies it: 5 warm-up batches, then
30 batches each timed on the host and ended by ``torch.cuda.synchronize()``;
``value`` is the batch over the median. On the card the step is a CUDA graph
per batch shape (``train/engine.py:EvalStep``): the first warm-up batch of a
point captures it, and the timed batches are replays; the line says so
(``graph``) and carries the warm-up and capture's host ms (``capture_ms``)
and the device memory of the graphs' shared pool (``pool_gb``; across the
points of a sweep, which share one step and one pool, the pool so far); on
the CPU the step runs eagerly, ``graph`` is false and the other two null.
One more batch runs under ``torch.profiler``, guarded by the wrappers'
launch counts (K1 12 and K2 6 a batch), for the card's busy time and idle
share.

Prints ONE JSON line; ``--sweep`` prints one line per point instead: bs 1,
2, 4 and 8 at 896 x 1344 and bs2 at 1344 x 896, each with a graph of its own.
A point that runs out of device memory is printed with its ``error``, and
the sweep goes on.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from richsem_tpu_torch.bench import (CANVAS, CONFIG, SHORT_DTYPE, check_device, guarded_profile,
                                     steadied, text_dim, time_calls, to_device)
from richsem_tpu_torch.train.engine import graph_key

WARMUP, BATCHES = 5, 30
SWEEP = ((1, CANVAS), (2, CANVAS), (4, CANVAS), (8, CANVAS), (2, (1344, 896)))


def eval_config(overrides: Optional[dict] = None):
    """The flagship config in bf16, then ``overrides`` (the tests' tiny widths)."""
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    cfg.update(overrides or {})
    return cfg


def draw_text(num_classes: int, text_dim: int) -> np.ndarray:
    """The JAX tool's text bank (``tools/bench_eval.py:73-76``)."""
    return np.random.default_rng(0).normal(size=(num_classes, text_dim)).astype(np.float32)


def draw_batch(batch_size: int, canvas: Tuple[int, int] = CANVAS) -> Dict[str, np.ndarray]:
    """The JAX tool's batch at one point (``tools/bench_eval.py:35-46``), from a
    fresh ``default_rng(0)``, in its dtypes."""
    h, w = canvas
    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)
    pad_mask = np.ones((batch_size, h, w), bool)
    pad_mask[:, : h - 96, : w - 120] = False
    return {"images": images, "pad_mask": pad_mask,
            "orig_size": np.asarray([[640, 480]] * batch_size, np.int32)}


def build_eval(cfg, device, teacher=None):
    """-> (model, eval_step): the detector from seed 0 and its inference step;
    under ``use_clip_visual_query`` with the teacher (``teacher``, or the
    random bf16 RN50 one from seed 2, as ``bench.py:build_train`` seeds it)."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.train.engine import make_eval_step

    model, _, _ = build_model("richsem", cfg, device=device,
                              generator=torch.Generator(device=device).manual_seed(0))
    if teacher is None and getattr(cfg, "use_clip_visual_query", False):
        teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=device,
                                     generator=torch.Generator(device=device).manual_seed(2))
    return model, make_eval_step(model, cfg, teacher)


def bench_point(batch_size: int, canvas, eval_step, text: torch.Tensor, device: torch.device,
                warmup: int = WARMUP, n: int = BATCHES) -> Dict[str, Any]:
    """One point: the batch drawn and moved to the card, ``warmup`` and ``n``
    timed batches, one guarded profiled batch (on the card). -> its fields."""
    batch = to_device(draw_batch(batch_size, canvas), device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    times, launches = time_calls(lambda: eval_step(batch, text), device, warmup, n)
    prof, retakes = (guarded_profile(lambda: eval_step(batch, text)) if device.type == "cuda"
                     else (None, None))
    med = statistics.median(times)
    point = {"batch": batch_size, "canvas": list(canvas),
             "images_per_sec": batch_size * 1e3 / med, "ms_per_image": med / batch_size,
             "ms_per_batch": med}
    point.update(steadied(times, launches, n, warmup, device, prof, retakes, unit="batch"))
    graph = getattr(eval_step, "graphs", {}).get(graph_key(batch, text))
    point.update(graph=graph is not None,
                 capture_ms=graph.capture_ms if graph else None,
                 pool_gb=eval_step.pool_bytes / 1e9 if graph else None)
    return point


def bench_line(device="cuda", overrides=None, canvas=CANVAS, warmup: int = WARMUP,
               n: int = BATCHES) -> Dict[str, Any]:
    """The single point at ``BENCH_EVAL_BATCH`` (2) images. -> the JSON line."""
    dev = check_device(device)
    cfg = eval_config(overrides)
    batch_size = int(os.environ.get("BENCH_EVAL_BATCH", "2"))
    _, step = build_eval(cfg, dev)
    text = torch.from_numpy(draw_text(cfg.num_classes, text_dim(cfg))).to(dev)
    point = bench_point(batch_size, canvas, step, text, dev, warmup, n)
    h, w = canvas
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    line = {
        "metric": f"eval images/sec/chip (RichSem-R50 4-scale flagship fwd + postprocess "
                  f"top-{cfg.num_select} on the PyTorch port, bs{batch_size}, {h}x{w} eval "
                  f"bucket, {SHORT_DTYPE[cfg.compute_dtype]}; {where})",
        "value": point.pop("images_per_sec"),
        "unit": "images/sec/chip" if dev.type == "cuda" else "images/sec",
    }
    line.update(point)
    return line


def sweep(device="cuda", overrides=None, points=SWEEP, warmup: int = WARMUP,
          n: int = BATCHES, emit=print) -> None:
    """One JSON line a point; a point that runs out of device memory prints its
    ``error`` instead."""
    dev = check_device(device)
    cfg = eval_config(overrides)
    _, step = build_eval(cfg, dev)
    text = torch.from_numpy(draw_text(cfg.num_classes, text_dim(cfg))).to(dev)
    for bs, canvas in points:
        try:
            point = bench_point(bs, canvas, step, text, dev, warmup, n)
        except torch.cuda.OutOfMemoryError as e:
            point = {"batch": bs, "canvas": list(canvas), "error": type(e).__name__}
            torch.cuda.empty_cache()
        emit(json.dumps(point))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--sweep", action="store_true", help="one line per (batch, canvas) point")
    args = ap.parse_args(argv)
    if args.sweep:
        sweep(args.device, emit=lambda s: print(s, flush=True))
    else:
        print(json.dumps(bench_line(args.device)), flush=True)


if __name__ == "__main__":
    main()
