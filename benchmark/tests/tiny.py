"""Tiny configurations and mixes of the benchmark's cells, for CPU tests:
the same files with narrow widths, few layers and a small canvas."""

from __future__ import annotations

import copy
from benchmark.harness import core

TINY = {"hidden_dim": 64, "nheads": 8, "dim_feedforward": 128, "enc_layers": 2, "dec_layers": 2,
        "num_queries": 40, "num_select": 20, "distill_max_boxes": 8}
SWIN_T = {"embed_dim": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24],
          "window_size": 7, "mlp_ratio": 4.0, "out_indices": [1, 2, 3]}
CLIP_DIM = 1024  # the teacher's embedding width


def bench() -> dict:
    return core.load_json("BENCHMARK.json")


def conf(name: str) -> dict:
    """The configuration ``name`` cut to tiny widths (the file's own keys otherwise)."""
    b = bench()
    path = next(c["file"] for c in b["configs"] if c["name"] == name)
    c = dict(copy.deepcopy(core.load_json(path)), name=name)
    over = dict(TINY, clip_embed_dim=CLIP_DIM)
    if c["config"]["backbone"].startswith("swin"):
        over["backbone"] = "swin_T_224_1k"
        c["config"]["swin"] = dict(SWIN_T)
    c["overrides"] = dict(c["overrides"], **over)
    c["config"].update({k: v for k, v in over.items() if k != "clip_embed_dim"})
    c["text_bank"] = [c["text_bank"][0], CLIP_DIM]
    return c


def mix(name: str, **kw) -> dict:
    """The traffic mix ``name`` on a 128 x 192 canvas with small pools."""
    m = copy.deepcopy(core.load_json(f"benchmark/traffic/{name}.json"))
    m.update(canvas=[128, 192], pool=m.get("steps_checked", 1) + 1)
    m["image_sizes"] = dict(m["image_sizes"], long=160, long_min=120)
    m["resize"] = {"short": [96, 112], "max_long": 190}
    if "gt" in m:
        m["gt"] = dict(m["gt"], slots=12, mean=4.0)
    if "check_images" in m:
        m["check_images"] = 2
    m.update(kw)
    return m


def run(workload: str, seed: int = 5, seconds: float = 0.5, trace: bool = False,
        **mix_kw) -> core.Run:
    b = bench()
    cell = next(w for w in b["workloads"] if w["name"] == workload)
    return core.Run(b, cell, conf(cell["config"]), mix(cell["traffic"], **mix_kw), seed,
                    seconds, trace, device="cpu")
