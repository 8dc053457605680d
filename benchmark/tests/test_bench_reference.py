"""The plain reference against the port at tiny widths on the CPU, both in
float32: one eval batch and one train step agree, so that a fault of the
reference shows before any chip time. (The reference imports nothing of the
port; this test imports both.)"""

import time

import pytest
import torch

from benchmark.harness import eval_cell, train_cell
from benchmark.tests import tiny


def _f32(run, monkeypatch):
    run.conf["overrides"]["compute_dtype"] = "float32"
    run.conf["config"]["compute_dtype"] = "float32"
    import richsem_tpu_torch.models.build as build

    teacher = build.build_clip_teacher
    monkeypatch.setattr(build, "build_clip_teacher",
                        lambda cfg, dtype=None, device="cuda", generator=None:
                        teacher(cfg, None, device, generator))
    return run


@pytest.mark.parametrize("workload", ["r50-eval", "swinl-eval"])
def test_eval_batch_agrees(workload, monkeypatch):
    torch.manual_seed(0)
    run = _f32(tiny.run(workload, seed=7), monkeypatch)
    out = eval_cell.run(run, time.perf_counter())
    n = out["numbers"]
    assert n["sorted_score_gap"] < 1e-5
    assert n.get("entry_gap", 0.0) < 1e-5 and ("entry_gap" in n) == (workload == "r50-eval")
    assert out["failed"] == 0


def test_train_step_agrees(monkeypatch):
    run = _f32(tiny.run("r50-train", seed=7, steps_checked=1), monkeypatch)
    out = train_cell.run(run, time.perf_counter())
    n = out["numbers"]
    assert n["loss_gap"] < 1e-5
    assert n["grad_gap"] < 1e-4 and n["enc_grad_gap"] < 1e-4
    assert n["update_gap"] < 1e-3
