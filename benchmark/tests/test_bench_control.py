"""The control comes out not correct: the plain reference computed in float8
(operands and results) put in the program's place fails one of each cell's
numbers against the cell's limits. On the CPU at tiny widths; on the card
(marked ``card``) at each cell's own size on three seeds (``PERF.md`` has
the readings the limits were set from)."""

import importlib
import time

import pytest

from benchmark.harness import compare, core
from benchmark.reference.control import Float8
from benchmark.tests import tiny

CELLS = ["r50-train", "swinl-eval", "r50-eval"]


def _runner(mix):
    return importlib.import_module(f"benchmark.harness.{mix['kind']}_cell")


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_tiny_widths(workload):
    run = tiny.run(workload, seed=21)
    runner = _runner(run.mix)
    out = runner.run(run, time.perf_counter())
    ctl = runner.control_numbers(tiny.run(workload, seed=21), out, Float8)
    limits = core.load_json(f"benchmark/limits/{workload}.json")
    assert not compare.passed(compare.judge(ctl, limits)), ctl


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(workload, card):
    bench = core.load_json("BENCHMARK.json")
    cell, conf, mix = core.resolve(bench, workload)
    runner = _runner(mix)
    limits = core.load_json(f"benchmark/limits/{workload}.json")
    for seed in (901, 902, 903):
        out = runner.run(core.Run(bench, cell, conf, mix, seed, 1.0, False), time.perf_counter())
        ctl = runner.control_numbers(core.Run(bench, cell, conf, mix, seed, 1.0, False), out,
                                     Float8)
        assert not compare.passed(compare.judge(ctl, limits)), (seed, ctl)
