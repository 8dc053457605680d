"""What every cell shares: the run's context, the per-layer readers found by
name, the check for JAX in the process, and the result line."""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import statistics
import sys
from typing import Any, Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "richsem_tpu")  # whole top-level module names


def load_json(path: str) -> Any:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def resolve(bench: dict, name: str):
    """The cell ``name`` of ``bench`` -> (its entry, its configuration's file
    with its ``name``, its traffic mix ``benchmark/traffic/<traffic>.json``);
    KeyError for a name that ``bench`` does not hold."""
    cell = {w["name"]: w for w in bench["workloads"]}[name]
    conf_file = {c["name"]: c["file"] for c in bench["configs"]}[cell["config"]]
    conf = dict(load_json(conf_file), name=cell["config"])
    return cell, conf, load_json(f"benchmark/traffic/{cell['traffic']}.json")


def forbidden_modules() -> List[str]:
    """Modules in this process whose top-level name (before the first dot) is
    JAX's, jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def quantile(values: List[float], q: int) -> float:
    """The ``q``-th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100)[q - 1]


class Run:
    """One run of one cell: its settings, and what its window and readers see.

    Runners (``<kind>_cell.py``) fill ``window`` (``calls``: host ms of each
    call, ``steps``, ``images``, ``seconds``), ``peak_bytes`` and set the
    measurement hooks that readers call: ``profile_window()``,
    ``entry_calls()``, ``backbone_profile()``, ``teacher_profile()``,
    ``flops_per_call()``, ``matcher_rounds``; each hook is called at most once
    (``hook``)."""

    def __init__(self, bench: dict, workload: dict, conf: dict, mix: dict, seed: int,
                 seconds: float, trace: bool, device: Any = "cuda"):
        self.bench, self.workload, self.conf, self.mix = bench, workload, conf, mix
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.kind = mix["kind"]
        self.window: Dict[str, Any] = {}
        self.peak_bytes: Optional[int] = None
        self.hooks: Dict[str, Callable[[], Any]] = {}
        self._cache: Dict[str, Any] = {}
        self.matcher_rounds: Optional[float] = None

    def hook(self, name: str) -> Any:
        """The value of measurement ``name``, taken once; None where the cell
        has no such measurement."""
        if name not in self._cache:
            fn = self.hooks.get(name)
            self._cache[name] = fn() if fn is not None else None
        return self._cache[name]


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics of ``cell``: those that list
    it, and those without ``workloads`` whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif section == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@functools.lru_cache(maxsize=None)
def reader(name: str) -> Callable[[Run], Optional[float]]:
    """The reader of per-layer metric ``name``: ``benchmark/metrics/<name>.py``'s ``read``."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer(run: Run) -> Dict[str, Dict[str, Any]]:
    """Every per-layer metric of the cell that its reader finds, by name."""
    out = {}
    for m in cell_metrics(run.bench, run.workload["name"], "per_layer"):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def emit(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
         device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
         breakdown: Optional[Dict[str, list]] = None) -> None:
    """Each compared number beside its limit on standard error, then the
    result as the last line of standard output, ``checks`` its last key."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
