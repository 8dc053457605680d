"""``BENCHMARK.json`` keeps to its contract's names, units and keys, and every
name it holds has its file."""

import os
import re

from benchmark.harness import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_keys_names_and_units():
    b = core.load_json("BENCHMARK.json")
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in b["end_to_end"] + b["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        names.append(m["name"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"])
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


def test_every_name_has_its_file():
    b = core.load_json("BENCHMARK.json")
    root = core.ROOT
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.isfile(os.path.join(root, c["file"]))
    for w in b["workloads"]:
        assert os.path.isfile(os.path.join(root, "benchmark/traffic", w["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(root, "benchmark/limits", w["name"] + ".json"))
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(root, "benchmark/metrics", m["name"] + ".py"))
        assert callable(core.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    b = core.load_json("BENCHMARK.json")
    for w in b["workloads"]:
        e2e = [m["name"] for m in core.cell_metrics(b, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert core.cell_metrics(b, w["name"], "per_layer")
