"""A configuration, a traffic mix and a per-layer metric added only as files
are found by the names ``BENCHMARK.json`` gives them."""

import copy
import json
import os

from benchmark.harness import core


def test_new_files_are_found_by_name(tmp_path):
    b = copy.deepcopy(core.load_json("BENCHMARK.json"))
    conf_file = tmp_path / "conf.json"
    conf_file.write_text(json.dumps({"base": "x.py", "config": {"hidden_dim": 256}}))
    mix_name = "zz-test-mix"
    mix_path = os.path.join(core.HERE, "traffic", f"{mix_name}.json")
    metric = "zz_test_metric.eval"
    metric_path = os.path.join(core.HERE, "metrics", f"{metric}.py")
    try:
        with open(mix_path, "w") as f:
            json.dump({"kind": "eval", "batch": 3}, f)
        with open(metric_path, "w") as f:
            f.write("def read(run):\n    return 42.0 if run.kind == 'eval' else None\n")
        b["configs"].append({"name": "zz-conf", "source": "s", "file": str(conf_file),
                             "reduced": [], "why": "w"})
        b["workloads"].append({"name": "zz-cell", "config": "zz-conf", "traffic": mix_name,
                               "chips": 1, "why": "w"})
        b["per_layer"].append({"name": metric, "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "x",
                               "moves": "eval_img_per_s", "workloads": ["zz-cell"]})
        cell, conf, mix = core.resolve(b, "zz-cell")
        assert conf["name"] == "zz-conf" and conf["config"]["hidden_dim"] == 256
        assert mix["batch"] == 3
        run = core.Run(b, cell, conf, mix, 1, 1.0, True, device="cpu")
        assert core.per_layer(run) == {metric: {"value": 42.0, "unit": "ms"}}
    finally:
        for p in (mix_path, metric_path):
            if os.path.exists(p):
                os.remove(p)
