"""Nothing the benchmark runs imports JAX, flax or the JAX package, compared
by whole top-level module names (``richsem_tpu_torch`` is not ``richsem_tpu``)."""

import os
import subprocess
import sys

from benchmark.harness import core

CODE = r"""
import sys
sys.path.insert(0, {root!r})
import glob, importlib, os
import benchmark.run, benchmark.calibrate
from benchmark.harness import core, eval_cell, train_cell, program, entries
from benchmark.reference import control, criterion, detector, teacher, train
import richsem_tpu_torch.models.build, richsem_tpu_torch.train.engine, richsem_tpu_torch.bench
import richsem_tpu_torch.train.optim, richsem_tpu_torch.ops.lap
for path in glob.glob(os.path.join({root!r}, "benchmark", "metrics", "*.py")):
    name = os.path.basename(path)[:-3]
    if not name.startswith("_"):
        core.reader(name)
print(core.forbidden_modules())
"""


def test_top_level_names_compare_whole():
    sys.modules.setdefault("richsem_tpu_torch_probe", sys)
    names = [m for m in core.forbidden_modules()]
    assert "richsem_tpu_torch" not in names and "richsem_tpu_torch_probe" not in names
    sys.modules["richsem_tpu.fake"] = sys
    try:
        assert "richsem_tpu.fake" in core.forbidden_modules()
    finally:
        del sys.modules["richsem_tpu.fake"], sys.modules["richsem_tpu_torch_probe"]


def test_nothing_imported_loads_jax():
    env = dict(os.environ, USE_FLAX="0")
    out = subprocess.run([sys.executable, "-c", CODE.format(root=core.ROOT)], capture_output=True,
                         text=True, env=env, timeout=300, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
