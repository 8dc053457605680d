"""The port's trainer entry point (``richsem_tpu_torch/train/main.py``) on the CPU,
with a tiny DINO (hidden 64, 2+2 layers, 20 queries, 12 LVIS-format classes,
EMA on) over a synthetic LVIS directory of small PNGs.

* Two epochs straight, and one epoch, then auto-resume and one more, end in
  bitwise-identical state: parameters, frozen buffers, AdamW moments and count,
  EMA and step.
* A step whose loss is forced non-finite at step k stops the run with
  ``FloatingPointError`` after step k + 1 is issued, not later (at the last
  step of an epoch, at the epoch's end).
* ``--eval`` through the CLI writes finite AP in [0, 1] for the restored step
  (and, with ``--save_results``, the arrays); ``--test`` writes COCO records.
* The port's first batch equals JAX ``build_loaders``' first batch (pixels
  within two uint8 levels of the two resizes, every other key equal).
"""

import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from richsem_tpu_torch.data.synthetic import write_lvis
from richsem_tpu_torch.train import main
from richsem_tpu_torch.utils.checkpoint import state_to_dict

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 1.0 / 255.0 / 0.224 + 1e-6

TINY = """_base_ = ["{base}"]
hidden_dim = 64
nheads = 4
enc_layers = 2
dec_layers = 2
dim_feedforward = 128
num_queries = 20
num_classes = 13
dn_labelbook_size = 13
fed_num_sample_cats = 4
compute_dtype = "float32"
num_select = 20
max_gt_per_image = 8
data_aug_scales = [64, 80, 96]
data_aug_max_size = 160
data_aug_scales2_resize = [56, 72]
data_aug_scales2_crop = [48, 64]
train_canvas_buckets = {buckets}
eval_canvas = (128, 192)
use_ema = True
data_root = "{root}"
"""


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lvis"))
    write_lvis(root, n_train=8, n_val=4, hw=((60, 80), (90, 120)), n_cats=12,
               max_boxes=6, seed=3)
    base = os.path.join(ROOT, "configs/richsem/dino_4scale_lvis.py")
    paths = {}
    for name, buckets in (("tiny", "[(128, 192), (192, 128), (160, 160)]"),
                          ("one_bucket", "[(192, 192)]")):
        paths[name] = os.path.join(root, f"{name}.py")
        with open(paths[name], "w") as f:
            f.write(TINY.format(base=base, root=root, buckets=buckets))
    return root, paths


@pytest.fixture(autouse=True)
def _drop_checkpoints(tmp_path):
    """Each tiny-DINO checkpoint is ~400 MB (the R50 backbone, its moments
    and EMA); pytest keeps the temporary directories of its last three
    sessions, so a test's checkpoints are removed when it ends."""
    yield
    for root, dirs, _ in os.walk(tmp_path):
        if "ckpt" in dirs:
            shutil.rmtree(os.path.join(root, "ckpt"))


def _cfg(cfg_path, out, *extra):
    args = ["-c", cfg_path, "--output_dir", out, "--device", "cpu", *extra]
    return main.load_config(main.get_args_parser().parse_args(args))


def _state_of(result):
    return state_to_dict(result["state"])


def test_resume_matches_straight_run(data, tmp_path):
    _, paths = data
    straight = main.train_loop(_cfg(paths["tiny"], str(tmp_path / "a"), "--options", "epochs=2"))
    first = main.train_loop(_cfg(paths["tiny"], str(tmp_path / "b"), "--options", "epochs=1"))
    resumed = main.train_loop(_cfg(paths["tiny"], str(tmp_path / "b"), "--options", "epochs=2"))
    assert first["state"].step > 0 and len(resumed["ckpt_restore_s"]) == 1
    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    a, b = _state_of(straight), _state_of(resumed)
    assert a["step"] == b["step"] == 2 * first["state"].step
    for part in ("model", "ema"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (part, k)
    assert a["optimizer"]["count"] == b["optimizer"]["count"]
    for key in ("mu", "nu"):
        for k in a["optimizer"][key]:
            assert torch.equal(a["optimizer"][key][k], b["optimizer"][key][k]), (key, k)
    logs = [json.loads(line) for line in open(tmp_path / "a" / "log.txt")]
    assert [e["epoch"] for e in logs] == [0, 1]
    assert all(math.isfinite(e["loss"]) and 0.0 <= e["AP"] <= 1.0 for e in logs)
    assert os.path.isfile(tmp_path / "a" / "config.json")

    # --eval through the CLI: restores the latest checkpoint, writes the AP
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "richsem_tpu_torch.train.main", "-c", paths["tiny"],
         "--output_dir", str(tmp_path / "a"), "--eval", "--save_results", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ev = json.load(open(tmp_path / "a" / "eval.json"))
    assert ev["step"] == a["step"] and 0.0 <= ev["AP"] <= 1.0 and "APr" in ev
    assert os.path.isfile(tmp_path / "a" / "results_rank0.pkl")

    # --test: COCO-format records of the restored model, positive scores only
    out = main.train_loop(_cfg(paths["tiny"], str(tmp_path / "a"), "--test"))
    records = json.load(open(out["test"]))
    assert records and all(r["score"] > 0 and len(r["bbox"]) == 4 for r in records)


@pytest.mark.parametrize("where", ["mid_epoch", "last_step"])
def test_nonfinite_loss_stops_one_step_late(data, tmp_path, monkeypatch, where):
    _, paths = data
    cfg = _cfg(paths["tiny"], str(tmp_path / "nan"), "--options", "epochs=1")
    n_steps = sum(1 for _ in main.build_loaders(cfg)[0].epoch(0))
    assert n_steps >= 3
    bad = 1 if where == "mid_epoch" else n_steps - 1  # the step (0-based) turned non-finite
    real = main.make_train_step
    calls = []

    def make(model, cfg, **kw):
        step = real(model, cfg, **kw)

        def train_step(state, batch, text_embed=None):
            metrics = step(state, batch, text_embed)
            calls.append(state.step)
            if len(calls) == bad + 1:
                metrics["finite"] = torch.tensor(False)
            return metrics

        return train_step

    monkeypatch.setattr(main, "make_train_step", make)
    with pytest.raises(FloatingPointError):
        main.train_loop(cfg)
    # the flag of step k is read once step k + 1 is issued, or at the epoch's end
    assert len(calls) == min(bad + 2, n_steps)
    assert not os.listdir(tmp_path / "nan" / "ckpt")


def test_first_batch_equals_jax_build_loaders(data):
    import jax

    from richsem_tpu.train import main as jax_main

    _, paths = data
    n_dev = jax.device_count()
    jcfg = jax_main.load_config(jax_main.get_args_parser().parse_args(["-c", paths["one_bucket"]]))
    jcfg.update(batch_size=1)  # JAX's global batch is batch_size x devices
    pcfg = _cfg(paths["one_bucket"], "")
    pcfg.update(batch_size=n_dev)
    jt, jv, _, _ = jax_main.build_loaders(jcfg)
    pt, pv, _, _ = main.build_loaders(pcfg)
    assert len(jt) == len(pt)
    for j_loader, p_loader in ((jt, pt), (jv, pv)):
        a, b = next(iter(j_loader.epoch(0))), next(iter(p_loader.epoch(0)))
        assert a.keys() == b.keys() and a["images"].shape[0] == n_dev
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k == "images":
                assert np.abs(a[k] - b[k]).max() <= 2 * LEVEL
            elif k == "boxes":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    placed = main.place_batch(b, "cpu")
    assert placed["labels"].dtype == torch.int64 and placed["images"].dtype == torch.float32

