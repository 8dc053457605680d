"""The trainer (``richsem_tpu_torch/train/main.py``) as two data-parallel ranks
over gloo on the CPU (``parallel/dist.py``), and its configuration checks.

The tiny DINO of ``tests/test_torch_main.py`` over a synthetic LVIS directory
whose canvas buckets give the ranks different canvases in one step (epoch 0,
step 1) and different batch counts (epoch 1: 2 against 1):

* Both ranks take the smaller count and end with bit-identical states; only
  rank 0 writes ``log.txt``, ``config.json`` and the checkpoints.
* Rank 0's eval AP, from the ranks' gathered predictions, equals a
  single-process ``evaluate`` of the same parameters over the whole val set.
* One epoch and an auto-resumed second equal two epochs straight, bit for bit,
  also where rank 1 sees no checkpoint.
* A loss forced non-finite on one rank stops both ranks one step late with
  ``FloatingPointError``.
* Each rank's first batch equals JAX ``build_loaders(cfg, rank, 2)``'s.

Every spawned set of ranks runs under a limit (``LIMIT``) past which the ranks
are killed and the test fails.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks
from richsem_tpu_torch.data.synthetic import write_lvis
from richsem_tpu_torch.parallel import dist as pdist
from richsem_tpu_torch.train import main
from tests.test_torch_main import LEVEL, ROOT, TINY

torch.set_num_threads(2)
LIMIT = 240  # seconds a spawned set of ranks may take
NAN_AT = 0  # rank 1's step (0-based) whose loss turns non-finite


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lvis_ddp"))
    # seed 3: epoch 0 puts (128, 96) beside (96, 128) at step 1, epoch 1 gives
    # rank 0 two batches and rank 1 one
    write_lvis(root, n_train=10, n_val=4, hw=((60, 80), (90, 120)), n_cats=12,
               max_boxes=6, seed=3)
    base = os.path.join(ROOT, "configs/richsem/dino_4scale_lvis.py")
    paths = {}
    for name, buckets in (("tiny", "[(96, 128), (128, 96), (160, 160)]"),
                          ("one_bucket", "[(192, 192)]")):
        paths[name] = os.path.join(root, f"{name}.py")
        with open(paths[name], "w") as f:
            f.write(TINY.format(base=base, root=root, buckets=buckets) + "batch_size = 2\n")
    return root, paths


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    _, paths = data
    out = tmp_path_factory.mktemp("ddp_runs")
    res = pdist.spawn(ranks.trainer_runs, 2, (paths["tiny"], str(out), 1, NAN_AT), LIMIT)
    files = {}
    for run in ("a", "b", "c"):
        d = out / run
        files[run] = {"log": [json.loads(line) for line in open(d / "log.txt")]
                      if (d / "log.txt").exists() else None,
                      "config": (d / "config.json").exists(),
                      "ckpt": sorted(os.listdir(d / "ckpt")) if (d / "ckpt").exists() else []}
    yield res, files
    shutil.rmtree(out)  # ~400 MB a checkpoint


def test_ranks_take_the_smaller_count_and_stay_equal(runs):
    (r0, r1), files = runs
    assert (r0["rank"], r1["rank"], r0["world"], r0["backend"]) == (0, 1, 2, "gloo")
    counts = [[len(e) for e in r["canvases"]] for r in (r0, r1)]
    assert counts == [[2, 2], [2, 1]]
    assert r0["canvases"][0][1] != r1["canvases"][0][1]  # other canvases in one step
    assert r0["straight"]["step"] == r1["straight"]["step"] == 2 + 1
    assert r0["straight"]["digest"] == r1["straight"]["digest"]  # bit-identical replicas
    e0, e1 = r0["straight"]["epochs"], r1["straight"]["epochs"]
    assert [e["step"] for e in e0] == [2, 3]
    for a, b in zip(e0, e1):  # the logged loss and eval are the global ones on both
        assert a["loss"] == b["loss"] and a["AP"] == b["AP"]


def test_only_rank_zero_writes(runs):
    (r0, r1), files = runs
    assert r1["saves"] == [] and r0["straight"]["saves"]
    a = files["a"]
    assert [e["epoch"] for e in a["log"]] == [0, 1] and a["config"]
    assert a["ckpt"] == ["2.pt", "3.pt"]
    assert files["c"]["ckpt"] == [] and files["c"]["log"] is None


def test_rank_zero_eval_equals_one_process(runs):
    """The gathered eval of the last epoch (the final parameters) against
    ``evaluate`` in one process over the whole val set: rank 0's evaluator
    holds every val image's predictions, equal to one process's bit for bit,
    and the metrics are equal; rank 1 hands its evaluator nothing."""
    (r0, r1), _ = runs
    logged, single = r0["straight"]["epochs"][-1], r0["single_eval"]
    assert r0["images"] == list(range(100000, 100004)) and r0["same_predictions"]
    assert r0["evaluated"] == 4 and r1["evaluated"] == 0  # 2 epochs x (model, EMA)
    assert 0.0 <= single["AP"] <= 1.0
    for k in ("AP", "AP50", "AP75", "APr", "APc", "APf"):
        assert logged[k] == single[k] or (np.isnan(logged[k]) and np.isnan(single[k])), k


def test_resume_matches_straight_run_on_two_ranks(runs):
    """Rank 1 resumes where it sees no checkpoint: rank 0's state, step, AdamW
    count and epoch reach it, and both ranks equal the straight run."""
    (r0, r1), _ = runs
    assert r0["resumed"]["restored"] == 1 and r1["resumed"]["restored"] == 0
    for r in (r0, r1):
        assert r["first_step"] == 2
        assert r["resumed"]["epochs"] == [1]
        assert r["resumed"]["step"] == r["straight"]["step"]
        assert r["resumed"]["digest"] == r["straight"]["digest"]


def test_nonfinite_loss_on_one_rank_stops_both_one_step_late(runs):
    (r0, r1), _ = runs
    assert r0["nan"] == r1["nan"] == {"raised": True, "calls": NAN_AT + 2}


def test_rank_shards_equal_jax_build_loaders(data):
    """Each rank's first batch (train and val) equals JAX ``build_loaders(cfg,
    rank, 2)``'s: JAX's shard holds ``batch_size x devices / 2`` images, the
    port's ``batch_size``."""
    import jax

    from richsem_tpu.train import main as jax_main

    _, paths = data
    jcfg = jax_main.load_config(jax_main.get_args_parser().parse_args(["-c", paths["one_bucket"]]))
    jcfg.update(batch_size=1)
    pcfg = main.load_config(main.get_args_parser().parse_args(
        ["-c", paths["one_bucket"], "--output_dir", "", "--device", "cpu"]))
    pcfg.update(batch_size=jax.device_count() // 2)
    firsts = []
    for rank in range(2):
        jt, jv, _, _ = jax_main.build_loaders(jcfg, rank, 2)
        pt, pv, _, _ = main.build_loaders(pcfg, rank, 2)
        assert len(jt) == len(pt) >= 1
        for j_loader, p_loader in ((jt, pt), (jv, pv)):
            a, b = next(iter(j_loader.epoch(0))), next(iter(p_loader.epoch(0)))
            assert a.keys() == b.keys() and a["images"].shape[0] == pcfg.batch_size
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                if k == "images":
                    assert np.abs(a[k] - b[k]).max() <= 2 * LEVEL
                elif k == "boxes":
                    np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
                else:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            firsts.append(b["image_id"])
    assert not set(firsts[0]) & set(firsts[2])  # the two ranks' train shards differ


@pytest.mark.parametrize("mesh,world,match", [
    ({"data": -1, "model": 2}, 1, "shards nothing over 'model'"),
    ({"data": 3, "model": 1}, 2, "set data=-1"),
    ({"data": 2, "pipe": 1}, 2, "axes are 'data' and 'model'"),
], ids=["model", "data", "axis"])
def test_mesh_shape_errors(mesh, world, match):
    with pytest.raises(ValueError, match=match):
        pdist.check_mesh(mesh, world)
    pdist.check_mesh({"data": -1, "model": 1}, world)
    pdist.check_mesh({"data": world, "model": 1}, world)


def test_train_loop_refuses_a_model_axis(data, tmp_path):
    _, paths = data
    cfg = main.load_config(main.get_args_parser().parse_args(
        ["-c", paths["tiny"], "--output_dir", str(tmp_path), "--device", "cpu"]))
    cfg.update(mesh_shape={"data": -1, "model": 2})
    with pytest.raises(ValueError, match="shards nothing over 'model'"):
        main.train_loop(cfg)


def test_launcher_environment_errors(monkeypatch):
    """A partial launcher environment raises; a CUDA run without a card (or
    NCCL) raises before any group is made: it never falls back to gloo."""
    for k in pdist.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert not pdist.init_distributed("cpu").active
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="incomplete"):
        pdist.init_distributed("cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(pdist.free_port()))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs NCCL and a card"):
            pdist.init_distributed("cuda")
    monkeypatch.setenv("RANK", "2")
    with pytest.raises(ValueError, match="outside WORLD_SIZE"):
        pdist.init_distributed("cpu")
