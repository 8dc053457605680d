"""The port's benches (``richsem_tpu_torch/bench.py``,
``richsem_tpu_torch/tools/bench_eval.py`` and
``richsem_tpu_torch/tools/bench_input_pipeline.py``) on the CPU.

* Their draws are the JAX benches' array for array, at a 160 x 224 canvas:
  the root ``bench.py`` and ``tools/bench_eval.py`` run with their model,
  teacher, optimizer and step stubbed out (the batch and the text bank they
  hand to the step are caught), against ``bench.draw_batch`` and
  ``bench_eval.draw_batch``/``draw_text``.
* The train bench's step, built by ``bench.build_train`` from
  ``bench.bench_config`` at the tiny width of
  ``tests/test_torch_flagship_train.py`` (with the flagship's 1204 classes, so
  the bench's labels are in range) and that file's tiny CLIP teacher, with
  the JAX weights carried by ``params_from_jax``: its first step on the bench's
  batch and text bank against JAX ``make_train_step``, every metric to 1e-5
  (the grad norm to 1e-4), as that file holds step 0. The canvas' tile plan is
  not integral, so neither side clamps or windows the encoder (ROADMAP F2).
* The eval bench's step (``bench_eval.build_eval``) on its batch and text bank
  against JAX ``make_eval_step`` at the same tiny width (the logit scale set
  to 1, so that the top scores do not saturate): the top-300 scores to 1e-3,
  labels and boxes where the score is apart from its neighbours, as
  ``tests/test_torch_dino_eval.py`` holds them.
* The three JSON lines' keys, with the device fields null on the CPU (not
  measured), the metric saying ``cpu``; the sweep's lines.
* The knobs: those the port implements set the config; the others raise
  ``NotImplementedError`` naming their ROADMAP item. Without a card the
  benches refuse to run unless asked for the CPU.
* The input-pipeline bench at 8 images and 2 threads prints its keys.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import richsem_tpu.models.clip
import richsem_tpu.models.dino
import richsem_tpu.train.engine
import richsem_tpu.train.optim
from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_eval_step as jax_make_eval_step
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
from richsem_tpu_torch import bench
from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig
from richsem_tpu_torch.tools import bench_eval, bench_input_pipeline
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_dino_eval import _np_params as eval_np_params
from tests.test_torch_flagship_train import FLAGSHIP, _check, _setup
from tests.test_torch_train_step import _jax_draws

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (160, 224)  # valid 64 x 104; the tile plan is not integral (F2)
WIDE = dict(num_classes=1204, dn_labelbook_size=1204)  # the bench's label range
TINY_EVAL = dict(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
                 num_queries=20, clip_embed_dim=16, compute_dtype="float32")


class _Caught(Exception):
    pass


class _Stub:
    def __init__(self, *args, **kwargs):
        pass

    def init(self, *args, **kwargs):
        return {}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _catch(*args):
    raise _Caught(*args)


@pytest.fixture
def stubbed(monkeypatch):
    """The JAX package's model, teacher, optimizer and steps replaced so that its
    benches stop at their first step with the arguments they hand it."""
    monkeypatch.chdir(ROOT)
    for var in ("BENCH_BATCH", "BENCH_VALID", "BENCH_EVAL_BATCH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(richsem_tpu.models.dino, "DINO", _Stub)
    monkeypatch.setattr(richsem_tpu.models.clip, "CLIP", _Stub)
    monkeypatch.setattr(richsem_tpu.train.optim, "build_optimizer", lambda *a, **k: None)
    monkeypatch.setattr(richsem_tpu.train.engine, "create_train_state", lambda *a, **k: None)
    monkeypatch.setattr(richsem_tpu.train.engine, "make_train_step",
                        lambda *a, **k: (lambda state, batch, rng, text, clip: _catch(batch, text)))
    monkeypatch.setattr(richsem_tpu.train.engine, "make_eval_step",
                        lambda *a, **k: (lambda params, batch, text: _catch(batch, text)))
    monkeypatch.setattr(sys, "argv", ["bench"])


def _same(port, ref):
    assert set(port) == set(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert port[k].dtype == v.dtype and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], v, err_msg=k)


def test_train_bench_draws_equal_the_root_bench(stubbed, monkeypatch):
    root_bench = _load("root_bench", "bench.py")
    monkeypatch.setattr(root_bench, "CANVAS", CANVAS)
    with pytest.raises(_Caught) as caught:
        root_bench.main()
    ref_batch, ref_text = caught.value.args
    cfg, batch_size, n_valid = bench.bench_config(env={})
    assert (batch_size, n_valid, bench.text_dim(cfg)) == (2, 16, 1024)
    batch, text = bench.draw_batch(batch_size, n_valid, cfg.num_classes, bench.text_dim(cfg),
                                   CANVAS)
    _same(batch, ref_batch)
    _same({"text": text}, {"text": ref_text})


def test_eval_bench_draws_equal_the_jax_tool(stubbed, monkeypatch):
    jax_tool = _load("jax_bench_eval", "tools/bench_eval.py")
    monkeypatch.setattr(jax_tool, "CANVAS", CANVAS)
    with pytest.raises(_Caught) as caught:
        jax_tool.main()
    ref_batch, ref_text = caught.value.args
    cfg = bench_eval.eval_config()
    _same(bench_eval.draw_batch(2, CANVAS), ref_batch)
    _same({"text": bench_eval.draw_text(cfg.num_classes, bench.text_dim(cfg))},
          {"text": ref_text})


def test_train_bench_step_matches_jax():
    s = _setup(**WIDE)
    cfg, batch_size, n_valid = bench.bench_config(env={}, overrides=dict(FLAGSHIP, **WIDE))
    assert {k: getattr(cfg, k) for k in FLAGSHIP} == {k: getattr(s["cfg"], k) for k in FLAGSHIP}
    batch, text = bench.draw_batch(batch_size, n_valid, cfg.num_classes, bench.text_dim(cfg),
                                   CANVAS)
    state, step, teacher = bench.build_train(cfg, "cpu", teacher=s["clip"])
    assert teacher is s["clip"]
    state.model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, s["params"]),
                                                expected=state.model.state_dict()))
    rng = jax.random.PRNGKey(11)
    jax_step = jax_make_train_step(s["jax_model"], s["jcfg"], s["tx"], clip_model=s["jax_clip"])
    _, ref = jax_step(jax_create_state(s["params"], s["tx"]),
                      {k: jnp.asarray(v) for k, v in batch.items()}, rng, jnp.asarray(text),
                      s["clip_params"])
    out = step(state, bench.to_device(batch, "cpu"), torch.from_numpy(text),
               draws=_jax_draws(cfg, rng, 0))
    _check({k: np.asarray(v) for k, v in ref.items()},
           {k: v.detach().numpy() for k, v in out.items()}, 1e-5, 0)


def test_eval_bench_step_matches_jax():
    cfg = bench_eval.eval_config(TINY_EVAL)
    jcfg = JaxConfig.fromfile(os.path.join(ROOT, "configs/richsem/richsem_4scale_lvis.py"))
    jcfg.update(TINY_EVAL)
    jax_model = JaxDINO(JaxDINOConfig.from_config(jcfg))
    text = bench_eval.draw_text(cfg.num_classes, bench.text_dim(cfg))
    batch = bench_eval.draw_batch(2, CANVAS)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64), bool), text_embed=jnp.asarray(text))
    params = eval_np_params(shapes, np.random.default_rng(0))
    # CLIP's scale, 1 / 0.07, saturates every top score of the 16-wide random
    # head at 1 - 1e-5; at scale 1 their ranks are defined
    params["params"]["logit_scale"] = np.zeros_like(params["params"]["logit_scale"])
    model, step = bench_eval.build_eval(cfg, "cpu")
    model.load_state_dict(params_from_jax(params, expected=model.state_dict()))
    ref = jax_make_eval_step(jax_model, jcfg)(jax.tree.map(jnp.asarray, params),
                                              {k: jnp.asarray(v) for k, v in batch.items()},
                                              jnp.asarray(text))
    out = step(bench.to_device(batch, "cpu"), torch.from_numpy(text))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    assert out["scores"].shape == (2, cfg.num_select) and out["boxes"].shape == (2, 300, 4)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=1e-3, atol=1e-3)
    s = ref["scores"]
    gap = np.full(s.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], s[:, :-1] - s[:, 1:])
    gap[:, :-1] = np.minimum(gap[:, :-1], s[:, :-1] - s[:, 1:])
    apart = gap > 1e-6  # the scores agree to ~1e-7: a rank is defined past 1e-6
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(out["labels"][apart], ref["labels"][apart])
    np.testing.assert_allclose(out["boxes"][apart], ref["boxes"][apart], rtol=1e-3,
                               atol=1e-3 * 640)


STEADIED = {"warmup", "timed", "device_busy_ms", "device_ops", "idle_share",
            "profile_retakes", "peak_memory_gb", "card", "device"}
DEVICE_FIELDS = ("device_busy_ms", "device_ops", "idle_share", "profile_retakes",
                 "peak_memory_gb", "card")


def _tiny_teacher():
    teacher = CLIP(dataclasses.replace(
        CLIPConfig.rn50(), embed_dim=16, vision_layers=(1, 1, 1, 1), vision_width=8,
        vision_heads=4, image_resolution=64, vocab_size=64, transformer_width=16,
        transformer_heads=2, transformer_layers=1, context_length=8), device="cpu")
    teacher.init_weights(torch.Generator().manual_seed(3))
    return teacher.eval().requires_grad_(False)


def _steadied_fields(line, unit, warmup, timed):
    times = [line[f"ms_per_{unit}_{k}"] for k in ("min", "median", "max")]
    assert times == sorted(times) and times[0] > 0
    assert (line["warmup"], line["timed"], line["device"]) == (warmup, timed, "cpu")
    assert all(line[k] is None for k in DEVICE_FIELDS)  # not measured on the CPU
    assert line[f"launches_per_{unit}"] == {k: 0 for k in bench.KERNELS}  # plain versions


def test_train_bench_line_schema():
    line = bench.bench_line("cpu", env={}, overrides=dict(TINY_EVAL, distill_max_boxes=4),
                            canvas=CANVAS, teacher=_tiny_teacher(), warmup=1, steps=2)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "ms_per_step_median",
                         "ms_per_step_min", "ms_per_step_max", "launches_per_step",
                         "auction_rounds_per_step", "auction_device_ms", "graph",
                         "capture_ms", "pool_gb"} | STEADIED
    assert line["auction_rounds_per_step"] is None and line["auction_device_ms"] is None
    assert (line["graph"], line["capture_ms"], line["pool_gb"]) == (False, None, None)
    assert line["metric"].startswith("train images/sec/chip") and line["metric"].endswith("cpu)")
    assert "f32" in line["metric"] and line["unit"] == "images/sec"
    assert line["value"] == pytest.approx(2e3 / line["ms_per_step_median"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 4.4)
    _steadied_fields(line, "step", 1, 2)
    json.dumps(line)


def test_eval_bench_line_and_sweep_schema():
    line = bench_eval.bench_line("cpu", overrides=TINY_EVAL, canvas=CANVAS, warmup=1, n=2)
    point = {"batch", "canvas", "ms_per_image", "ms_per_batch", "ms_per_batch_median",
             "ms_per_batch_min", "ms_per_batch_max", "launches_per_batch", "graph",
             "capture_ms", "pool_gb"} | STEADIED
    assert set(line) == {"metric", "value", "unit"} | point
    assert (line["graph"], line["capture_ms"], line["pool_gb"]) == (False, None, None)
    assert line["metric"].startswith("eval images/sec/chip") and line["metric"].endswith("cpu)")
    assert (line["batch"], line["canvas"]) == (2, list(CANVAS))
    assert line["value"] == pytest.approx(2e3 / line["ms_per_batch"])
    _steadied_fields(line, "batch", 1, 2)
    lines = []
    bench_eval.sweep("cpu", overrides=TINY_EVAL, points=((1, CANVAS), (2, CANVAS[::-1])),
                     warmup=0, n=1, emit=lines.append)
    rows = [json.loads(s) for s in lines]
    assert [(r["batch"], r["canvas"]) for r in rows] == [(1, list(CANVAS)), (2, [224, 160])]
    assert all(set(r) == point | {"images_per_sec"} for r in rows)


def test_input_pipeline_bench_prints_its_keys(capsys):
    bench_input_pipeline.main(["--images", "8", "--threads", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"metric", "value", "unit", "cores", "per_core", "threads", "images",
                         "corpus_gen_s", "chip_rate", "ratio_to_chip", "decode_ms"}
    assert "JPEG corpus" in line["metric"] and line["threads"] == 2
    assert line["decode_ms"] > 0
    assert line["value"] > 0 and line["images"] > 0 and line["chip_rate"] == 5.0


@pytest.mark.parametrize("env,item", [
    ({"BENCH_IMPL": "tiled"}, "item 12"),
    ({"BENCH_TILE": "8,8"}, "item 12"),
    ({"BENCH_MARGIN": "8"}, "item 12"),
    ({"BENCH_DEC_IMPL": "gather"}, "item 12"),
], ids=lambda v: "-".join(v) if isinstance(v, dict) else None)
def test_refused_knobs_name_their_roadmap_item(env, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, {item}"):
        bench.bench_config(env=env)


REMAT = ("use_checkpoint", "backbone_remat", "enc_selective_remat")


@pytest.mark.parametrize("env,on", [
    ({}, ()),
    ({"BENCH_BATCH": "1"}, ()),
    ({"BENCH_BATCH": "3"}, ("backbone_remat", "enc_selective_remat")),
    ({"BENCH_BATCH": "4"}, ("backbone_remat", "enc_selective_remat")),
    ({"BENCH_BATCH": "8", "BENCH_REMAT": "1"}, REMAT),
    ({"BENCH_REMAT": "1"}, ("use_checkpoint",)),
    ({"BENCH_REMAT": "0"}, ()),
    ({"BENCH_BB_REMAT": "1"}, ("backbone_remat",)),
    ({"BENCH_SEL_REMAT": "1"}, ("enc_selective_remat",)),
], ids=lambda v: ("-".join(f"{k[6:]}{x}" for k, x in v.items()) or "none")
   if isinstance(v, dict) else None)
def test_remat_knobs_follow_the_root_bench(env, on):
    """``BENCH_BATCH`` of 3 or more turns ``backbone_remat`` and
    ``enc_selective_remat`` on, and each ``BENCH_*REMAT=1`` its knob, as the
    root bench sets them (``bench.py:75-81``); the batch size is the one asked."""
    cfg, batch_size, _ = bench.bench_config(env=env)
    assert {k for k in REMAT if cfg[k]} == set(on)
    assert batch_size == int(env.get("BENCH_BATCH", "2"))


def test_implemented_knobs_set_the_config():
    env = {"BENCH_BATCH": "1", "BENCH_VALID": "8", "BENCH_DEC_IMPL": "sep_pallas",
           "BENCH_NO_DN": "1", "BENCH_NO_DISTILL": "1", "BENCH_MATCHER": "HungarianMatcher",
           "BENCH_MONITOR": "0", "BENCH_ENC_LAYERS": "3", "BENCH_DEC_LAYERS": "4",
           "BENCH_IMPL": "pallas2", "BENCH_REMAT": "0", "BENCH_FUSED_OPT": "0"}
    cfg, batch_size, n_valid = bench.bench_config(env=env)
    assert (batch_size, n_valid) == (1, 8)
    assert cfg.fused_adamw is False
    fused, _, _ = bench.bench_config(env={"BENCH_FUSED_OPT": "1"})
    assert fused.fused_adamw is True
    assert (cfg.dec_msda_impl, cfg.use_dn, cfg.use_visual_distill, cfg.use_clip_visual_query,
            cfg.matcher_type, cfg.monitor_msda_offsets, cfg.enc_layers, cfg.dec_layers,
            cfg.compute_dtype) == ("sep_pallas", False, False, False, "HungarianMatcher",
                                   False, 3, 4, "bfloat16")
    default, _, _ = bench.bench_config(env={})
    assert (getattr(default, "dec_msda_impl", "sep"), default.use_dn,
            default.use_visual_distill, default.monitor_msda_offsets,
            default.enc_layers) == ("sep", True, True, True, 6)


def test_the_launch_guard_names_the_optimizer_kernels():
    """The optimizer's kernels are counted like the model's: K5 (the norm,
    ``sumsq_kernel`` and its finish) and K6 (the update, ``adamw_kernel``)
    each have a wrapper with ``.launches`` and a ``__global__`` name that the
    profile reader knows, so ``guarded_profile`` holds their counts too."""
    from richsem_tpu_torch.ops import adamw
    from richsem_tpu_torch.utils.profiling import HAND_WRITTEN

    assert bench.KERNELS["K5"] == ("adamw", "global_norm_clip", "sumsq_kernel")
    assert bench.KERNELS["K6"] == ("adamw", "adamw_update", "adamw_kernel")
    counters = bench.launch_counters()
    assert counters["K5"] is adamw.global_norm_clip and counters["K6"] is adamw.adamw_update
    assert {"sumsq_kernel", "sumsq_finish_kernel", "adamw_kernel"} <= set(HAND_WRITTEN)
    assert all(name in HAND_WRITTEN for _, _, name in bench.KERNELS.values())


def test_benches_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in (lambda: bench.bench_line(env={}), bench_eval.bench_line,
                lambda: bench_eval.sweep(emit=print)):
        with pytest.raises(RuntimeError, match="--device cpu"):
            run()
