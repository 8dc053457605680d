"""The eval step as a CUDA graph (``train/engine.py:EvalStep``): the parts that
run on the CPU.

* On the CPU the step runs its body, :func:`eval_forward`, as it is: equal to
  the body bit for bit, and to JAX ``make_eval_step`` on the same weights
  within the tolerances of ``tests/test_torch_dino_eval.py``; it captures no
  graph and counts no launch.
* :func:`graph_key`: one key for the same shapes and dtypes, another for
  another canvas, batch size, text bank or dtype.
* The launch accounting: :func:`captured_launches` returns each counter's
  rise during a capture and puts the counters back (also when the capture
  raises), and :func:`add_launches` adds it on every replay; a stand-in
  capture object plays the graph.
* The step bodies on the card may read nothing on the host and copy nothing
  from it, or a capture fails: after a warm-up, the eval forward and the
  flagship train step (with the auction, which K4 runs on the card, held
  aside) make no ``item``/``nonzero``-like read and lift no host data.
* The sampling-location normaliser, now built once per pyramid, dtype and
  device, equals the old per-call ``torch.tensor`` bit for bit, for 2-d and
  4-d references, in float32 and bfloat16.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.train.engine import make_eval_step as jax_make_eval_step
from richsem_tpu_torch import bench
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import matcher
from richsem_tpu_torch.ops import lap
from richsem_tpu_torch.ops.ms_deform_attn import compute_sampling_locations
from richsem_tpu_torch.train import engine
from tests.test_torch_bench import TINY_EVAL, _tiny_teacher
from tests.test_torch_dino_eval import NUM_SELECT, TOL, _batch, models  # noqa: F401

torch.set_num_threads(2)


def test_cpu_step_is_the_body_and_matches_jax(models):  # noqa: F811
    jax_model, params, model, text_embed = models
    cfg = {"num_select": NUM_SELECT, "nms_iou_threshold": -1}
    batch = _batch((128, 192), (64, 128), seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    text = torch.from_numpy(text_embed)
    step = engine.make_eval_step(model, Config(cfg))
    before = {k: c.launches for k, c in bench.launch_counters().items()}
    out = step(tb, text)
    with torch.inference_mode():
        body = engine.eval_forward(model, Config(cfg), tb, text)
    assert step.graphs == {} and step.pool_bytes == 0
    assert {k: c.launches for k, c in bench.launch_counters().items()} == before
    for k in ("scores", "labels", "boxes"):
        assert torch.equal(out[k], body[k]), k
    ref = jax_make_eval_step(jax_model, JaxConfig(cfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(text_embed))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(ref["scores"]), rtol=TOL,
                               atol=TOL)


def _key_batch(b, h, w, dtype=torch.float32):
    return {"images": torch.zeros(b, h, w, 3, dtype=dtype),
            "pad_mask": torch.zeros(b, h, w, dtype=torch.bool),
            "orig_size": torch.zeros(b, 2, dtype=torch.int32)}


def test_graph_key():
    text = torch.zeros(12, 16)
    key = engine.graph_key(_key_batch(2, 96, 128), text)
    assert key == engine.graph_key(_key_batch(2, 96, 128), torch.ones(12, 16))
    others = [engine.graph_key(_key_batch(2, 128, 96), text),
              engine.graph_key(_key_batch(1, 96, 128), text),
              engine.graph_key(_key_batch(2, 96, 128), None),
              engine.graph_key(_key_batch(2, 96, 128), torch.zeros(13, 16)),
              engine.graph_key(_key_batch(2, 96, 128, torch.bfloat16), text)]
    assert len({key, *others}) == 1 + len(others)


class _StandInGraph:
    """Plays a CUDA graph for the accounting: capturing runs the wrappers'
    Python (their counters rise), the card runs nothing."""

    def __init__(self, counters, per_call):
        self.counters, self.per_call = counters, per_call

    def capture(self):
        for k, n in self.per_call.items():
            self.counters[k].launches += n


def test_launch_accounting_adds_the_captured_deltas_on_replay():
    counters = {"K1": types.SimpleNamespace(launches=5),
                "K2": types.SimpleNamespace(launches=2),
                "K4": types.SimpleNamespace(launches=9)}
    graph = _StandInGraph(counters, {"K1": 12, "K2": 6})
    delta = engine.captured_launches(counters, graph.capture)
    assert delta == {"K1": 12, "K2": 6, "K4": 0}
    assert [c.launches for c in counters.values()] == [5, 2, 9]  # the capture ran nothing
    for _ in range(3):  # three replays
        engine.add_launches(counters, delta)
    assert [c.launches for c in counters.values()] == [5 + 36, 2 + 18, 9]

    def failing():
        graph.capture()
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        engine.captured_launches(counters, failing)
    assert [c.launches for c in counters.values()] == [41, 20, 9]


class _HostReads(TorchDispatchMode):
    """Records the operations that read the card from the host or lift host
    data onto it (what a CUDA graph cannot capture and
    ``torch.cuda.set_sync_debug_mode("error")`` refuses)."""

    NAMES = ("_local_scalar_dense", "nonzero", "lift_fresh", "masked_select", "unique",
             "argwhere")

    def __init__(self):
        super().__init__()
        self.seen, self.paused = [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not self.paused and any(n in name for n in self.NAMES):
            self.seen.append(name)
        if not self.paused and name.startswith("aten.index.Tensor"):
            if any(t is not None and t.dtype == torch.bool for t in args[1]):
                self.seen.append(name + " (bool mask)")
        return func(*args, **(kwargs or {}))


def test_eval_forward_reads_nothing_on_the_host(models):  # noqa: F811
    _, _, model, text_embed = models
    cfg = Config({"num_select": NUM_SELECT, "nms_iou_threshold": -1})
    batch = {k: torch.from_numpy(v) for k, v in _batch((128, 192), (64, 128), seed=4).items()}
    text = torch.from_numpy(text_embed)
    with torch.inference_mode():
        engine.eval_forward(model, cfg, batch, text)  # warm-up, as before a capture
        with _HostReads() as mode:
            engine.eval_forward(model, cfg, batch, text)
    assert mode.seen == []


def test_train_step_reads_nothing_on_the_host_but_the_auction(monkeypatch):
    """The tiny flagship step of ``tests/test_torch_bench.py`` (teacher,
    distillation, CDN, the federated loss, AdamW); the plain auction, which
    reads a flag every round on the CPU, runs outside the record."""
    cfg, bs, n_valid = bench.bench_config(env={}, overrides=dict(TINY_EVAL, distill_max_boxes=4))
    batch_np, text_np = bench.draw_batch(bs, n_valid, cfg.num_classes, bench.text_dim(cfg),
                                         (160, 224))
    state, step, _ = bench.build_train(cfg, torch.device("cpu"), _tiny_teacher())
    batch, text = bench.to_device(batch_np, "cpu"), torch.from_numpy(text_np)
    step(state, batch, text)  # warm-up
    mode, solve, calls = _HostReads(), matcher.batched_min_cost_assignment, []

    def aside(*args, **kwargs):
        mode.paused = True
        try:
            calls.append(1)
            return solve(*args, **kwargs)
        finally:
            mode.paused = False

    monkeypatch.setattr(matcher, "batched_min_cost_assignment", aside)
    with mode:
        step(state, batch, text)
    # a matching for each decoder layer and one for the encoder's proposals
    assert mode.seen == [] and len(calls) == cfg.dec_layers + 1


SHAPES = ((12, 18), (6, 9), (3, 5), (2, 3))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("ref_dim", [2, 4])
def test_normaliser_equals_the_per_call_tensor(dtype, ref_dim):
    rng = np.random.default_rng(ref_dim)
    refs = torch.from_numpy(rng.uniform(0.05, 0.95, (2, 7, 4, ref_dim)).astype(np.float32))
    offs = torch.from_numpy(rng.normal(0, 3, (2, 7, 4, 4, 3, 2)).astype(np.float32)).to(dtype)
    got = compute_sampling_locations(refs, offs, SHAPES, 3)
    if ref_dim == 2:
        old = torch.tensor([[w, h] for h, w in SHAPES], dtype=offs.dtype, device=offs.device)
        want = refs[:, :, None, :, None, :] + offs / old[None, None, None, :, None, :]
    else:
        ref = refs[:, :, None, :, None, :]
        want = ref[..., :2] + offs / 3 * ref[..., 2:] * 0.5
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(compute_sampling_locations(refs, offs, list(SHAPES), 3), got)
