"""The train step as a CUDA graph (``train/engine.py:TrainStep``): the parts that
run on the CPU, on the tiny flagship step of ``tests/test_torch_bench.py``
(teacher, distillation, CDN, the federated loss, AdamW).

* No number that changes from step to step reaches an operation of the body
  as a Python scalar: the body's operations, recorded with a
  ``TorchDispatchMode`` (each tensor argument replaced by its shape and
  dtype), are the same at step 1 and at a step past ``lr_drop``, where the lr
  is a tenth and the bias corrections differ. The body reads nothing on the
  host and lifts no host data (the auction, which reads a flag every round on
  the CPU, held aside).
* The host part: after N calls the optimizer's count and ``state.step`` are
  N; the lr and bias corrections each call wrote into ``AdamW.hyper`` are
  JAX's (the jitted schedule and ``1 - b ** (count + 1)`` of
  ``optax.scale_by_adam``) to one float32 ulp, and equal for all but a few
  counts across ``lr_drop``; the draws each call handed the body are the
  generator's seeded with ``(seed, step)``. On the CPU the step runs eagerly:
  no graph, no launch counted.
* :func:`train_graph_key`: one key for the same shapes, another for another
  batch size, canvas, G, dtype, ``is_extra`` or ``fed_weight`` present or not,
  text bank or none, and EMA on or off.
* The card's path with a stand-in graph (whose replay runs the body on the
  static buffers): the first call is the eager step and captures; a replay
  from a state equals the eager body from that state bit for bit (metrics,
  parameters, moments, EMA), adds the captured launch deltas to the
  wrappers' counters, advances the counters, leaves the step's draws in the
  static buffers and returns clones; ``.grad`` is ``None`` after a capture; a
  rebound optimizer raises until ``reset()``. The real capture, which needs
  the card, raises naming its key, with no fallback.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import richsem_tpu.train.optim as jax_optim
from richsem_tpu.config import Config as JaxConfig
from richsem_tpu_torch import bench
from richsem_tpu_torch.models import matcher
from richsem_tpu_torch.train import engine
from richsem_tpu_torch.train.optim import build_optimizer
from tests.test_torch_bench import TINY_EVAL, _tiny_teacher
from tests.test_torch_eval_graph import _HostReads

torch.set_num_threads(2)

CANVAS = (160, 224)
PER_REPLAY = {"K1": 4, "K1-bwd": 4, "K2": 2, "K2-bwd": 2, "K4": 3}  # the stand-in's deltas


@pytest.fixture(scope="module")
def flagship():
    cfg, bs, n_valid = bench.bench_config(env={}, overrides=dict(TINY_EVAL, distill_max_boxes=4))
    batch_np, text_np = bench.draw_batch(bs, n_valid, cfg.num_classes, bench.text_dim(cfg),
                                         CANVAS)
    state, step, teacher = bench.build_train(cfg, torch.device("cpu"), _tiny_teacher())
    return types.SimpleNamespace(cfg=cfg, state=state, step=step, teacher=teacher,
                                 batch=bench.to_device(batch_np, "cpu"),
                                 text=torch.from_numpy(text_np))


def _fresh_state(f, steps_per_epoch=1000, use_ema=False):
    return engine.create_train_state(f.state.model,
                                      build_optimizer(f.state.model, f.cfg, steps_per_epoch),
                                      use_ema=use_ema)


def _strip(x):
    """An operation's argument with each tensor replaced by its shape and dtype."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_strip(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _strip(v)) for k, v in x.items()))
    return x


class _Record(_HostReads):
    """Every operation with its non-tensor arguments, and the host reads."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops.append((str(func), _strip(args), _strip(kwargs or {})))
        return super().__torch_dispatch__(func, types, args, kwargs)


def _record_body(f, state):
    """One step with its body recorded (the auction held aside) -> the record
    and the lr and bias corrections the body read."""
    draws = f.step.draws(state, f.batch["labels"].shape[0])
    state.optimizer.prepare()
    hyper = state.optimizer.hyper.clone()
    mode, solve = _Record(), matcher.batched_min_cost_assignment

    def aside(*args, **kwargs):
        mode.paused = True
        try:
            return solve(*args, **kwargs)
        finally:
            mode.paused = False

    matcher.batched_min_cost_assignment = aside
    try:
        with mode:
            f.step.body(state, f.batch, draws, f.text)
    finally:
        matcher.batched_min_cost_assignment = solve
    state.optimizer.advance()
    state.step += 1
    return mode, hyper


@pytest.fixture(scope="module")
def recorded(flagship):
    f = flagship
    state = _fresh_state(f)
    f.step(state, f.batch, f.text)  # step 0, as a warm-up
    early = _record_body(f, state)
    # past lr_drop: the host counters jump, the device state is the same
    state.optimizer.count = state.step = 1000 * f.cfg.lr_drop + 5
    late = _record_body(f, state)
    return early, late


def test_no_step_scalar_reaches_an_operation(recorded):
    (early, h_early), (late, h_late) = recorded
    assert float(h_late[0]) == pytest.approx(0.1 * float(h_early[0]), rel=1e-6)
    assert float(h_late[1]) != float(h_early[1]) and float(h_late[2]) != float(h_early[2])
    assert len(early.ops) > 1000
    assert [op[0] for op in early.ops] == [op[0] for op in late.ops]
    diff = [(a, b) for a, b in zip(early.ops, late.ops) if a != b]
    assert diff == [], diff[:3]


def test_body_reads_nothing_on_the_host(recorded):
    (early, _), (late, _) = recorded
    assert early.seen == [] and late.seen == []


def _jax_chain_scalars(counts, steps_per_epoch):
    """The lr and bias corrections the JAX chain uses at each count: its
    schedule and ``1 - b ** (count + 1)`` of ``optax.scale_by_adam``, jitted on
    an int32 count as the chain's update is."""
    jcfg = JaxConfig.fromfile(bench.CONFIG)
    sched = jax_optim.make_lr_schedule(jcfg, steps_per_epoch)
    one = jax.jit(lambda c: jnp.stack([sched(c), 1 - 0.9 ** (c + 1), 1 - 0.999 ** (c + 1)]))
    return np.stack([np.asarray(one(jnp.int32(c))) for c in counts])


def test_host_bookkeeping_matches_the_jax_chain(flagship, monkeypatch):
    f, n = flagship, 3
    state = _fresh_state(f, steps_per_epoch=2)
    before = {k: c.launches for k, c in bench.launch_counters().items()}
    seen, body = [], f.step.body

    def spy(st, batch, draws, text_embed=None):
        seen.append((st.step, engine._tree_map(torch.clone, draws),
                     st.optimizer.hyper.numpy().copy()))
        return body(st, batch, draws, text_embed)

    monkeypatch.setattr(f.step, "body", spy)
    for _ in range(n):
        f.step(state, f.batch, f.text)
    assert (state.optimizer.count, state.step) == (n, n)
    assert f.step.graphs == {} and f.step.pool_bytes == 0  # eager on the CPU
    assert {k: c.launches for k, c in bench.launch_counters().items()} == before
    ref = _jax_chain_scalars(range(n), 2)
    for i, (step_i, draws, hyper) in enumerate(seen):
        assert step_i == i
        want = engine.step_draws(f.cfg, 2, torch.Generator().manual_seed(0 * 1_000_003 + i),
                                 device="cpu")
        assert set(draws) == set(want) == {"dn", "fed_uniforms"}
        assert torch.equal(draws["fed_uniforms"], want["fed_uniforms"])
        assert all(torch.equal(draws["dn"][k], v) for k, v in want["dn"].items())
        np.testing.assert_array_max_ulp(hyper, ref[i], maxulp=1)

    # the host's scalars across lr_drop (at 2 steps an epoch), without a step
    counts = range(0, 4 * f.cfg.lr_drop + 40)
    opt = build_optimizer(f.state.model, f.cfg, steps_per_epoch=2)
    port = []
    for c in counts:
        opt.count = c
        port.append(opt.scalars())
    port, ref = np.asarray(port, np.float32), _jax_chain_scalars(counts, 2)
    np.testing.assert_array_max_ulp(port, ref, maxulp=1)
    assert (port != ref).mean() < 0.05
    assert port[2 * f.cfg.lr_drop, 0] < port[2 * f.cfg.lr_drop - 1, 0]  # the drop


def _key_batch(b=2, h=96, w=128, g=8, dtype=torch.float32, extra=True, fed=False):
    batch = {"images": torch.zeros(b, h, w, 3, dtype=dtype),
             "pad_mask": torch.zeros(b, h, w, dtype=torch.bool),
             "labels": torch.zeros(b, g, dtype=torch.int64),
             "boxes": torch.zeros(b, g, 4), "valid": torch.zeros(b, g, dtype=torch.bool),
             "size": torch.zeros(b, 2, dtype=torch.int32), "orig_size": torch.ones(b, 2)}
    if extra:
        batch["is_extra"] = torch.zeros(b, dtype=torch.bool)
    if fed:
        batch["fed_weight"] = torch.ones(13)
    return batch


def test_train_graph_key():
    text = torch.zeros(12, 16)
    key = engine.train_graph_key(_key_batch(), text)
    same = _key_batch()
    same["images"] += 1
    same["orig_size"] = torch.zeros(2, 5)  # a field the step does not read
    assert key == engine.train_graph_key(same, torch.ones(12, 16))
    others = [engine.train_graph_key(_key_batch(b=1), text),
              engine.train_graph_key(_key_batch(h=128, w=96), text),
              engine.train_graph_key(_key_batch(g=9), text),
              engine.train_graph_key(_key_batch(dtype=torch.bfloat16), text),
              engine.train_graph_key(_key_batch(extra=False), text),
              engine.train_graph_key(_key_batch(fed=True), text),
              engine.train_graph_key(_key_batch(), None),
              engine.train_graph_key(_key_batch(), torch.zeros(13, 16)),
              engine.train_graph_key(_key_batch(), text, ema=True)]
    assert len({key, *others}) == 1 + len(others)
    none_extra = _key_batch(extra=False)
    none_extra["is_extra"] = None  # an absent field, as the loss reads it
    assert engine.train_graph_key(none_extra, text) == others[4]


class _StandInGraph:
    """Plays a captured graph on the CPU: a replay runs the captured body on the
    static buffers and leaves its outputs in the captured dict."""

    def __init__(self, body, out):
        self.body, self.out, self.replays = body, out, 0

    def replay(self):
        self.out.update(self.body())
        self.replays += 1


def _stand_in_capture(self, key, what, body):
    def capture():  # the wrappers' Python runs, the card nothing
        for k, n in PER_REPLAY.items():
            counters[k].launches += n

    counters = engine._launch_counters()
    out = {}
    return _StandInGraph(body, out), out, engine.captured_launches(counters, capture)


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(engine, "_on_card", lambda batch: True)
    monkeypatch.setattr(engine, "_side_stream_run", lambda fn: fn())


def _snapshot(state):
    opt = state.optimizer
    return {"params": {n: p.detach().clone() for n, p in state.model.named_parameters()},
            "mu": [t.clone() for t in opt.mu], "nu": [t.clone() for t in opt.nu],
            "ema": {k: t.clone() for k, t in state.ema.items()},
            "count": opt.count, "step": state.step}


def _restore(state, snap):
    opt = state.optimizer
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(snap["params"][n])
        for dst, src in ((opt.mu, snap["mu"]), (opt.nu, snap["nu"])):
            for a, b in zip(dst, src):
                a.copy_(b)
        for k, t in state.ema.items():
            t.copy_(snap["ema"][k])
    opt.count, state.step = snap["count"], snap["step"]


def _equal_states(a, b):
    return (all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
            and all(torch.equal(x, y) for k in ("mu", "nu") for x, y in zip(a[k], b[k]))
            and all(torch.equal(a["ema"][k], b["ema"][k]) for k in a["ema"])
            and (a["count"], a["step"]) == (b["count"], b["step"]))


def test_replay_path_with_a_stand_in_graph(flagship, on_card, monkeypatch):
    f = flagship
    monkeypatch.setattr(engine.TrainStep, "_capture_into", _stand_in_capture)
    step = engine.make_train_step(f.state.model, f.cfg, seed=0, device="cpu",
                                  clip_model=f.teacher)
    state = _fresh_state(f, use_ema=True)
    counters = engine._launch_counters()
    before = {k: c.launches for k, c in counters.items()}

    first = step(state, f.batch, f.text)  # the eager step, then the capture
    key = engine.train_graph_key(f.batch, f.text, ema=True)
    assert list(step.graphs) == [key] and (state.step, state.optimizer.count) == (1, 1)
    g = step.graphs[key]
    assert g.launches == {k: PER_REPLAY.get(k, 0) for k in counters}
    assert {k: c.launches for k, c in counters.items()} == before  # the capture ran nothing
    assert g.graph.replays == 0 and bool(first["finite"])
    assert all(t.grad is None for _, t in state.optimizer.trainable + state.optimizer.frozen)
    assert g.bound[0] is state.optimizer and g.bound[1] is state.ema

    snap = _snapshot(state)
    eager = step.eager(state, f.batch, f.text)
    after_eager = _snapshot(state)
    _restore(state, snap)
    replayed = step(state, f.batch, f.text)
    assert g.graph.replays == 1 and _equal_states(_snapshot(state), after_eager)
    assert set(replayed) == set(eager)
    for k, v in eager.items():
        assert torch.equal(replayed[k], v), k
        assert replayed[k] is not g.outputs[k]  # a clone: the next replay overwrites
    want = step.draws(types.SimpleNamespace(step=snap["step"]), 2)
    assert torch.equal(g.draws["fed_uniforms"], want["fed_uniforms"])
    assert all(torch.equal(g.draws["dn"][k], v) for k, v in want["dn"].items())

    step(state, f.batch, f.text)
    assert (state.step, state.optimizer.count) == (3, 3)
    assert {k: c.launches - before[k] for k, c in counters.items()} == {
        k: 2 * PER_REPLAY.get(k, 0) for k in counters}

    state.optimizer = build_optimizer(f.state.model, f.cfg, 1000)  # rebound
    with pytest.raises(RuntimeError, match="reset"):
        step(state, f.batch, f.text)
    step.reset()
    assert step.graphs == {} and step.pool_bytes == 0
    for k, c in counters.items():
        c.launches = before[k]


def test_a_failed_capture_raises_with_its_key(flagship, on_card):
    f = flagship
    step = engine.make_train_step(f.state.model, f.cfg, seed=0, device="cpu",
                                  clip_model=f.teacher)
    state = _fresh_state(f)
    key = engine.train_graph_key(f.batch, f.text, ema=False)
    with pytest.raises(RuntimeError, match="train step: CUDA graph capture failed for key") as e:
        step(state, f.batch, f.text)  # the card's capture, here without one
    assert str(key) in str(e.value)
    assert step.graphs == {} and state.step == 1  # the warm-up step landed, nothing else
    assert all(t.grad is None for _, t in state.optimizer.trainable + state.optimizer.frozen)
