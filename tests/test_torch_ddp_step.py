"""The data-parallel train step (``richsem_tpu_torch/parallel/dist.py``,
``train/engine.py:TrainStep``) held against the JAX package's step on a
data-sharded mesh.

The tiny recipe of ``tests/test_torch_train_step.py`` (hidden 64, 2+2 layers,
200 CDN queries, the federated loss, EMA, f32) over a global batch of two
images on one 128x192 canvas. The images hold 5 and 3 valid GT boxes with
disjoint classes, so the global box count, the CDN group count (100 // 5, not
100 // 3) and the federated classes each differ from what either image gives
alone. Three steps:

* JAX: ``make_train_step`` on a 2-device mesh (``make_mesh(data=2)``), the
  batch sharded over ``data`` and the state replicated, with its own draws.
* The port: 2 gloo ranks of one image each (``parallel/dist.py:spawn``),
  each with its rows of the same draws and the host's global statistics.
* The port in one process on the stacked batch, with no process group.

The rule under test: the mean over the ranks of their losses equals the loss
of the global batch term by term, and the update uses the gradient of that
mean (one all-reduce a step that averages the gradients and the metrics).
The tolerances are those of ``tests/test_torch_train_step.py``: step 0 to
1e-5 (1e-4 for ``grad_norm``), later steps to 5e-2, atol 1e-6; parameters
and EMA within two lr steps of their group and 80% within a tenth of one;
AdamW's moments to 5e-2 and 1e-6 on 99% of their entries (``_check_state``).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_ranks as ranks
from richsem_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.parallel import dist as pdist
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.main import place_batch
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_train_step import CANVAS, STEPS, TINY, VALID, _jax_draws, setup  # noqa: F401

torch.set_num_threads(2)
G = 8
LIMIT = 240  # seconds a spawned set of ranks may take


def _batches():
    """Global batches of 2: image 0 with 5 valid boxes of classes 1-11, image 1
    with 3 of classes 12-23."""
    rng = np.random.default_rng(4)
    h, w = CANVAS
    out = []
    for _ in range(STEPS):
        pad = np.ones((2, h, w), bool)
        pad[0] = False
        pad[1, :VALID[0], :VALID[1]] = False
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (2, G, 2)),
                                rng.uniform(0.1, 0.4, (2, G, 2))], -1)
        labels = np.stack([rng.integers(1, 12, G), rng.integers(12, TINY["num_classes"], G)])
        out.append({
            "images": rng.uniform(-1, 1, (2, h, w, 3)).astype(np.float32),
            "pad_mask": pad, "labels": labels.astype(np.int32),
            "boxes": boxes.astype(np.float32),
            "valid": np.arange(G)[None, :] < np.asarray([5, 3])[:, None],
            "orig_size": np.asarray([[h, w], VALID], np.float32),
        })
    return out


def _adam_moments(opt_state):
    """(mu, nu) of the chain's ScaleByAdamState."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu") and hasattr(leaf, "nu"):
            return leaf.mu, leaf.nu
    raise AssertionError("no Adam state in the JAX optimizer state")


def _port_single(setup, weights, batches, draws=None, stats=False):
    """The port in one process on the stacked batches -> (metrics, state)."""
    cfg = setup["cfg"]
    model, _, _ = build_model("richsem", cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2),
                               use_ema=True)
    step = make_train_step(model, cfg, device="cpu")
    out = []
    for i, gb in enumerate(batches):
        b = dict(gb, **pdist.batch_stats(gb, cfg)) if stats else gb
        d = None if draws is None else {"dn": {k: torch.from_numpy(np.asarray(v))
                                               for k, v in draws[i]["dn"].items()},
                                        "fed_uniforms": torch.from_numpy(
                                            np.asarray(draws[i]["fed_uniforms"]))}
        m = step(state, place_batch(b, "cpu"), draws=d)
        out.append({k: v.numpy().copy() for k, v in m.items()})
    return out, ranks.state_arrays(state), ranks.state_digest(state)


@pytest.fixture(scope="module")
def runs(setup):
    cfg = setup["cfg"]
    batches = _batches()
    rng = jax.random.PRNGKey(11)
    draws = [_jax_draws(cfg, rng, i) for i in range(STEPS)]
    draws_np = [{"dn": {k: v.numpy() for k, v in dr["dn"].items()},
                 "fed_uniforms": dr["fed_uniforms"].numpy()} for dr in draws]
    model, _, _ = build_model("richsem", cfg, device="cpu")
    weights = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, setup["params"]), expected=model.state_dict()).items()}
    del model
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX
        spawned = pool.submit(pdist.spawn, ranks.train_steps, 2,
                              (cfg.to_dict(), weights, batches, draws_np), LIMIT)

        mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
        state = jax_create_state(jax.tree.map(jnp.copy, setup["params"]), setup["tx"],
                                 use_ema=True)
        jax_step = jax_make_train_step(setup["jax_model"], setup["jcfg"], setup["tx"])
        ref = []
        with jax.set_mesh(mesh):
            state = jax.device_put(state, replicated(mesh))
            for gb in batches:
                b = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh))
                     for k, v in gb.items()}
                state, m = jax_step(state, b, rng)
                ref.append({k: np.asarray(v) for k, v in m.items()})
        mu, nu = _adam_moments(state.opt_state)
        expected = {n: p for n, p in weights.items()}

        def conv(tree):
            return {k: v.numpy() for k, v in params_from_jax(
                jax.tree.map(np.asarray, tree), expected={
                    n: torch.from_numpy(v) for n, v in expected.items()}).items()}

        jax_state = {"params": conv(state.params), "ema": conv(state.ema_params),
                     "mu": conv(mu), "nu": conv(nu)}
        single_jax = _port_single(setup, weights, batches, draws=draws_np)
        single_own = _port_single(setup, weights, batches)
        single_stats = _port_single(setup, weights, batches, stats=True)
        rank_out = spawned.result()
    return dict(ref=ref, jax_state=jax_state, single_jax=single_jax, single_own=single_own,
                single_stats=single_stats, ranks=rank_out, setup=setup)


def _check_metrics(out, ref, what):
    for i, (o, r) in enumerate(zip(out, ref, strict=True)):
        assert set(o) == set(r), (what, i)
        assert bool(o["finite"]) and bool(r["finite"])
        for k in r:
            rtol = (1e-4 if k == "grad_norm" else 1e-5) if i == 0 else 5e-2
            np.testing.assert_allclose(o[k], r[k], rtol=rtol, atol=1e-6,
                                       err_msg=f"{what}: {k} @ {i}")


# the share of AdamW's moment entries allowed outside the tolerance. Readings on
# the CPU, 24,865,016 entries each of mu and nu: none against the JAX mesh step
# and none against one process with JAX's draws; with the step's own draws, 54
# of mu (2.17e-6) and none of nu.
MOMENTS_APART = 1e-5


def _check_state(out, ref, scales, what):
    """Parameters and EMA as ``test_parameters_and_ema_track_jax`` holds them
    (no entry further apart than two lr steps of its group, 80% of the
    parameters within a tenth of one); AdamW's moments to the later steps'
    tolerance, rtol 5e-2 and atol 1e-6, but for a share ``MOMENTS_APART`` of
    their entries: an entry whose gradient sits at the rounding noise takes
    either sign, a full lr step, and its own later gradients, which is the
    parting that the metrics test of ``tests/test_torch_train_step.py``
    describes."""
    lr = TINY["lr"]
    close = total = 0
    for part in ("params", "ema"):
        for name, p in out[part].items():
            step_lr = lr * scales.get(name, 0.0)
            d = np.abs(p - ref[part][name])
            assert float(d.max()) <= 2 * STEPS * step_lr * 1.001 + 1e-7, (what, part, name)
            if part == "params":
                close += int((d <= 0.1 * step_lr + 1e-7).sum())
                total += d.size
    assert close >= 0.8 * total, (what, close / total)
    for part in ("mu", "nu"):
        close = total = 0
        for name, m in out[part].items():
            r = ref[part][name]
            close += int(np.isclose(m, r, rtol=5e-2, atol=1e-6).sum())
            total += m.size
        assert close >= (1 - MOMENTS_APART) * total, (what, part, 1 - close / total)


def test_two_ranks_track_the_jax_mesh_step(runs):
    """Two gloo ranks with JAX's draws against JAX's step on a 2-device mesh:
    metrics (the loss and its terms averaged over the ranks, the global
    ``grad_norm``), parameters, EMA and AdamW's moments."""
    r0, r1 = runs["ranks"]
    assert r0["jax"]["digest"] == r1["jax"]["digest"]  # the replicas do not drift
    for a, b in zip(r0["jax"]["metrics"], r1["jax"]["metrics"]):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    assert float(runs["ref"][0]["grad_norm"]) > 10 * TINY["clip_max_norm"]
    _check_metrics(r0["jax"]["metrics"], runs["ref"], "2 ranks vs JAX mesh")
    scales = {n: s for n, s in _scales(runs["setup"]).items()}
    _check_state(r0["jax"]["state"], runs["jax_state"], scales, "2 ranks vs JAX mesh")


def _scales(setup):
    model, _, _ = build_model("richsem", setup["cfg"], device="cpu")
    return build_optimizer(model, setup["cfg"]).scales


def test_two_ranks_track_one_process_on_the_stacked_batch(runs):
    """Two ranks against the port in one process on the stacked batch: with
    JAX's draws, and with the step's own generator (the ranks keep their rows
    of the global batch's draws). One process with the host's statistics in
    the batch and no process group equals one process without them, bit for
    bit: the world-size-1 path reads the same fields."""
    r0, _ = runs["ranks"]
    scales = _scales(runs["setup"])
    for name, single in (("jax", runs["single_jax"]), ("own", runs["single_own"])):
        _check_metrics(r0[name]["metrics"], single[0], f"2 ranks vs 1 process ({name} draws)")
        _check_state(r0[name]["state"], single[1], scales, f"2 ranks vs 1 process ({name})")
    _check_metrics(runs["single_jax"][0], runs["ref"], "1 process vs JAX mesh")
    (m_plain, _, dig_plain), (m_stats, _, dig_stats) = runs["single_own"], runs["single_stats"]
    assert dig_plain == dig_stats
    for a, b in zip(m_plain, m_stats):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_the_collective_holds_every_gradient_and_the_metrics(runs):
    """The averaged buffer holds every leaf the optimizer's norm reads, the
    FrozenBN buffers included, and the step's metrics: its bytes are theirs."""
    model, _, _ = build_model("richsem", runs["setup"]["cfg"], device="cpu")
    opt = build_optimizer(model, runs["setup"]["cfg"])
    n = sum(t.numel() for t in opt.leaves())
    assert any(name.endswith("running_var") for name, _ in opt.frozen)
    metrics = len(runs["ranks"][0]["own"]["metrics"][0]) - 2  # not grad_norm, finite
    assert runs["ranks"][0]["own"]["reduce_bytes"] == 4 * (n + metrics)


def test_warm_up_and_replay_issue_one_collective_a_step(setup):
    """A rank that warms up and captures a new graph in a step issues one
    gradient collective, as a rank that replays does (the card's path played
    on the CPU with a stand-in graph): step 1 is a warm-up on both ranks,
    step 2 a warm-up on rank 0 (a new canvas) and a replay on rank 1, step 3
    a replay on both. No rank waits, and the replicas stay equal."""
    canvases = [[(64, 96), (64, 96)], [(96, 64), (64, 96)], [(96, 64), (64, 96)]]
    small = dict(setup["cfg"].to_dict(), use_ema=False)
    r0, r1 = pdist.spawn(ranks.collective_count, 2, (small, canvases), LIMIT)
    assert [s["warm_up"] for s in r0["steps"]] == [True, True, False]
    assert [s["warm_up"] for s in r1["steps"]] == [True, False, False]
    assert [s["collectives"] for s in r0["steps"]] == [1, 1, 1]
    assert [s["collectives"] for s in r1["steps"]] == [1, 1, 1]
    assert r0["digest"] == r1["digest"]
