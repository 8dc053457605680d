"""The port's training step held against the JAX package's ``make_train_step``.

A tiny DINO (hidden 64, 4 heads, 2+2 layers, FFN 128, 20 queries, 24 classes)
with the recipe of ``configs/richsem/dino_4scale_lvis.py``: the closed-vocabulary
classifier, 200 CDN queries, the federated loss over 8 sampled classes, the
auction matcher, AdamW with the 0.1 global-norm clip, EMA on. Both sides start
from one set of weights, drawn with numpy from a seed and converted with
``params_from_jax``, see the same batches and the same random draws (the CDN
noise and the federated-loss uniforms are taken from JAX's own keys,
``fold_in(rng, step)`` then split as ``engine.py`` splits them), and take three
steps in float32. The canvas is 128x192 and the second image's valid extent
64x128, multiples of 64, so every level has one valid ratio (ROADMAP F3).

The JAX optimizer leaves the FrozenBN tensors of the bottleneck blocks
(``bn1``-``bn3``) trainable: its freeze rule matches ``_bn/`` in the path,
which ``stem_bn`` and ``downsample_bn`` have and ``bn1`` does not
(``optim.py:44``). The reference's FrozenBatchNorm2d never trains, and
neither does the port's, so the JAX side here gets the freeze rule the
optimizer's docstring states: every FrozenBN tensor at scale 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import richsem_tpu.train.optim as jax_optim
from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import (build_optimizer, frozen_leaves, lr_scale,
                                           make_lr_schedule)
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

CONFIG = "configs/richsem/dino_4scale_lvis.py"
TINY = dict(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
            num_queries=20, num_classes=24, dn_labelbook_size=24, fed_num_sample_cats=8,
            compute_dtype="float32", use_ema=True, lr=2e-4, lr_backbone=2e-5,
            clip_max_norm=0.1)
B, G, CANVAS, VALID = 2, 8, (128, 192), (64, 128)
STEPS = 3


def _np_params(shapes, rng):
    """Seeded numpy weights for a flax tree of shapes; the kernels the flax
    init zeroes (sampling offsets, attention weights, last box layers) get
    noise too."""
    def leaf(path, sds):
        names = [p.key for p in path]
        name, parent = names[-1], names[-2] if len(names) > 1 else ""
        shape = sds.shape
        if name == "kernel" or name.endswith("_kernel"):  # cls_kernel too
            fan_in = shape[0] if parent in ("query", "key", "value") else np.prod(shape[:-1])
            w = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            w = 0.1 * rng.normal(size=shape)
        else:  # level_embed, tgt_embed
            w = rng.normal(size=shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batches():
    rng = np.random.default_rng(1)
    h, w = CANVAS
    out = []
    for _ in range(STEPS):
        pad = np.ones((B, h, w), bool)
        pad[0] = False
        pad[1, :VALID[0], :VALID[1]] = False
        counts = np.asarray([5, 3])
        valid = np.arange(G)[None, :] < counts[:, None]
        boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, G, 2)),
                                rng.uniform(0.1, 0.4, (B, G, 2))], -1)
        out.append({
            "images": rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            "pad_mask": pad,
            # labels from 1: see tests/test_torch_criterion.py on class 0
            "labels": rng.integers(1, TINY["num_classes"], (B, G)).astype(np.int32),
            "boxes": boxes.astype(np.float32), "valid": valid,
            "orig_size": np.asarray([[h, w], VALID], np.float32),
        })
    return out


def _jax_draws(cfg, rng, step):
    """The draws JAX's train step takes at ``step`` (engine.py:286, dn.py:88,
    criterion.py:489), as the port's ``draws``."""
    k_dn, k_crit = jax.random.split(jax.random.fold_in(rng, step))
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    pad, c = 2 * cfg.dn_number, cfg.num_classes
    dn = {"flip": jax.random.uniform(k1, (B, pad)),
          "new_label": jax.random.randint(k2, (B, pad), 0, c),
          "sign": jax.random.randint(k3, (B, pad, 4), 0, 2).astype(jnp.float32) * 2 - 1,
          "part": jax.random.uniform(k4, (B, pad, 4))}
    fed = jnp.stack([jax.random.uniform(r, (c,)) for r in jax.random.split(k_crit, 16)])
    return {"dn": {k: torch.from_numpy(np.array(v)) for k, v in dn.items()},
            "fed_uniforms": torch.from_numpy(np.array(fed))}


def _freeze_every_frozen_bn(lr_scale_tree):
    def fixed(params, cfg):
        def scale(path, s):
            keys = [str(getattr(k, "key", k)) for k in path]
            return 0.0 if any(k.startswith("bn") for k in keys) else s
        return jax.tree_util.tree_map_with_path(scale, lr_scale_tree(params, cfg))
    return fixed


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.fromfile(CONFIG)
    jcfg.update(TINY)
    cfg = Config.fromfile(CONFIG)
    cfg.update(TINY)
    jax_model = JaxDINO(JaxDINOConfig.from_config(jcfg))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), bool))
    params = jax.tree.map(jnp.asarray, _np_params(shapes, np.random.default_rng(0)))
    # JAX: its chain with every FrozenBN tensor at scale 0
    orig = jax_optim.lr_scale_tree
    jax_optim.lr_scale_tree = _freeze_every_frozen_bn(orig)
    try:
        tx = jax_optim.build_optimizer(params, jcfg, steps_per_epoch=2)
        scales = jax_optim.lr_scale_tree(params, jcfg)
    finally:
        jax_optim.lr_scale_tree = orig
    return dict(jcfg=jcfg, cfg=cfg, jax_model=jax_model, params=params, tx=tx,
                scales=scales)


def _port_model(setup):
    model, _, _ = build_model("richsem", setup["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, setup["params"]),
                                          expected=model.state_dict()))
    return model


@pytest.fixture(scope="module")
def trajectories(setup):
    cfg = setup["cfg"]
    # a copy: the JAX step donates its state
    state = jax_create_state(jax.tree.map(jnp.copy, setup["params"]), setup["tx"],
                             use_ema=True)
    jax_step = jax_make_train_step(setup["jax_model"], setup["jcfg"], setup["tx"])
    model = _port_model(setup)
    port_state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2),
                                    use_ema=True)
    port_step = make_train_step(model, cfg, device="cpu")

    rng = jax.random.PRNGKey(11)
    ref, out = [], []
    for i, batch in enumerate(_batches()):
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        ref.append({k: np.asarray(v) for k, v in m.items()})
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        t["labels"] = t["labels"].long()
        m = port_step(port_state, t, draws=_jax_draws(cfg, rng, i))
        out.append({k: v.detach().numpy() for k, v in m.items()})
    return dict(ref=ref, out=out, state=state, port_state=port_state, model=model)


def test_metrics_track_jax(trajectories):
    """Loss, grad norm and the logged loss terms, step by step.

    The first step starts from equal weights: its loss terms agree to 1e-5
    and its gradient norm to 1e-4 (float32, with the backbone's convolutions
    summed in another order: single gradient entries differ by up to 2e-3 of
    their leaf's largest). From then on the runs part: the 0.1 clip binds on
    every step (grad_norm is in the hundreds), so Adam's first updates are
    about lr * sign(gradient), and every gradient entry below the
    convolutions' rounding noise gets its sign, and a full lr step, at
    random. Measured drift after three steps: 2e-2 in the loss terms and the
    norm, which is the tolerance of steps 1 and 2."""
    for i, (o, r) in enumerate(zip(trajectories["out"], trajectories["ref"], strict=True)):
        assert set(o) == set(r), i
        assert bool(o["finite"]) and bool(r["finite"])
        assert float(r["grad_norm"]) > 10 * TINY["clip_max_norm"]
        for k in r:
            rtol = (1e-4 if k == "grad_norm" else 1e-5) if i == 0 else 5e-2
            np.testing.assert_allclose(o[k], r[k], rtol=rtol, atol=1e-6, err_msg=f"{k} @ {i}")


def test_parameters_and_ema_track_jax(trajectories):
    """After the steps every parameter and its EMA agree with JAX's, within
    the random sign flips the metrics test describes: no entry is further
    apart than two full steps of its group's lr a step (a wrong group scale,
    bias correction or clip breaks that bound), entries of frozen leaves are
    equal, and 80% of all entries agree to a tenth of a step."""
    state, model = trajectories["state"], trajectories["model"]
    ref = params_from_jax(jax.tree.map(np.asarray, state.params),
                          expected=model.state_dict())
    ref_ema = params_from_jax(jax.tree.map(np.asarray, state.ema_params),
                              expected=model.state_dict())
    ema = trajectories["port_state"].ema
    cfg = trajectories["port_state"].optimizer
    close = total = 0
    for name, p in model.state_dict().items():
        lr = TINY["lr"] * cfg.scales.get(name, 0.0)
        d = (p - ref[name]).abs()
        assert float(d.max()) <= 2 * STEPS * lr * 1.001 + 1e-7, name
        close += int((d <= 0.1 * lr + 1e-7).sum())
        total += d.numel()
        if name in ema:
            de = (ema[name] - ref_ema[name]).abs()
            assert float(de.max()) <= 2 * STEPS * lr * 1.001 + 1e-7, name
    assert close >= 0.8 * total, close / total


def test_optimizer_matches_the_optax_chain(setup):
    """The port's AdamW against the JAX chain on the same gradients: three
    steps of seeded gradients for every leaf (the FrozenBN buffers included),
    the first two large enough for the clip to bind, the last below it. With
    no model in between, parameters agree to float32 rounding."""
    params, tx = setup["params"], setup["tx"]
    model = _port_model(setup)
    opt = build_optimizer(model, setup["cfg"], steps_per_epoch=2)
    leaves = dict(model.named_parameters())
    leaves.update(frozen_leaves(model))
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(5)
    for scale in (1.0, 0.3, 1e-6):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * scale,
                                                   jnp.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        g = params_from_jax(jax.tree.map(np.asarray, grads), expected=model.state_dict())
        opt.zero_grad()
        for name, t in leaves.items():
            t.grad = g[name].clone()
        gnorm = opt.step()
        ref_norm = float(jax_optim.global_norm(grads))
        np.testing.assert_allclose(float(gnorm), ref_norm, rtol=1e-6)
        assert (ref_norm > TINY["clip_max_norm"]) == (scale > 1e-3)
    ref = params_from_jax(jax.tree.map(np.asarray, params), expected=model.state_dict())
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_lr_scales_match_jax_groups(setup):
    """The port's groups are JAX's (with every FrozenBN tensor frozen): the
    backbone at lr_backbone / lr, the stem and layer1 frozen, the rest 1;
    the FrozenBN tensors, buffers in the port, are frozen."""
    model, cfg = _port_model(setup), setup["cfg"]
    ref = params_from_jax(jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                                       setup["scales"], setup["params"]),
                          expected=model.state_dict())
    trainable = dict(model.named_parameters())
    assert {n for n, _ in frozen_leaves(model)} == set(ref) - set(trainable)
    for name, s in ref.items():
        want = lr_scale(name, cfg) if name in trainable else 0.0
        assert float(s.reshape(-1)[0]) == pytest.approx(want), name
    assert {lr_scale(n, cfg) for n in trainable} == {0.0, 0.1, 1.0}


@pytest.mark.parametrize("knobs", [
    {},  # StepLR at lr_drop
    {"multi_step_lr": True, "lr_drop_list": [2, 4]},
    {"onecyclelr": True, "epochs": 6},
], ids=["step", "multistep", "onecycle"])
def test_lr_schedule_matches_jax(knobs):
    jcfg = JaxConfig.fromfile(CONFIG)
    jcfg.update(dict(knobs, lr_drop=3))
    cfg = Config.fromfile(CONFIG)
    cfg.update(dict(knobs, lr_drop=3))
    ref, out = jax_optim.make_lr_schedule(jcfg, 5), make_lr_schedule(cfg, 5)
    for step in range(0, 32):
        # JAX evaluates the cosine in float32, the port in float64
        np.testing.assert_allclose(out(step), float(ref(jnp.asarray(step))), rtol=1e-5,
                                   err_msg=str(step))
