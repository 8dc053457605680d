"""The port's flagship training step, with the CLIP teacher, held against the
JAX package's ``make_train_step``.

The recipe of ``configs/richsem/richsem_4scale_lvis.py`` (the CLIP-text
classifier, visual distillation with ``clip_logits`` against the teacher at
the GT boxes, CDN, the federated loss, the auction matcher, the clipped AdamW)
at the tiny width of ``tests/test_torch_train_step.py``, with the tiny CLIP of
``tests/test_torch_clip.py`` as the frozen teacher and ``distill_max_boxes``
4, so that the first image's five valid GT boxes are compacted to four. Both
sides start from one set of seeded weights, see the same batches and draws,
and run in float32:

a 3-step trajectory, held as the no-teacher one of
``tests/test_torch_train_step.py`` is: step 0 to 1e-5, later steps to 5e-2
(the 0.1 clip binds and Adam's first updates are about lr * sign).
``tests/test_torch_flagship_sep.py`` takes single steps of the same recipe
with the separable decoder sampler and the weak labels.

The text bank's row 0 is zero, so class 0 never becomes a weak label: JAX
decides whether class 0 appeared by the order of duplicate scatter indices
(ROADMAP F6).
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
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_clip import tiny_pair
from tests.test_torch_train_step import (B, CANVAS, TINY, VALID, _batches,
                                         _freeze_every_frozen_bn, _jax_draws, _np_params)

torch.set_num_threads(2)

CONFIG = "configs/richsem/richsem_4scale_lvis.py"
FLAGSHIP = dict(TINY, clip_embed_dim=16, distill_max_boxes=4)


def _with_teacher_keys(batches):
    for i, b in enumerate(batches):
        b["size"] = np.asarray([CANVAS, VALID], np.float32)
        b["is_extra"] = np.zeros(B, bool)
    return batches


def _setup(**over):
    jcfg = JaxConfig.fromfile(CONFIG)
    jcfg.update(dict(FLAGSHIP, **over))
    cfg = Config.fromfile(CONFIG)
    cfg.update(dict(FLAGSHIP, **over))
    assert cfg.use_visual_distill and cfg.distill_type == "clip_logits"
    jax_model = JaxDINO(JaxDINOConfig.from_config(jcfg))
    text = np.random.default_rng(2).normal(size=(cfg.num_classes, 16)).astype(np.float32)
    text[0] = 0.0
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64), bool), text_embed=jnp.asarray(text))
    params = jax.tree.map(jnp.asarray, _np_params(shapes, np.random.default_rng(0)))
    orig = jax_optim.lr_scale_tree
    jax_optim.lr_scale_tree = _freeze_every_frozen_bn(orig)
    try:
        tx = jax_optim.build_optimizer(params, jcfg, steps_per_epoch=2)
    finally:
        jax_optim.lr_scale_tree = orig
    jax_clip, clip_params, clip = tiny_pair(seed=5)
    clip_params = jax.tree.map(jnp.asarray, clip_params)
    return dict(jcfg=jcfg, cfg=cfg, jax_model=jax_model, params=params, tx=tx, text=text,
                jax_clip=jax_clip, clip_params=clip_params, clip=clip)


def _runs(s, batches):
    """-> per batch (JAX metrics, port metrics), both stepping one trajectory."""
    state = jax_create_state(jax.tree.map(jnp.copy, s["params"]), s["tx"])
    jax_step = jax_make_train_step(s["jax_model"], s["jcfg"], s["tx"], clip_model=s["jax_clip"])
    model, _, _ = build_model("richsem", s["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, s["params"]),
                                          expected=model.state_dict()))
    port_state = create_train_state(model, build_optimizer(model, s["cfg"], steps_per_epoch=2))
    port_step = make_train_step(model, s["cfg"], device="cpu", clip_model=s["clip"])
    rng = jax.random.PRNGKey(11)
    text = torch.from_numpy(s["text"])
    out = []
    for i, batch in enumerate(batches):
        state, m = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                            jnp.asarray(s["text"]), s["clip_params"])
        ref = {k: np.asarray(v) for k, v in m.items()}
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        t["labels"] = t["labels"].long()
        m = port_step(port_state, t, text, draws=_jax_draws(s["cfg"], rng, i))
        out.append((ref, {k: v.detach().numpy() for k, v in m.items()}))
    return out


def _check(ref, out, rtol, where):
    assert set(ref) <= set(out) and "loss_distill_dn" in out
    assert bool(out["finite"]) and bool(ref["finite"])
    assert float(ref["loss_distill"]) > 0 and float(out["loss_distill_dn"]) > 0
    for k in ref:
        tol = rtol if k != "grad_norm" or rtol > 1e-5 else 1e-4
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=1e-6, err_msg=f"{k} @ {where}")


@pytest.fixture(scope="module")
def trajectory():
    return _runs(_setup(), _with_teacher_keys(_batches()))


def test_flagship_trajectory_tracks_jax(trajectory):
    """Loss, grad norm, the distillation term and the logged loss terms, step
    by step: step 0 to 1e-5 (its grad norm to 1e-4, the convolutions' sums in
    another order), steps 1 and 2 to 5e-2."""
    for i, (ref, out) in enumerate(trajectory):
        _check(ref, out, 1e-5 if i == 0 else 5e-2, i)



def test_distillation_needs_the_teacher():
    """The flagship recipe without a teacher raises at once, naming the builder."""
    cfg = Config.fromfile(CONFIG)
    with pytest.raises(ValueError, match="build_clip_teacher"):
        make_train_step(None, cfg, device="cpu")
