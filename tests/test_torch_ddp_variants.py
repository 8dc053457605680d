"""The semantic variant's data-parallel step held against the JAX package's
step on a data-sharded mesh.

Variant A of ``tests/test_torch_variants.py`` (the five semantic-branch knobs,
``check_pos_dn``, ``OptMatcher``, the federated loss, the tiny CLIP teacher;
f32) over a global batch of two images with 5 and 3 valid GT boxes of
disjoint classes, so that the many-to-one sets' normaliser (the global valid
GT count), the CDN group count (``100 // 5``) and the federated classes (the
classes the queries of both images were assigned, united over the ranks by
``parallel/dist.py:union_``) each differ from what either image gives alone.

JAX: ``make_train_step`` on a 2-device mesh, the batch sharded over ``data``.
The port: 2 gloo ranks of one image each, with their rows of JAX's draws and
the host's global statistics. One step: every metric to 1e-5 and
``grad_norm`` to 1e-4 (``tests/test_torch_train_step.py``'s first step), the
replicas equal, one union collective a matched set with classes to unite,
and one sum of ``class_error``'s two counts (``parallel/dist.py:total_``) a
many-to-one set, so that ``class_error`` is the global batch's ratio, as JAX
takes it, and is held to 1e-5 like every other metric.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import torch

import richsem_tpu.train.optim as jax_optim
import torch_ddp_ranks as ranks
from richsem_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
from richsem_tpu_torch.parallel import dist as pdist
from tests.test_torch_clip import TINY as CLIP_TINY
from tests.test_torch_ddp_step import LIMIT, _batches
from tests.test_torch_train_step import _freeze_every_frozen_bn, _jax_draws
from tests.test_torch_variants import VARIANT_A, _pair

torch.set_num_threads(2)


def test_two_ranks_of_variant_a_track_the_jax_mesh_step():
    s = _pair(**VARIANT_A)
    cfg = s["cfg"]
    batch = _batches()[0]
    batch["size"] = np.asarray([batch["orig_size"][0]] * 2, np.float32)
    rng = jax.random.PRNGKey(11)
    draws = _jax_draws(cfg, rng, 0)
    draws_np = {"dn": {k: v.numpy() for k, v in draws["dn"].items()},
                "fed_uniforms": draws["fed_uniforms"].numpy()}
    weights = {k: v.numpy() for k, v in s["model"].state_dict().items()}
    clip_weights = {k: v.numpy() for k, v in s["clip"].state_dict().items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX
        spawned = pool.submit(pdist.spawn, ranks.variant_step, 2,
                              (cfg.to_dict(), weights, CLIP_TINY, clip_weights, batch,
                               draws_np, s["text"]), LIMIT)
        orig = jax_optim.lr_scale_tree
        jax_optim.lr_scale_tree = _freeze_every_frozen_bn(orig)
        try:
            tx = jax_optim.build_optimizer(s["params"], s["jcfg"], steps_per_epoch=2)
        finally:
            jax_optim.lr_scale_tree = orig
        mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
        state = jax_create_state(jax.tree.map(jnp.copy, s["params"]), tx)
        jax_step = jax_make_train_step(s["jax_model"], s["jcfg"], tx, clip_model=s["jax_clip"])
        with jax.set_mesh(mesh):
            state = jax.device_put(state, replicated(mesh))
            b = {k: jax.device_put(jnp.asarray(v), batch_sharding(mesh)) for k, v in batch.items()}
            _, ref = jax_step(state, b, rng, jnp.asarray(s["text"]), s["clip_params"])
        ref = {k: np.asarray(v) for k, v in ref.items()}
        r0, r1 = spawned.result()
    assert r0["digest"] == r1["digest"]
    assert r0["unions"] == r1["unions"] == cfg.dec_layers  # the final and the aux sets
    # the final, the aux and the class-agnostic interm sets
    assert r0["totals"] == r1["totals"] == cfg.dec_layers + 1
    out = r0["metrics"]
    assert set(ref) <= set(out) and bool(out["finite"]) and float(ref["loss_distill"]) > 0
    assert "class_error" in ref
    for k in ref:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=1e-6, err_msg=k)
