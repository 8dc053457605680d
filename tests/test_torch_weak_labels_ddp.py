"""The teacher's weak labels under data parallelism held against the JAX
package's step on a data-sharded mesh.

The tiny flagship of ``tests/test_torch_variants.py`` (the CLIP-text
classifier, distillation against the tiny CLIP teacher of
``tests/test_torch_clip.py``, CDN, the federated loss; f32) with
``use_imagenet_pusedo_labels`` (``clip_pusedo_th`` 0.05, ``clip_pusedo_topk``
4) over a global batch of four images with 5, 3, 4 and 2 valid GT boxes,
whose first and last are extra images: one a rank. On each extra image the
teacher rewrites the labels and boxes (every above-threshold (box, class)
pair becomes a slot), so the global valid count, the largest count, the GT
classes and the CDN layout are those of the rewritten batch, which no host
sees.

JAX: ``make_train_step`` on a 2-device mesh, the batch sharded over ``data``.
The port: 2 gloo ranks of two images each, with their rows of JAX's draws.
One step: every metric to 1e-5 and ``grad_norm`` to 1e-4 (the first step of
``tests/test_torch_train_step.py``), the replicas equal, one statistics
collective a rank (``parallel/dist.py:reduce_stats_``) whose result equals,
exactly, the statistics that the port in one process (no group) computes
from the same rewritten global batch; that process's metrics equal the
ranks' to 1e-5.
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
from richsem_tpu_torch.train import engine
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import build_optimizer
from tests.test_torch_clip import TINY as CLIP_TINY
from tests.test_torch_ddp_step import LIMIT
from tests.test_torch_train_step import CANVAS, G, TINY, VALID, _freeze_every_frozen_bn
from tests.test_torch_variants import _pair

torch.set_num_threads(2)

N = 4  # global batch: two images a rank
COUNTS = (5, 3, 4, 2)
EXTRA = (True, False, False, True)


def _batch():
    rng = np.random.default_rng(8)
    h, w = CANVAS
    pad = np.ones((N, h, w), bool)
    pad[0::2] = False
    pad[1::2, :VALID[0], :VALID[1]] = False
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (N, G, 2)),
                            rng.uniform(0.1, 0.4, (N, G, 2))], -1)
    labels = rng.integers(1, TINY["num_classes"], (N, G))
    sizes = np.asarray([[h, w], VALID] * 2, np.float32)
    return {"images": rng.uniform(-1, 1, (N, h, w, 3)).astype(np.float32),
            "pad_mask": pad, "labels": labels.astype(np.int32),
            "boxes": boxes.astype(np.float32),
            "valid": np.arange(G)[None, :] < np.asarray(COUNTS)[:, None],
            "orig_size": sizes, "size": sizes, "is_extra": np.asarray(EXTRA)}


def _draws(cfg, rng):
    """JAX's draws of a step over ``N`` images (``_jax_draws`` at batch N)."""
    k_dn, k_crit = jax.random.split(jax.random.fold_in(rng, 0))
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    pad, c = 2 * cfg.dn_number, cfg.num_classes
    dn = {"flip": jax.random.uniform(k1, (N, pad)),
          "new_label": jax.random.randint(k2, (N, pad), 0, c),
          "sign": jax.random.randint(k3, (N, pad, 4), 0, 2).astype(jnp.float32) * 2 - 1,
          "part": jax.random.uniform(k4, (N, pad, 4))}
    fed = jnp.stack([jax.random.uniform(r, (c,)) for r in jax.random.split(k_crit, 16)])
    return {"dn": {k: np.array(v) for k, v in dn.items()}, "fed_uniforms": np.array(fed)}


def _one_process(s, weights, batch, draws, monkeypatch):
    """The port in one process on the global batch -> (metrics, the statistics
    its loss read)."""
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.main import place_batch

    seen = []

    def record(b, cfg):
        out = pdist.tensor_stats(b, cfg)
        seen.append({k: v.numpy().copy() for k, v in out.items()})
        return out

    monkeypatch.setattr(engine, "tensor_stats", record)
    cfg = s["cfg"]
    model, _, _ = build_model("richsem", cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    step = make_train_step(model, cfg, device="cpu", clip_model=s["clip"])
    d = {"dn": {k: torch.from_numpy(v) for k, v in draws["dn"].items()},
         "fed_uniforms": torch.from_numpy(draws["fed_uniforms"])}
    m = step(state, place_batch(batch, "cpu"), torch.from_numpy(s["text"]), draws=d)
    return {k: v.numpy().copy() for k, v in m.items()}, seen


def test_two_ranks_with_weak_labels_track_the_jax_mesh_step(monkeypatch):
    s = _pair(use_imagenet_pusedo_labels=True, clip_pusedo_th=0.05, clip_pusedo_topk=4)
    cfg = s["cfg"]
    batch = _batch()
    rng = jax.random.PRNGKey(11)
    draws = _draws(cfg, rng)
    weights = {k: v.numpy() for k, v in s["model"].state_dict().items()}
    clip_weights = {k: v.numpy() for k, v in s["clip"].state_dict().items()}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # the ranks run beside JAX
        spawned = pool.submit(pdist.spawn, ranks.variant_step, 2,
                              (cfg.to_dict(), weights, CLIP_TINY, clip_weights, batch,
                               draws, s["text"]), LIMIT)
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
        single, single_stats = _one_process(s, weights, batch, draws, monkeypatch)
        r0, r1 = spawned.result()
    assert r0["digest"] == r1["digest"]
    assert len(r0["stats"]) == len(r1["stats"]) == 1  # one statistics collective a rank
    assert len(single_stats) == 1
    for k, v in single_stats[0].items():
        np.testing.assert_array_equal(r0["stats"][0][k], v, err_msg=k)
        np.testing.assert_array_equal(r1["stats"][0][k], v, err_msg=k)
    # the teacher rewrote the extra images: the global count is not the host's
    assert int(single_stats[0]["gt_total"]) != sum(COUNTS)
    out = r0["metrics"]
    assert set(ref) <= set(out) and bool(out["finite"]) and float(ref["loss_distill"]) > 0
    for k in ref:
        tol = 1e-4 if k == "grad_norm" else 1e-5
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=1e-6, err_msg=f"{k} vs JAX")
        np.testing.assert_allclose(single[k], out[k], rtol=tol, atol=1e-6,
                                   err_msg=f"{k}: one process vs the ranks")
