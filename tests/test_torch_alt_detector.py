"""The detector with each alternative backbone, and the three memory knobs,
held against the JAX package.

A 1-layer DINO at ``__graft_entry__._tiny_cfg_dict`` widths (hidden 32, 4
heads, 1+1 layers, FFN 64, 12 queries, 8 classes, 10 CDN queries), as
``tests/test_alt_backbones.py`` builds it, with each backbone family under its
shipped variant name. The variant tables are swapped, on both sides, for
small configs of the family (``SMALL``); the full tables are compared in
``test_torch_backbones.py``. One set of weights, drawn with numpy from a seed,
goes through ``params_from_jax`` (``expected=``: every key matched), and
``lr_scale`` is held to JAX's ``lr_scale_tree`` leaf by leaf.

Tolerances are float32. Eval logits and boxes: 1e-3, as
``test_torch_dino_eval.py``. Train: the loss terms to 1e-5 and the gradients
of the backbone's leaves to 2e-3 of each leaf's largest entry, the first
step's bounds of ``test_torch_train_step.py`` (JAX's draws, from its keys);
a leaf whose gradient is below 1e-3 of the backbone's largest (the output
norms' biases, which the GroupNorm of the input projection all but cancels)
is held to 2e-3 of that floor instead. Measured: at most 2.5e-5 of a leaf's
largest, 1.1e-5 of the backbone's.

The knobs (``use_checkpoint``, ``enc_selective_remat``, ``backbone_remat``)
recompute parts of the forward in the backward; the loss and every gradient
must stay the same bit for bit, and under ``enc_selective_remat`` the
encoder's sampler must run once a layer (its output is kept, not recomputed).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cfg_dict
from richsem_tpu.models import convnext as jc
from richsem_tpu.models import focalnet as jf
from richsem_tpu.models import swin as js
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import make_loss_fn as jax_make_loss_fn
from richsem_tpu.train.optim import lr_scale_tree
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import convnext as tc
from richsem_tpu_torch.models import focalnet as tf
from richsem_tpu_torch.models import swin as ts
from richsem_tpu_torch.models.dino import DINO, DINOConfig
from richsem_tpu_torch.train.engine import make_loss_fn
from richsem_tpu_torch.train.optim import lr_scale
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

WIDTHS = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
              num_queries=12, num_classes=8, dn_labelbook_size=8)
SMALL = {  # shipped name -> (JAX config class, port config class, small fields)
    "swin_L_384_22k": (js.SwinConfig, ts.SwinConfig,
                       dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4),
                            window_size=4)),
    "convnext_xlarge_22k": (jc.ConvNeXtConfig, tc.ConvNeXtConfig,
                            dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128))),
    "focalnet_L_384_22k": (jf.FocalNetConfig, tf.FocalNetConfig,
                           dict(embed_dim=16, depths=(1, 1, 2, 1), focal_level=2)),
}
B, G, CANVAS, VALID = 2, 6, (96, 128), (64, 96)
TOL = 1e-3


@contextlib.contextmanager
def small_variants():
    """Both packages' variant tables answer every name with the small config."""
    with pytest.MonkeyPatch.context() as mp:
        for j, p, fields in SMALL.values():
            for cls in (j, p):
                mp.setattr(cls, "variant", classmethod(lambda c, name, f=fields: c(**f)))
        yield


def np_params(shapes, rng):
    """Seeded numpy weights: fan-in scaled kernels (the sampling offsets at 3x,
    as ``test_torch_dino_eval.py``), noisy norms and biases, positive BN
    variances, a layer scale near 0.5 and a position bias of 0.1."""
    def leaf(path, sds):
        names = [p.key for p in path]
        name, parent = names[-1], names[-2] if len(names) > 1 else ""
        shape = sds.shape
        if name == "kernel" or name.endswith("_kernel"):
            fan_in = shape[0] if parent in ("query", "key", "value") else np.prod(shape[:-1])
            w = rng.normal(size=shape) / np.sqrt(fan_in)
            w = w * (3.0 if parent == "sampling_offsets" else 1.0)
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, size=shape)
        elif name == "gamma":
            w = 0.5 + 0.1 * rng.normal(size=shape)
        elif name in ("bias", "mean", "rel_pos_bias"):
            w = 0.1 * rng.normal(size=shape)
        else:  # level_embed, tgt_embed
            w = rng.normal(size=shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def batch():
    rng = np.random.default_rng(1)
    h, w = CANVAS
    pad = np.ones((B, h, w), bool)
    pad[0] = False
    pad[1, :VALID[0], :VALID[1]] = False
    boxes = np.concatenate([rng.uniform(0.25, 0.75, (B, G, 2)),
                            rng.uniform(0.1, 0.4, (B, G, 2))], -1)
    return {"images": rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32),
            "pad_mask": pad,
            "labels": rng.integers(1, WIDTHS["num_classes"], (B, G)).astype(np.int32),
            "boxes": boxes.astype(np.float32),
            "valid": np.arange(G)[None, :] < np.asarray([4, 2])[:, None],
            "orig_size": np.asarray([[h, w], VALID], np.float32)}


def draws(cfg, rng):
    """The draws JAX's loss takes from ``rng`` (dn.py:88, criterion.py:489)."""
    k_dn, k_crit = jax.random.split(rng)
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    pad, c = 2 * cfg.dn_number, cfg.num_classes
    dn = {"flip": jax.random.uniform(k1, (B, pad)),
          "new_label": jax.random.randint(k2, (B, pad), 0, c),
          "sign": jax.random.randint(k3, (B, pad, 4), 0, 2).astype(jnp.float32) * 2 - 1,
          "part": jax.random.uniform(k4, (B, pad, 4))}
    fed = jnp.stack([jax.random.uniform(r, (c,)) for r in jax.random.split(k_crit, 16)])
    return {"dn": {k: torch.from_numpy(np.array(v)) for k, v in dn.items()},
            "fed_uniforms": torch.from_numpy(np.array(fed))}


def port_batch(b):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    t["labels"] = t["labels"].long()
    return t


@pytest.fixture(scope="module", params=sorted(SMALL))
def pair(request):
    """-> both models, the weights, JAX's eval and train results, at one backbone."""
    name = request.param
    with small_variants():
        jcfg = _tiny_cfg_dict(backbone=name, **WIDTHS)
        cfg = Config.from_dict(dict(jcfg))
        jmodel = JaxDINO(JaxDINOConfig.from_config(jcfg))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, *CANVAS, 3)), jnp.zeros((1, *CANVAS), bool))
        params = np_params(shapes, np.random.default_rng(0))
        model = DINO(DINOConfig.from_config(cfg), device="cpu")
        model.load_state_dict(params_from_jax(params, expected=model.state_dict()))
        b = batch()
        out = jax.jit(lambda p, x, m: jmodel.apply(p, x, m, train=False))(
            params, jnp.asarray(b["images"]), jnp.asarray(b["pad_mask"]))
        rng = jax.random.PRNGKey(11)
        loss_fn = jax_make_loss_fn(jmodel, jcfg)
        (total, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            params, {k: jnp.asarray(v) for k, v in b.items()}, rng, None, None)
    return dict(name=name, jcfg=jcfg, cfg=cfg, params=params, model=model, batch=b,
                eval={k: np.asarray(out[k]) for k in ("pred_logits", "pred_boxes")},
                total=float(total), losses={k: np.asarray(v) for k, v in losses.items()},
                grads=params_from_jax(jax.tree.map(np.asarray, grads),
                                      expected=model.state_dict()),
                draws=draws(cfg, rng))


def test_eval_forward_matches_jax(pair):
    b = port_batch(pair["batch"])
    with torch.no_grad():
        out = pair["model"](b["images"], b["pad_mask"])
    for k in ("pred_logits", "pred_boxes"):
        np.testing.assert_allclose(out[k].numpy(), pair["eval"][k], rtol=TOL, atol=TOL,
                                   err_msg=k)


def _port_loss_and_grads(model, cfg, b, d):
    model.zero_grad(set_to_none=True)
    total, losses = make_loss_fn(model, cfg)(port_batch(b), d)
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return total.detach(), losses, grads


def test_train_loss_and_backbone_gradients_match_jax(pair):
    model = pair["model"]
    total, losses, grads = _port_loss_and_grads(model, pair["cfg"], pair["batch"],
                                                pair["draws"])
    np.testing.assert_allclose(float(total), pair["total"], rtol=1e-5)
    for k, v in pair["losses"].items():
        if k in losses:
            np.testing.assert_allclose(losses[k].detach().numpy(), v, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
    backbone = [n for n in grads if n.startswith("backbone.")]
    assert len(backbone) == sum(n.startswith("backbone.") for n, _ in model.named_parameters())
    top = max(float(pair["grads"][n].abs().max()) for n in backbone)
    for n in backbone:
        ref = pair["grads"][n].numpy()
        np.testing.assert_allclose(grads[n].numpy(), ref, rtol=0,
                                   atol=2e-3 * max(np.abs(ref).max(), 1e-3 * top), err_msg=n)


def test_lr_scale_matches_jax_leaf_by_leaf(pair):
    """Every leaf's multiplier is JAX's: the backbone at lr_backbone / lr
    except what JAX freezes by name without a backbone checkpoint (ConvNeXt's
    ``stem_norm`` matches ``"stem_"``; its ``stem`` conv does not)."""
    model, cfg = pair["model"], pair["cfg"]
    scales = lr_scale_tree(pair["params"], pair["jcfg"])
    ref = params_from_jax(jax.tree.map(lambda s, p: np.full(p.shape, s, np.float32),
                                       scales, pair["params"]),
                          expected=model.state_dict())
    for name, _ in model.named_parameters():
        assert lr_scale(name, cfg) == pytest.approx(float(ref[name].reshape(-1)[0])), name
    bb = {round(lr_scale(n, cfg), 9) for n, _ in model.named_parameters()
          if n.startswith("backbone.")}
    if pair["name"].startswith("convnext"):
        assert lr_scale("backbone.stem_norm.weight", cfg) == 0.0
        assert lr_scale("backbone.stem.weight", cfg) == pytest.approx(0.1)
        assert bb == {0.0, 0.1}
    else:
        assert bb == {0.1}


KNOBS = ("use_checkpoint", "enc_selective_remat", "backbone_remat")


@pytest.mark.parametrize("knob", KNOBS)
def test_memory_knob_changes_no_number(pair, knob):
    """Loss and every gradient with the knob on equal those without, bit for
    bit, for each backbone (``backbone_remat`` acts on the ResNet only, as in
    JAX, so here it must do nothing at all)."""
    base = _port_loss_and_grads(pair["model"], pair["cfg"], pair["batch"], pair["draws"])
    cfg = Config.from_dict(dict(pair["cfg"], **{knob: True}))
    with small_variants():
        model = DINO(DINOConfig.from_config(cfg), device="cpu")
    model.load_state_dict(pair["model"].state_dict())
    total, losses, grads = _port_loss_and_grads(model, cfg, pair["batch"], pair["draws"])
    assert torch.equal(total, base[0])
    assert all(torch.equal(losses[k], base[1][k]) for k in base[1])
    assert set(grads) == set(base[2])
    assert all(torch.equal(grads[n], base[2][n]) for n in grads), knob


@pytest.fixture(scope="module")
def r50():
    """The same tiny detector on its ResNet-50, random weights from a seed."""
    cfg = Config.from_dict(dict(_tiny_cfg_dict(**WIDTHS)))
    model = DINO(DINOConfig.from_config(cfg), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return dict(cfg=cfg, model=model, batch=batch(), draws=draws(cfg, jax.random.PRNGKey(3)))


def _with_knob(r, knob):
    cfg = Config.from_dict(dict(r["cfg"], **{knob: True}))
    model = DINO(DINOConfig.from_config(cfg), device="cpu")
    model.load_state_dict(r["model"].state_dict())
    return cfg, model


@pytest.mark.parametrize("knob", KNOBS)
def test_memory_knob_on_the_resnet_changes_no_number(r50, knob):
    base = _port_loss_and_grads(r50["model"], r50["cfg"], r50["batch"], r50["draws"])
    cfg, model = _with_knob(r50, knob)
    total, losses, grads = _port_loss_and_grads(model, cfg, r50["batch"], r50["draws"])
    assert torch.equal(total, base[0])
    assert all(torch.equal(losses[k], base[1][k]) for k in base[1])
    assert set(grads) == set(base[2])
    assert all(torch.equal(grads[n], base[2][n]) for n in grads), knob


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, op):
        super().__init__()
        self.op, self.n = op, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func == self.op
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("knob,runs", [(None, 1), ("use_checkpoint", 2),
                                       ("enc_selective_remat", 1)])
def test_selective_remat_keeps_the_sampler_output(r50, knob, runs):
    """The sampler is the op ``richsem_tpu_torch::msda_out`` in every encoder
    and decoder layer. Under ``enc_selective_remat`` it runs once a layer in a
    forward and backward: the backward recomputes the encoder layer around it
    but takes its output from the forward. ``use_checkpoint`` keeps only the
    products' outputs and runs it twice a layer."""
    cfg, model = _with_knob(r50, knob) if knob else (r50["cfg"], r50["model"])
    counter = _OpCounter(torch.ops.richsem_tpu_torch.msda_out.default)
    with counter:
        total, _ = make_loss_fn(model, cfg)(port_batch(r50["batch"]), r50["draws"])
        total.backward()
    model.zero_grad(set_to_none=True)
    assert counter.n == runs * (cfg.enc_layers + cfg.dec_layers)
