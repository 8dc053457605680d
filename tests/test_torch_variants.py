"""RichSem's recipe variants in the port, held against the JAX package.

The tiny flagship of ``tests/test_torch_flagship_train.py`` (hidden 64, 2+2
layers, 20 queries, 24 classes, the tiny CLIP teacher of
``tests/test_torch_clip.py``, whose spatial map is 256 wide) with:

* the five semantic-branch knobs (``share_vl_proj``, ``enc_cls_agn``,
  ``two_stage_cls``, ``distill_aux_layers``, ``use_clip_visual_query``) in one
  training forward, with CDN queries and a spatial map of the teacher's width:
  each knob's outputs, and every other, to 1e-3 (``test_torch_dino_eval.py``'s
  tolerance for the detector's outputs);
* the gelu encoder tail (JAX keeps flax's modules there, the port its
  composition in place of K2) and dropout: at rate 0 bit for bit the
  knob-free path, at rate 0.1 masks of that rate scaled by 1 / 0.9, and
  nothing of it in eval (JAX's masks cannot be reproduced);
* CDN's group-count branch and ``check_pos_dn`` on JAX's draws (1e-6, layouts
  exactly), ``HungarianMatcherCPU`` against JAX's callback (exactly), RoIAlign
  with a static sampling ratio (the visual queries' crop);
* variant A (the five knobs, ``check_pos_dn``, ``OptMatcher``) and variant B
  (``dn_number`` 5, gelu, ``HungarianMatcherCPU``, dropout 0): variant B's
  train step against JAX's ``make_train_step`` here (loss terms to 1e-5, the
  gradient norm to 1e-4, as ``test_torch_train_step.py``'s first step);
  variant A's in ``tests/test_torch_ota_matcher.py`` and its eval step with NMS
  in ``tests/test_torch_nms.py``.

All in float32, weights from a numpy seed, converted with ``params_from_jax``
(which must map every new leaf: ``vl_proj``, ``enc_cls_kernel``/``bias``,
``clip_query_proj``).
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
from richsem_tpu.models.dn import prepare_cdn as jax_prepare_cdn
from richsem_tpu.ops.lap import scipy_assignment_callback
from richsem_tpu.ops.roi_align import roi_align as jax_roi_align
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.models.dn import cdn_pad, prepare_cdn
from richsem_tpu_torch.models.layers import dropout
from richsem_tpu_torch.ops.lap import scipy_assignment
from richsem_tpu_torch.ops.roi_align import roi_align
from richsem_tpu_torch.train import engine
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_clip import tiny_pair
from tests.test_torch_dn import C, _jax_draws as _dn_draws, _targets
from tests.test_torch_flagship_train import CONFIG, FLAGSHIP, _with_teacher_keys
from tests.test_torch_train_step import B, _batches, _freeze_every_frozen_bn, _np_params

torch.set_num_threads(2)

SPATIAL = 256  # the tiny teacher's spatial width
KNOBS = ("share_vl_proj", "enc_cls_agn", "two_stage_cls", "distill_aux_layers",
         "use_clip_visual_query")
VARIANT_A = dict({k: True for k in KNOBS}, matcher_type="OptMatcher", check_pos_dn=True,
                 nms_iou_threshold=0.5)
VARIANT_B = dict(dn_number=5, transformer_activation="gelu", dropout=0.0,
                 matcher_type="HungarianMatcherCPU")
OUT_TOL, LOSS_TOL, DN_TOL = 1e-3, 1e-5, 1e-6


def _pair(**over):
    """JAX and port detectors of the tiny flagship with ``over``, one set of
    weights; the teacher pair; the text bank."""
    over = dict(FLAGSHIP, clip_spatial_dim=SPATIAL, **over)
    jcfg, cfg = JaxConfig.fromfile(CONFIG), Config.fromfile(CONFIG)
    jcfg.update(over)
    cfg.update(over)
    jax_model = JaxDINO(JaxDINOConfig.from_config(jcfg))
    text = np.random.default_rng(2).normal(size=(cfg.num_classes, 16)).astype(np.float32)
    text[0] = 0.0
    feats = jnp.zeros((1, 2, 2, SPATIAL)) if getattr(cfg, "use_clip_visual_query", False) else None
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64), bool), text_embed=jnp.asarray(text),
                            clip_features=feats)
    params = jax.tree.map(jnp.asarray, _np_params(shapes, np.random.default_rng(0)))
    model, _, _ = build_model("richsem", cfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          expected=model.state_dict()))
    jax_clip, clip_params, clip = tiny_pair(seed=5)
    return dict(jcfg=jcfg, cfg=cfg, jax_model=jax_model, params=params, model=model,
                text=text, jax_clip=jax_clip, clip_params=jax.tree.map(jnp.asarray, clip_params),
                clip=clip)


def _flat(out, prefix=""):
    """A nested output dict -> {path: array}."""
    items = {}
    for k, v in out.items():
        if isinstance(v, dict):
            items.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, (list, tuple)):
            for i, x in enumerate(v):
                items.update(_flat(x, f"{prefix}{k}{i}/"))
        else:
            items[prefix + k] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return items


def _dn_inputs(cfg, batch, seed=3):
    labels, boxes, valid = (jnp.asarray(batch[k]) for k in ("labels", "boxes", "valid"))
    return jax_prepare_cdn(labels, boxes, valid, jax.random.PRNGKey(seed),
                           dn_number=cfg.dn_number, num_classes=cfg.num_classes,
                           num_queries=cfg.num_queries)[:3]


@pytest.fixture(scope="module")
def knobs_forward():
    """The training forward of the tiny flagship with the five knobs on, CDN
    queries and a spatial map of the teacher's width, on both sides."""
    s = _pair(**{k: True for k in KNOBS})
    batch = _with_teacher_keys(_batches())[0]
    dn = _dn_inputs(s["cfg"], batch)
    spatial = np.random.default_rng(7).normal(size=(B, 4, 6, SPATIAL)).astype(np.float32)
    fwd = jax.jit(lambda p, im, pm, dl, db, da, t, f: s["jax_model"].apply(
        p, im, pm, dl, db, da, text_embed=t, clip_features=f, train=True))
    ref = fwd(s["params"], jnp.asarray(batch["images"]), jnp.asarray(batch["pad_mask"]), *dn,
              jnp.asarray(s["text"]), jnp.asarray(spatial))
    args = [torch.from_numpy(np.array(a)) for a in (batch["images"], batch["pad_mask"], *dn)]
    args[2] = args[2].long()
    out = s["model"](*args, text_embed=torch.from_numpy(s["text"]),
                     clip_features=torch.from_numpy(spatial), train=True)
    ref = _flat(ref)
    ref.pop("dn_pred_clip_embed", None)  # unread by the criterion; the port leaves it out
    names = {n.split(".")[0] for n, _ in s["model"].named_parameters()}
    return ref, _flat(out), names


# each knob's own outputs and parameters
KNOB_OUTPUTS = {
    "share_vl_proj": (("pred_clip_logits", "pred_logits"), "vl_proj"),
    "enc_cls_agn": (("interm_outputs/pred_logits",), "enc_cls_kernel"),
    "two_stage_cls": (("pred_logits", "aux_outputs0/pred_logits", "dn_outputs/pred_logits"), None),
    "distill_aux_layers": (("aux_outputs0/pred_clip_logits", "aux_outputs0/pred_clip_embed"),
                           None),
    "use_clip_visual_query": (("pred_boxes", "dn_outputs/pred_boxes"), "clip_query_proj"),
}


@pytest.mark.parametrize("knob", KNOBS)
def test_knob_forward_matches_jax(knobs_forward, knob):
    """Each knob's outputs (and parameters) are there and match JAX to 1e-3,
    as every other output of the same forward does."""
    ref, out, names = knobs_forward
    keys, param = KNOB_OUTPUTS[knob]
    assert set(ref) <= set(out), set(ref) - set(out)
    for k in keys:
        np.testing.assert_allclose(out[k], ref[k], rtol=OUT_TOL, atol=OUT_TOL, err_msg=k)
    if param is not None:
        assert param in names
    if knob == "share_vl_proj":
        assert not names & {"clip_visual_proj", "class_embed"}
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=OUT_TOL, atol=OUT_TOL, err_msg=k)


def test_gelu_tail_matches_jax_and_skips_k2():
    """An encoder layer with gelu: JAX's flax-module tail against the port's
    composition, to 1e-5, and the port's K2 wrapper is not called."""
    from richsem_tpu.models.dino import DeformableEncoderLayer as JaxLayer
    from richsem_tpu_torch.models import dino
    from richsem_tpu_torch.models.dino import DeformableEncoderLayer

    cfg = dino.DINOConfig(hidden_dim=32, nheads=4, dim_feedforward=64, num_feature_levels=1,
                          activation="gelu", enc_n_points=2)
    jcfg = JaxDINOConfig(hidden_dim=32, nheads=4, dim_feedforward=64, num_feature_levels=1,
                         activation="gelu", enc_n_points=2)
    rng = np.random.default_rng(4)
    h, w = 6, 8
    src = rng.normal(size=(2, h * w, 32)).astype(np.float32)
    pos = rng.normal(size=(2, h * w, 32)).astype(np.float32)
    ref_pts = rng.uniform(0.1, 0.9, (2, h * w, 1, 2)).astype(np.float32)
    shapes = np.asarray([[h, w]])
    pad = np.zeros((2, h * w), bool)
    layer = JaxLayer(jcfg)
    args = (jnp.asarray(src), jnp.asarray(pos), jnp.asarray(ref_pts), shapes, jnp.asarray(pad))
    params = jax.tree.map(jnp.asarray, _np_params(layer.init(jax.random.PRNGKey(0), *args), rng))
    ref = np.asarray(layer.apply(params, *args))
    port = DeformableEncoderLayer(cfg, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                         expected=port.state_dict()))
    called = []
    orig = dino.encoder_tail
    dino.encoder_tail = lambda *a, **k: called.append(1) or orig(*a, **k)
    try:
        with torch.no_grad():
            out = port(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    finally:
        dino.encoder_tail = orig
    assert not called
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_dropout_masks_rate_and_scale():
    """At 0.1: a share of zeros near 0.1, the rest scaled by 1 / 0.9 exactly;
    the same generator state draws the same mask; rate 0 or no generator is
    the input itself."""
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    y = dropout(x, 0.1, g)
    zero = float((y == 0).float().mean())
    assert abs(zero - 0.1) < 0.005
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1.0 / 0.9))
    g.set_state(state)
    assert torch.equal(dropout(x, 0.1, g), y)
    assert dropout(x, 0.0, g) is x and dropout(x, 0.1, None) is x


@pytest.fixture(scope="module")
def dropout_models():
    """Two tiny detectors with one set of weights: dropout 0 and 0.1."""
    out = {}
    for rate in (0.0, 0.1):
        cfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
        cfg.update(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
                   num_queries=10, num_classes=6, dn_labelbook_size=6, dropout=rate)
        model, _, _ = build_model("richsem", cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
        out[rate] = model
    return out


def _tiny_images(seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(-1, 1, (2, 64, 96, 3)).astype(np.float32)),
            torch.zeros(2, 64, 96, dtype=torch.bool))


@pytest.mark.parametrize("what", ["rate0", "eval", "train"])
def test_dropout_in_the_detector(dropout_models, what):
    """rate0: with dropout 0 a training forward given a generator equals one
    without, bit for bit; eval: at 0.1 the inference forward equals the rate-0
    model's bit for bit; train: at 0.1 a training forward needs a generator,
    one seed draws one result and another seed another."""
    images, pad = _tiny_images()
    m0, m1 = dropout_models[0.0], dropout_models[0.1]
    if what == "rate0":
        a = m0(images, pad, train=True, dropout_generator=torch.Generator().manual_seed(1))
        b = m0(images, pad, train=True)
        assert torch.equal(a["pred_logits"], b["pred_logits"])
        assert torch.equal(a["pred_boxes"], b["pred_boxes"])
    elif what == "eval":
        with torch.no_grad():
            a, b = m1(images, pad), m0(images, pad)
        assert torch.equal(a["pred_logits"], b["pred_logits"])
    else:
        with pytest.raises(ValueError, match="dropout_generator"):
            m1(images, pad, train=True)
        runs = [m1(images, pad, train=True, dropout_generator=torch.Generator().manual_seed(s))
                ["pred_logits"] for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("counts,g_slots,dn_number,check", [
    ((3, 7), 8, 5, False),  # the group-count branch: 10 groups, a pad of 160
    ((0, 0), 4, 2, False),  # no boxes: one group
    ((3, 7), 8, 5, True),  # and check_pos_dn
    ((4, 2, 5), 6, 100, True),  # check_pos_dn in the budget branch
])
def test_prepare_cdn_branches_match_jax(counts, g_slots, dn_number, check):
    """Group-count branch and ``check_pos_dn`` on JAX's draws: labels, masks and
    metadata exactly, boxes to 1e-6."""
    labels, boxes, valid = _targets(len(counts) + g_slots, counts, g_slots)
    group = dn_number < 50
    rng = jax.random.PRNGKey(dn_number + g_slots)
    ref = jax_prepare_cdn(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), rng,
                          dn_number=dn_number, num_classes=C, num_queries=11,
                          check_pos_dn=check, group_mode=group)
    pad = cdn_pad(dn_number, g_slots, group)
    assert ref[0].shape[1] == pad
    draws = {k: torch.from_numpy(np.array(v)) for k, v in _dn_draws(rng, len(counts), pad).items()}
    out = prepare_cdn(torch.from_numpy(labels).long(), torch.from_numpy(boxes),
                      torch.from_numpy(valid), draws, torch.tensor(max(counts)),
                      dn_number=dn_number, num_queries=11, check_pos_dn=check,
                      group_mode=group)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=DN_TOL, atol=DN_TOL)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    for key in ref[3]:
        np.testing.assert_array_equal(out[3][key].numpy(), np.asarray(ref[3][key]), key)


def test_check_pos_dn_moves_the_positives():
    """With JAX's draws the check halves some positives' noise: their boxes
    differ from the unchecked ones, the negatives' do not."""
    labels, boxes, valid = _targets(9, (3, 7), 8)
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in _dn_draws(jax.random.PRNGKey(1), 2, 200).items()}
    args = (torch.from_numpy(labels).long(), torch.from_numpy(boxes), torch.from_numpy(valid),
            draws, torch.tensor(7))
    a = prepare_cdn(*args, dn_number=100, num_queries=11, check_pos_dn=True)
    b = prepare_cdn(*args, dn_number=100, num_queries=11, check_pos_dn=False)
    pos = a[3]["match_gt"] >= 0
    moved = (a[1] != b[1]).any(-1)
    assert moved[pos].any() and not moved[~pos].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_hungarian_cpu_matches_jax_callback(seed):
    """SciPy on a host copy against JAX's ``pure_callback``, exactly."""
    rng = np.random.default_rng(seed)
    cost = rng.normal(size=(3, 6, 15)).astype(np.float32)
    valid = rng.uniform(size=(3, 6)) < 0.7
    valid[2] = False
    ref = np.asarray(jax.jit(scipy_assignment_callback)(jnp.asarray(cost), jnp.asarray(valid)))
    out = scipy_assignment(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_roi_align_static_ratio_matches_jax():
    """The visual queries' crop: output 1, sampling ratio 2, ``auto`` (the
    matmul path on a small map), to 1e-5."""
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 5, 7, 8)).astype(np.float32)
    xy = rng.uniform(-1, 6, (2, 9, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 4, (2, 9, 2))], -1).astype(np.float32)
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes), output_size=1))
    out = roi_align(torch.from_numpy(feats), torch.from_numpy(boxes), output_size=1,
                    sampling_ratio=2, method="auto").numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def _draws_at(cfg, rng, step, pad):
    """JAX's draws at ``step`` (as ``test_torch_train_step._jax_draws``) for a
    DN pad of ``pad`` slots."""
    k_dn, k_crit = jax.random.split(jax.random.fold_in(rng, step))
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    c = cfg.num_classes
    dn = {"flip": jax.random.uniform(k1, (B, pad)),
          "new_label": jax.random.randint(k2, (B, pad), 0, c),
          "sign": jax.random.randint(k3, (B, pad, 4), 0, 2).astype(jnp.float32) * 2 - 1,
          "part": jax.random.uniform(k4, (B, pad, 4))}
    fed = jnp.stack([jax.random.uniform(r, (c,)) for r in jax.random.split(k_crit, 16)])
    return {"dn": {k: torch.from_numpy(np.array(v)) for k, v in dn.items()},
            "fed_uniforms": torch.from_numpy(np.array(fed))}


def _one_step(s):
    """One train step of each side from the same weights, batch and draws."""
    jcfg, cfg = s["jcfg"], s["cfg"]
    orig = jax_optim.lr_scale_tree
    jax_optim.lr_scale_tree = _freeze_every_frozen_bn(orig)
    try:
        tx = jax_optim.build_optimizer(s["params"], jcfg, steps_per_epoch=2)
    finally:
        jax_optim.lr_scale_tree = orig
    state = jax_create_state(jax.tree.map(jnp.copy, s["params"]), tx)
    jax_step = jax_make_train_step(s["jax_model"], jcfg, tx, clip_model=s["jax_clip"])
    batch = _with_teacher_keys(_batches())[0]
    rng = jax.random.PRNGKey(11)
    _, ref = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                      jnp.asarray(s["text"]), s["clip_params"])
    model = s["model"]
    port_state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    step = make_train_step(model, cfg, device="cpu", clip_model=s["clip"])
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    t["labels"] = t["labels"].long()
    pad = cdn_pad(cfg.dn_number, t["labels"].shape[1], engine.dn_group_mode(cfg))
    out = step(port_state, t, torch.from_numpy(s["text"]), draws=_draws_at(cfg, rng, 0, pad))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.detach().numpy() for k, v in out.items()}


def test_variant_b_train_step_matches_jax():
    """Variant B (dropout 0) against JAX's jitted step: loss terms to 1e-5
    and the gradient norm to 1e-4 (variant A's: tests/test_torch_ota_matcher.py)."""
    ref, out = _one_step(_pair(**VARIANT_B))
    assert set(ref) <= set(out)
    assert bool(out["finite"]) and float(ref["loss_distill"]) > 0
    for k in ref:
        tol = 1e-4 if k == "grad_norm" else LOSS_TOL
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=1e-6, err_msg=k)


def test_train_step_refuses_a_graph_with_the_host_matcher(monkeypatch):
    """On the card a step with ``HungarianMatcherCPU`` raises, naming the
    matcher, before any capture: the caller takes eager steps."""
    cfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
    cfg.update(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=64,
               num_queries=10, num_classes=6, dn_labelbook_size=6,
               matcher_type="HungarianMatcherCPU")
    model, _, _ = build_model("richsem", cfg, device="cpu")
    step = make_train_step(model, cfg, device="cpu")
    monkeypatch.setattr(engine, "_on_card", lambda batch: True)
    with pytest.raises(RuntimeError, match="HungarianMatcherCPU.*eager"):
        step(None, {"labels": torch.zeros(1, 1)})
    assert not step.graphs
