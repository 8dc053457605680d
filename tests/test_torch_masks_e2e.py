"""``masks=True`` end to end: a tiny DINO with the DETRsegm head and with the
CondInst head, held against the JAX package's.

One set of seeded weights (flax tree -> ``params_from_jax``) on a 100 x 140
canvas (levels 13 x 18, 7 x 9, 4 x 5, 2 x 3: no whole ratios), the second
image padded. Compared in f32:

* the forward's mask outputs (``pred_masks``, or ``mask_feats`` and
  ``mask_params``) to 1e-5 of their largest magnitude;
* ``loss_mask`` and ``loss_dice`` from ``set_criterion`` to 1e-5, and the
  gradients of ``loss_mask + loss_dice`` on every leaf of the mask head (or of
  the controller and the mask branch) to 1e-4 of the leaf's largest; under
  CondInst the box head gets no gradient from them, since the centres are
  detached as JAX stops them;
* the eval step, which does not run the head, against JAX's eval step;
* the train step's loss with the batch's masks: the terms weighted in;
* ``OptMatcher`` raising as JAX raises; the collate's stride-8 targets
  (``tests/test_masks_e2e.py::test_collate_with_masks``) against JAX's
  collate exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.data.loader import collate as jax_collate
from richsem_tpu.data.transforms import normalize as jax_normalize
from richsem_tpu.models.criterion import set_criterion as jax_set_criterion
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import make_eval_step as jax_make_eval_step
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.data.loader import collate
from richsem_tpu_torch.data.transforms import normalize
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.models.criterion import GlobalStats, set_criterion
from richsem_tpu_torch.models.dino import DINO, DINOConfig
from richsem_tpu_torch.parallel.dist import tensor_stats
from richsem_tpu_torch.train.engine import (TRAIN_INPUTS, create_train_state, make_eval_step,
                                            make_loss_fn, make_train_step, train_graph_key)
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_train_step import _jax_draws, _np_params

torch.set_num_threads(2)

C = 6
TINY = dict(num_classes=C, dn_labelbook_size=C, hidden_dim=32, nheads=4, enc_layers=1,
            dec_layers=1, dim_feedforward=64, num_queries=10, masks=True)
B, G, CANVAS, VALID = 2, 3, (100, 140), (80, 100)
HM, WM = 13, 18  # the stride-8 level of CANVAS
HEADS = ["detr", "cond_inst"]


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    pad = np.ones((B, h, w), bool)
    pad[0] = False
    pad[1, :VALID[0], :VALID[1]] = False
    boxes = np.concatenate([rng.uniform(0.3, 0.6, (B, G, 2)), rng.uniform(0.1, 0.3, (B, G, 2))],
                           -1).astype(np.float32)
    return {"images": rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32), "pad_mask": pad,
            "labels": rng.integers(1, C, (B, G)).astype(np.int32), "boxes": boxes,
            "valid": np.asarray([[True, True, True], [True, True, False]]),
            "masks": rng.uniform(size=(B, G, HM, WM)) > 0.6,
            "orig_size": np.asarray([CANVAS, VALID], np.float32)}


def _mask_keys(head):
    return ["pred_masks"] if head == "detr" else ["mask_feats", "mask_params"]


@pytest.fixture(scope="module", params=HEADS)
def pair(request):
    kw = dict(TINY, mask_head_type=request.param)
    jax_model = JaxDINO(JaxDINOConfig(**kw))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64), bool))
    params = _np_params(shapes, np.random.default_rng(0))
    model = DINO(DINOConfig(**kw), device="cpu")
    model.load_state_dict(params_from_jax(params, expected=model.state_dict()))
    params = jax.tree.map(jnp.asarray, params)
    batch = _batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    targets = {k: jb[k] for k in ("labels", "boxes", "valid", "masks")}
    keys = ["pred_boxes"] + _mask_keys(request.param)

    def jax_loss(p):  # JAX's reference, one compile: the outputs, losses and gradients
        o = jax_model.apply(p, jb["images"], jb["pad_mask"])
        losses = jax_set_criterion(o, targets, jax.random.PRNGKey(2), num_classes=C)
        return losses["loss_mask"] + losses["loss_dice"], (losses, {k: o[k] for k in keys})

    (_, (losses, outputs)), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(params)
    return dict(head=request.param, jax_model=jax_model, model=model, params=params,
                batch=batch, ref_losses=losses, ref_outputs=outputs,
                ref_grads=params_from_jax(jax.tree.map(np.asarray, grads)))


def _close(out, ref, rel):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6))


def test_forward_mask_outputs_match_jax(pair):
    b, ref = pair["batch"], pair["ref_outputs"]
    with torch.no_grad():
        out = pair["model"](torch.from_numpy(b["images"]), torch.from_numpy(b["pad_mask"]))
    _close(out["pred_boxes"], ref["pred_boxes"], 1e-4)
    for k in _mask_keys(pair["head"]):
        assert bool(torch.isfinite(out[k]).all())
        _close(out[k], ref[k], 1e-5)
    if pair["head"] == "detr":
        assert out["pred_masks"].shape == (B, TINY["num_queries"], HM, WM)
    else:
        assert out["mask_feats"].shape == (B, HM, WM, 1)
        assert out["mask_feat_stride"] == 8  # JAX's CondInstHead's
        assert out["mask_head_layout"] == {"dy_channels": 8, "layers": 3, "rel_coord": True}


def _head_prefixes(head):
    return ("mask_attention.", "mask_head.") if head == "detr" else ("cond_inst.",)


def test_mask_losses_and_grads_match_jax(pair):
    b, head = pair["batch"], pair["head"]
    ref, ref_grads = pair["ref_losses"], pair["ref_grads"]

    model = pair["model"]
    model.zero_grad()
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    t["labels"] = t["labels"].long()
    out = model(t["images"], t["pad_mask"])
    stats = GlobalStats.of(tensor_stats(t, types.SimpleNamespace(num_classes=C, dn_number=0)))
    losses = set_criterion(out, {k: t[k] for k in ("labels", "boxes", "valid", "masks")},
                           stats, num_classes=C)
    (losses["loss_mask"] + losses["loss_dice"]).backward()
    for k in ("loss_mask", "loss_dice", "loss_ce", "loss_bbox"):
        np.testing.assert_allclose(losses[k].item(), float(ref[k]), rtol=1e-5, err_msg=k)
    named = dict(model.named_parameters())
    checked = [n for n in named if n.startswith(_head_prefixes(head))]
    assert len(checked) >= (22 if head == "detr" else 24)
    # a leaf's scale is its largest gradient, floored at 1e-3 of the head's
    # largest: a conv bias under a one-channel group norm has a zero gradient in
    # exact arithmetic, and both sides hold only rounding noise there
    floor = 1e-3 * max(ref_grads[n].abs().max().item() for n in checked)
    for n in checked:
        assert named[n].grad is not None, n
        scale = max(ref_grads[n].abs().max().item(), floor)
        np.testing.assert_allclose(named[n].grad.numpy(), ref_grads[n].numpy(), rtol=0,
                                   atol=1e-4 * scale, err_msg=n)
    if head == "cond_inst":
        # the mask loss reaches the controller (JAX's own test's check), and
        # the centres are detached: no gradient reaches the box head
        assert sum(float(named[n].grad.square().sum()) for n in checked
                   if n.startswith("cond_inst.controller.")) > 0
        for n in named:
            if n.startswith("bbox_embed."):
                assert named[n].grad is None or not named[n].grad.any(), n
                assert not ref_grads[n].any(), n


def test_eval_step_skips_the_head_and_matches_jax(pair):
    b, model = pair["batch"], pair["model"]
    cfg = types.SimpleNamespace(num_select=20, nms_iou_threshold=0.0)
    ref = jax_make_eval_step(pair["jax_model"], cfg)(
        pair["params"], {k: jnp.asarray(b[k]) for k in ("images", "pad_mask", "orig_size")})
    ran = []
    head = model.mask_head if pair["head"] == "detr" else model.cond_inst
    hook = head.register_forward_pre_hook(lambda *a: ran.append(1))
    try:
        out = make_eval_step(model, cfg)({k: torch.from_numpy(b[k]) for k in
                                          ("images", "pad_mask", "orig_size")})
    finally:
        hook.remove()
    assert not ran
    for k in ("scores", "labels", "boxes"):
        _close(out[k], ref[k], 1e-4)


def test_optmatcher_raises_as_jax(pair):
    b, model = pair["batch"], pair["model"]
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    t["labels"] = t["labels"].long()
    with torch.no_grad():
        out = model(t["images"], t["pad_mask"])
    stats = GlobalStats.of(tensor_stats(t, types.SimpleNamespace(num_classes=C, dn_number=0)))
    jo = {k: jnp.asarray(v.numpy()) for k, v in out.items() if torch.is_tensor(v)}
    targets = {k: t[k] for k in ("labels", "boxes", "valid", "masks")}
    with pytest.raises(NotImplementedError) as ref:
        jax_set_criterion(jo, {k: jnp.asarray(v.numpy()) for k, v in targets.items()},
                          jax.random.PRNGKey(0), num_classes=C, matcher_type="OptMatcher")
    with pytest.raises(NotImplementedError) as got:
        set_criterion(out, targets, stats, num_classes=C, matcher_type="OptMatcher")
    assert str(got.value) == str(ref.value)


def test_train_step_carries_the_masks():
    """The train step's loss takes the mask terms, weighted by
    ``mask_loss_coef`` and ``dice_loss_coef``, when the batch carries
    ``masks`` (CDN, the federated loss, DETRsegm; the criterion's terms are
    held to JAX above): the loss with the masks less the loss without is
    those two terms, to 1e-5; a step with them is finite; the graph's key and
    inputs hold ``masks``."""
    config = "configs/richsem/dino_4scale_lvis.py"
    cfg = Config.fromfile(config)
    cfg.update(dict(TINY, compute_dtype="float32", fed_num_sample_cats=3,
                    mask_loss_coef=2.0, dice_loss_coef=3.0))
    model, _, _ = build_model("richsem", cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    t = {k: torch.from_numpy(v) for k, v in _batch(3).items()}
    t["labels"] = t["labels"].long()
    draws = _jax_draws(cfg, jax.random.PRNGKey(11), 0)
    loss_fn = make_loss_fn(model, cfg)
    total, losses = loss_fn(t, draws)
    bare_total, bare = loss_fn({k: v for k, v in t.items() if k != "masks"}, draws)
    assert "loss_mask" in losses and "loss_mask" not in bare
    np.testing.assert_allclose(
        (total - bare_total).item(),
        (2.0 * losses["loss_mask"] + 3.0 * losses["loss_dice"]).item(), rtol=1e-5)
    assert "masks" in TRAIN_INPUTS
    key = dict((k[0], k[1:]) for k in train_graph_key(t)[1:-2])
    assert key["masks"] == ((B, G, HM, WM), torch.bool)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    out = make_train_step(model, cfg, device="cpu")(state, t, draws=draws)
    assert bool(out["finite"]) and state.step == 1


def test_collate_with_masks_matches_jax():
    rng = np.random.default_rng(0)
    recs = []
    for i, (h, w) in enumerate([(60, 80), (45, 70)]):
        rec = {"image": rng.integers(0, 255, (h, w, 3), dtype=np.uint8),
               "boxes": np.asarray([[5, 5, 30, 30], [10, 2, 40, 20]], np.float32),
               "labels": np.asarray([1, 3]), "area": np.asarray([625.0, 540.0], np.float32),
               "iscrowd": np.asarray([0, 0]), "image_id": i, "orig_size": (h, w),
               "masks": rng.uniform(size=(2, h, w)) > 0.5}
        rec["masks"][0, 5:30, 5:30] = True
        recs.append(rec)
    out = collate([normalize(r) for r in recs], [(64, 96)], max_gt=4)
    ref = jax_collate([jax_normalize(r) for r in recs], [(64, 96)], max_gt=4)
    assert out["masks"].shape == (2, 4, 8, 12)
    assert out["masks"][0, 0].any() and not out["masks"][0, 2].any()
    np.testing.assert_array_equal(out["masks"], ref["masks"])
