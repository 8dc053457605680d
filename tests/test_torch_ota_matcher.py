"""The port's OptMatcher (simOTA, many-to-one) and its loss layout, held
against the JAX package.

* ``ota_match``: ``gt_of_query`` exactly equal to JAX's on random outputs,
  on outputs with tied costs (queries that are copies of each other: JAX's
  ``lax.top_k`` takes the lower index, and so must the port), and with an
  image without a valid GT.
* ``set_criterion`` with ``matcher_type="OptMatcher"``: every loss term and
  the gradient of the weighted total with respect to every set's logits,
  boxes and CLIP logits, to ``TOL`` (1e-5, ``test_torch_criterion.py``'s), with
  the federated loss, ``clip_logits`` distillation of the final and (with
  ``distill_aux_layers``) every aux layer, and ``enc_cls_agn``'s interm set;
  the DN sets keep their one-to-one layout. ``enc_cls_agn`` runs without the
  federated loss: its labels are all class 0, and JAX decides whether class 0
  appeared by the order in which its scatter applies the unassigned queries'
  writes of False at class 0 (ROADMAP F6); the port counts class 0 as
  appeared when a query is assigned.
* Variant A (the five semantic knobs, ``check_pos_dn``, ``OptMatcher``) as one
  train step against JAX's ``make_train_step`` (``tests/test_torch_variants.py``'s
  setup): loss terms to 1e-5, the gradient norm to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import criterion as jcrit
from richsem_tpu.models.ota_matcher import ota_match as jax_ota_match
from richsem_tpu_torch.models import criterion as crit
from richsem_tpu_torch.models.ota_matcher import ota_match
from tests.test_torch_criterion import C, CFG, TOL, _case, _leaves, _rebuild
from tests.test_torch_variants import LOSS_TOL, VARIANT_A, _one_step, _pair

torch.set_num_threads(2)


def _outputs(seed, b=2, q=40, g=7, c=30, ties=False, empty=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, q, c)).astype(np.float32) * 2
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, q, 2)),
                            rng.uniform(0.05, 0.5, (b, q, 2))], -1).astype(np.float32)
    if ties:  # the second half copies the first: every cost ties with a lower index
        logits[:, q // 2:] = logits[:, : q // 2]
        boxes[:, q // 2:] = boxes[:, : q // 2]
    labels = rng.integers(1, c, (b, g)).astype(np.int32)
    gt = np.concatenate([rng.uniform(0.25, 0.75, (b, g, 2)),
                         rng.uniform(0.1, 0.4, (b, g, 2))], -1).astype(np.float32)
    valid = np.arange(g)[None, :] < rng.integers(1, g + 1, (b, 1))
    if empty:
        valid[0] = False
    return logits, boxes, labels, gt, valid


@pytest.mark.parametrize("seed,ties,empty", [(0, False, False), (1, False, False),
                                             (2, True, False), (3, False, True)],
                         ids=["random0", "random1", "ties", "empty_image"])
def test_ota_match_matches_jax(seed, ties, empty):
    args = _outputs(seed, ties=ties, empty=empty)
    ref = np.asarray(jax.jit(jax_ota_match)(*map(jnp.asarray, args)))
    t = [torch.from_numpy(a) for a in args]
    t[2] = t[2].long()
    out = ota_match(*t).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (ref >= 0).any()
    if empty:
        assert (ref[0] == -1).all()


def _m2o_case():
    """test_torch_criterion's case with CLIP logits on every set and teacher
    targets at the GT boxes."""
    c = _case(8)
    rng = np.random.default_rng(5)
    b, g = c["labels"].shape
    n_cls = c["outputs"]["pred_logits"].shape[-1]

    def clip_logits(q):
        return (rng.normal(size=(b, q, n_cls)) * 3).astype(np.float32)

    out = c["outputs"]
    for s in [out] + out["aux_outputs"]:
        s["pred_clip_logits"] = clip_logits(s["pred_logits"].shape[1])
    out["dn_outputs"]["pred_clip_logits"] = clip_logits(out["dn_outputs"]["pred_logits"].shape[1])
    c["clip_logits"] = clip_logits(g)
    c["clip_valid"] = c["valid"] & (rng.uniform(size=(b, g)) < 0.8)
    c["jax_meta"] = jcrit.expand_dn_targets(
        jnp.asarray(c["labels"]), jnp.asarray(c["boxes"]), jnp.asarray(c["valid"]),
        c["jax_meta"], 16, gt_clip_logits=jnp.asarray(c["clip_logits"]),
        gt_clip_valid=jnp.asarray(c["clip_valid"]))
    t = c["t"]
    c["port_meta"] = crit.expand_dn_targets(
        t["labels"], t["boxes"], t["valid"], c["port_meta"],
        gt_clip_logits=torch.from_numpy(c["clip_logits"]),
        gt_clip_valid=torch.from_numpy(c["clip_valid"]))
    return c


KW = dict(matcher_type="OptMatcher", fed_num_sample_cats=10, distill_type="clip_logits",
          distill_aux_layers=True)


@pytest.mark.parametrize("fed,agn", [(True, False), (False, True)], ids=["fed", "enc_cls_agn"])
def test_m2o_losses_and_grads_match_jax(fed, agn):
    c = _m2o_case()
    kw = dict(KW, use_fed_loss=fed, enc_cls_agn=agn)
    wcfg = type(CFG)(**dict(vars(CFG), use_visual_distill=True, distill_loss_coef=0.5))
    flat = _leaves(c["outputs"])
    targets = {"labels": c["labels"], "boxes": c["boxes"], "valid": c["valid"],
               "clip_logits": c["clip_logits"], "clip_valid": c["clip_valid"]}

    def jax_total(f):
        losses = jcrit.set_criterion(_rebuild(c["outputs"], f),
                                     {k: jnp.asarray(v) for k, v in targets.items()},
                                     c["k_crit"], num_classes=C, dn_meta=c["jax_meta"], **kw)
        return jcrit.weighted_loss(losses, jcrit.build_weight_dict(wcfg)), losses

    (ref_total, ref_losses), ref_grads = jax.jit(jax.value_and_grad(jax_total, has_aux=True))(
        {k: jnp.asarray(v) for k, v in flat.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in flat.items()}
    t = dict(c["t"], clip_logits=torch.from_numpy(c["clip_logits"]),
             clip_valid=torch.from_numpy(c["clip_valid"]))
    losses = crit.set_criterion(_rebuild(c["outputs"], leaves), t, c["stats"], num_classes=C,
                                fed_uniforms=c["fed"], dn_meta=c["port_meta"], **kw)
    total = crit.weighted_loss(losses, crit.build_weight_dict(wcfg))
    grads = torch.autograd.grad(total, list(leaves.values()))
    assert set(losses) == set(ref_losses)
    assert "loss_distill_0" in losses and "loss_distill_dn" in losses
    for k in ref_losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(ref_losses[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=TOL)
    for (k, _), g in zip(leaves.items(), grads, strict=True):
        r = np.asarray(ref_grads[k])
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL * max(np.abs(r).max(), 1e-3),
                                   err_msg=k)


def test_variant_a_train_step_matches_jax():
    """Variant A: one step against JAX's jitted step, loss terms to 1e-5 and
    the gradient norm to 1e-4; the auction (K4's plain version) never runs."""
    from richsem_tpu_torch.ops import lap

    rounds = lap.batched_min_cost_assignment.rounds
    ref, out = _one_step(_pair(**VARIANT_A))
    assert lap.batched_min_cost_assignment.rounds == rounds
    assert set(ref) <= set(out) and bool(out["finite"])
    for k in ref:
        tol = 1e-4 if k == "grad_norm" else LOSS_TOL
        np.testing.assert_allclose(out[k], ref[k], rtol=tol, atol=1e-6, err_msg=k)
