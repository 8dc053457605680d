"""The port's matcher and set criterion held against the JAX package: the
cost matrix and the matching, every loss term of the closed-vocabulary recipe
(final, aux, interm and DN sets, focal with the federated class sampling,
L1/GIoU, the no-gradient diagnostics), the loss-weight dict, and the
gradient of the weighted total with respect to every set's logits and boxes.

Model outputs and targets are drawn with numpy from a seed and handed to both
sides; the CDN metadata comes from both ``prepare_cdn``s on the same draws,
and the federated-loss uniforms are JAX's own: row ``i`` of the port's
``fed_uniforms`` is ``uniform(split(rng, 16)[i], (C,))``. GT labels start at
1: JAX marks appeared classes with a scatter in which every invalid slot also
writes False at class 0 (``criterion.py:68``), so whether class 0 counts as
appeared there depends on the order duplicate scatter indices are applied in.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import criterion as jcrit
from richsem_tpu.models.dn import prepare_cdn as jax_prepare_cdn
from richsem_tpu.models.matcher import match as jax_match
from richsem_tpu.models.matcher import match_cost_matrix as jax_cost
from richsem_tpu_torch.models import criterion as crit
from richsem_tpu_torch.models.dn import prepare_cdn
from richsem_tpu_torch.models.matcher import match, match_cost_matrix

torch.set_num_threads(2)

B, Q, G, C, L, DN = 2, 30, 6, 40, 3, 8
COUNTS = (4, 6)
CFG = types.SimpleNamespace(
    cls_loss_coef=1.0, bbox_loss_coef=5.0, giou_loss_coef=2.0, use_dn=True,
    aux_loss=True, dec_layers=L, two_stage_type="standard", no_interm_box_loss=False,
    interm_loss_coef=1.0, use_visual_distill=False, masks=False,
)
# f32 on both sides; the focal sums and the gathers run in another order
TOL = 1e-5


def _targets(rng):
    labels = rng.integers(1, C, (B, G)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (B, G, 2)),
                            rng.uniform(0.05, 0.4, (B, G, 2))], -1).astype(np.float32)
    valid = np.arange(G)[None, :] < np.asarray(COUNTS)[:, None]
    return labels, boxes, valid


def _set(rng, q):
    return {"pred_logits": rng.normal(size=(B, q, C)).astype(np.float32) * 2,
            "pred_boxes": (1 / (1 + np.exp(-rng.normal(size=(B, q, 4))))).astype(np.float32)}


def _outputs(rng):
    out = _set(rng, Q)
    out["aux_outputs"] = [_set(rng, Q) for _ in range(L - 1)]
    out["interm_outputs"] = _set(rng, Q)
    dn = _set(rng, 2 * DN)
    dn["aux_outputs"] = [_set(rng, 2 * DN) for _ in range(L - 1)]
    out["dn_outputs"] = dn
    return out


def _leaves(out, prefix=""):
    """Flat {path: array} of every logits/boxes array in an output tree."""
    flat = {}
    for k, v in out.items():
        if isinstance(v, dict):
            flat.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, list):
            for i, d in enumerate(v):
                flat.update(_leaves(d, f"{prefix}{k}{i}/"))
        else:
            flat[prefix + k] = v
    return flat


def _rebuild(out, flat, prefix=""):
    res = {}
    for k, v in out.items():
        if isinstance(v, dict):
            res[k] = _rebuild(v, flat, f"{prefix}{k}/")
        elif isinstance(v, list):
            res[k] = [_rebuild(d, flat, f"{prefix}{k}{i}/") for i, d in enumerate(v)]
        else:
            res[k] = flat[prefix + k]
    return res


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    labels, boxes, valid = _targets(rng)
    outputs = _outputs(rng)
    key = jax.random.PRNGKey(7)
    k_dn, k_crit = jax.random.split(key)
    dn = jax_prepare_cdn(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), k_dn,
                         dn_number=DN, num_classes=C, num_queries=Q)
    meta = jcrit.expand_dn_targets(jnp.asarray(labels), jnp.asarray(boxes),
                                   jnp.asarray(valid), dn[3], 2 * DN)
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    draws = {"flip": jax.random.uniform(k1, (B, 2 * DN)),
             "new_label": jax.random.randint(k2, (B, 2 * DN), 0, C),
             "sign": jax.random.randint(k3, (B, 2 * DN, 4), 0, 2).astype(jnp.float32) * 2 - 1,
             "part": jax.random.uniform(k4, (B, 2 * DN, 4))}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    t = {k: torch.from_numpy(v) for k, v in (("labels", labels), ("boxes", boxes),
                                              ("valid", valid))}
    t["labels"] = t["labels"].long()
    port_meta = crit.expand_dn_targets(
        t["labels"], t["boxes"], t["valid"],
        prepare_cdn(t["labels"], t["boxes"], t["valid"], draws, dn_number=DN,
                    num_queries=Q)[3])
    fed = np.stack([np.asarray(jax.random.uniform(r, (C,)))
                    for r in jax.random.split(k_crit, 16)])
    return dict(labels=labels, boxes=boxes, valid=valid, outputs=outputs, k_crit=k_crit,
                jax_meta=meta, port_meta=port_meta, fed=torch.from_numpy(fed), t=t)


def _jax_losses(c, flat):
    outputs = _rebuild(c["outputs"], flat)
    targets = {"labels": jnp.asarray(c["labels"]), "boxes": jnp.asarray(c["boxes"]),
               "valid": jnp.asarray(c["valid"])}
    losses = jcrit.set_criterion(outputs, targets, c["k_crit"], num_classes=C,
                                 use_fed_loss=True, fed_num_sample_cats=10,
                                 dn_meta=c["jax_meta"])
    return jcrit.weighted_loss(losses, jcrit.build_weight_dict(CFG)), losses


def _port_losses(c, flat):
    outputs = _rebuild(c["outputs"], flat)
    losses = crit.set_criterion(outputs, c["t"], num_classes=C, fed_uniforms=c["fed"],
                                use_fed_loss=True, fed_num_sample_cats=10,
                                dn_meta=c["port_meta"])
    return crit.weighted_loss(losses, crit.build_weight_dict(CFG)), losses


def test_weight_dict_matches_jax():
    for cfg in (CFG, types.SimpleNamespace(**{**vars(CFG), "use_dn": False,
                                               "no_interm_box_loss": True})):
        assert crit.build_weight_dict(cfg) == jcrit.build_weight_dict(cfg)


def test_cost_matrix_and_matching_match_jax(case):
    out = case["outputs"]
    args = (out["pred_logits"], out["pred_boxes"], case["labels"], case["boxes"],
            case["valid"])
    ref_cost = np.asarray(jax_cost(*map(jnp.asarray, args)))
    t_args = [torch.from_numpy(a) for a in args]
    t_args[2] = t_args[2].long()
    cost = match_cost_matrix(*t_args)
    np.testing.assert_allclose(cost.numpy(), ref_cost, rtol=1e-5, atol=1e-5)
    for kind in ("HungarianMatcher", "SimpleMinsumMatcher"):
        ref = np.asarray(jax_match(*map(jnp.asarray, args), matcher_type=kind))
        np.testing.assert_array_equal(match(*t_args, matcher_type=kind).numpy(), ref)


def test_fed_loss_classes_match_jax(case):
    matched = np.where(case["valid"], case["labels"], -1).reshape(-1)
    rng = jax.random.PRNGKey(3)
    weight = np.random.default_rng(1).uniform(0.1, 3.0, C).astype(np.float32)
    ids, mask = jcrit.fed_loss_classes(rng, jnp.asarray(matched), C, 6, jnp.asarray(weight))
    u = torch.from_numpy(np.array(jax.random.uniform(rng, (C,))))
    p_ids, p_mask = crit.fed_loss_classes(u, torch.from_numpy(matched), C, 6,
                                          torch.from_numpy(weight))
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(ids))
    np.testing.assert_array_equal(p_mask.numpy(), np.asarray(mask))


def test_losses_and_grads_match_jax(case):
    flat = _leaves(case["outputs"])
    (ref_total, ref_losses), ref_grads = jax.value_and_grad(
        lambda f: _jax_losses(case, f), has_aux=True)({k: jnp.asarray(v) for k, v in flat.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in flat.items()}
    total, losses = _port_losses(case, leaves)
    grads = torch.autograd.grad(total, list(leaves.values()))

    assert set(losses) == set(ref_losses)
    for k in ref_losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(ref_losses[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=TOL)
    for (k, _), g in zip(leaves.items(), grads, strict=True):
        r = np.asarray(ref_grads[k])
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL, atol=TOL * max(np.abs(r).max(), 1e-3),
                                   err_msg=k)
    # the diagnostics carry no gradient
    for k in ("class_error", "cardinality_error", "loss_xy", "loss_hw"):
        assert not losses[k].requires_grad


@pytest.mark.parametrize("kw", [{"distill_type": "clip_logits", "distill_aux_layers": True},
                                {"matcher_type": "OptMatcher"}])
def test_unported_branches_raise(case, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        crit.set_criterion({k: torch.from_numpy(v) for k, v in _set(np.random.default_rng(0),
                                                                     Q).items()},
                           case["t"], num_classes=C, **kw)
