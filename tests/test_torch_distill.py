"""The port's distillation losses held against JAX ``set_criterion``: KL of the
CLIP logits on the matched queries (objectives ``gt``, ``pred``, ``pred_all``)
and on the positive DN queries, the L1 of the normalized embeddings
(``clip_l1``), each with and without ``use_fed_on_kd`` and the teacher-entropy
weight, and the gradient of the weighted total with respect to every output.

Outputs, targets and the teacher's logits are drawn with numpy from a seed
(the CDN metadata and the federated-loss uniforms as in
``tests/test_torch_criterion.py``: JAX's own draws fed to the port). One
valid GT slot has no teacher target (``clip_valid`` False), as after the
teacher's compaction.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import criterion as jcrit
from richsem_tpu.models.dn import prepare_cdn as jax_prepare_cdn
from richsem_tpu_torch.models import criterion as crit
from richsem_tpu_torch.models.dn import prepare_cdn
from tests.test_torch_criterion import B, C, DN, Q, _leaves, _outputs, _rebuild, _targets

torch.set_num_threads(2)

E = 12  # embedding width
CFG = types.SimpleNamespace(
    cls_loss_coef=1.0, bbox_loss_coef=5.0, giou_loss_coef=2.0, use_dn=True,
    aux_loss=True, dec_layers=3, two_stage_type="standard", no_interm_box_loss=False,
    interm_loss_coef=1.0, use_visual_distill=True, distill_loss_coef=0.5, masks=False,
)
TOL = 1e-5  # f32 on both sides; sums in another order


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(3)
    labels, boxes, valid = _targets(rng)
    outputs = _outputs(rng)
    outputs["pred_clip_logits"] = (rng.normal(size=(B, Q, C)) * 4).astype(np.float32)
    outputs["pred_clip_embed"] = rng.normal(size=(B, Q, E)).astype(np.float32)
    outputs["dn_outputs"]["pred_clip_logits"] = (rng.normal(size=(B, 2 * DN, C)) * 4
                                                 ).astype(np.float32)
    teacher = (rng.normal(size=(B, Q, C)) * 4).astype(np.float32)
    clip_logits = (rng.normal(size=(B, labels.shape[1], C)) * 4).astype(np.float32)
    clip_embed = _unit(rng.normal(size=(B, labels.shape[1], E)))
    clip_valid = valid.copy()
    clip_valid[1, 2] = False  # a valid slot the teacher left without a target
    key = jax.random.PRNGKey(9)
    k_dn, k_crit = jax.random.split(key)
    dn = jax_prepare_cdn(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), k_dn,
                         dn_number=DN, num_classes=C, num_queries=Q)
    jax_meta = jcrit.expand_dn_targets(
        jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), dn[3], 2 * DN,
        gt_clip_logits=jnp.asarray(clip_logits), gt_clip_valid=jnp.asarray(clip_valid))
    k1, k2, k3, k4 = jax.random.split(k_dn, 4)
    draws = {"flip": jax.random.uniform(k1, (B, 2 * DN)),
             "new_label": jax.random.randint(k2, (B, 2 * DN), 0, C),
             "sign": jax.random.randint(k3, (B, 2 * DN, 4), 0, 2).astype(jnp.float32) * 2 - 1,
             "part": jax.random.uniform(k4, (B, 2 * DN, 4))}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    t = {k: torch.from_numpy(v) for k, v in (
        ("labels", labels), ("boxes", boxes), ("valid", valid), ("clip_logits", clip_logits),
        ("clip_embed", clip_embed), ("clip_valid", clip_valid))}
    t["labels"] = t["labels"].long()
    port_meta = crit.expand_dn_targets(
        t["labels"], t["boxes"], t["valid"],
        prepare_cdn(t["labels"], t["boxes"], t["valid"], draws, dn_number=DN,
                    num_queries=Q)[3],
        gt_clip_logits=t["clip_logits"], gt_clip_valid=t["clip_valid"])
    fed = np.stack([np.asarray(jax.random.uniform(r, (C,)))
                    for r in jax.random.split(k_crit, 16)])
    return dict(targets={k: v.numpy() for k, v in t.items()}, t=t, outputs=outputs,
                teacher=teacher, k_crit=k_crit, jax_meta=jax_meta, port_meta=port_meta,
                fed=torch.from_numpy(fed))


def test_expand_dn_targets_carry_the_teacher(case):
    for k in ("pos_clip_logits", "pos_clip_valid", "pos_valid"):
        np.testing.assert_array_equal(case["port_meta"][k].numpy(),
                                      np.asarray(case["jax_meta"][k]), err_msg=k)
    assert (case["port_meta"]["pos_valid"] & ~case["port_meta"]["pos_clip_valid"]).any()


KNOBS = {
    "gt": dict(distill_type="clip_logits", clip_distill_objective="gt"),
    "gt_fed_on_kd": dict(distill_type="clip_logits", clip_distill_objective="gt",
                         use_fed_on_kd=True),
    "gt_dynamic": dict(distill_type="clip_logits", clip_distill_objective="gt",
                       use_dynamic_distill_weight=True, use_fed_on_kd=True),
    "pred": dict(distill_type="clip_logits", clip_distill_objective="pred",
                 use_fed_on_kd=True),
    "pred_all": dict(distill_type="clip_logits", clip_distill_objective="pred_all",
                     use_dynamic_distill_weight=True),
    "clip_l1": dict(distill_type="clip_l1"),
}


@pytest.mark.parametrize("name", list(KNOBS))
def test_distill_losses_and_grads_match_jax(case, name):
    knobs = KNOBS[name]
    flat = _leaves(case["outputs"])

    def jax_total(f):
        outputs = dict(_rebuild(case["outputs"], f), teacher_clip_logits=case["teacher"])
        targets = {k: jnp.asarray(v) for k, v in case["targets"].items()}
        losses = jcrit.set_criterion(outputs, targets, case["k_crit"], num_classes=C,
                                     use_fed_loss=True, fed_num_sample_cats=10,
                                     dn_meta=case["jax_meta"], **knobs)
        return jcrit.weighted_loss(losses, jcrit.build_weight_dict(CFG)), losses

    (ref_total, ref_losses), ref_grads = jax.value_and_grad(jax_total, has_aux=True)(
        {k: jnp.asarray(v) for k, v in flat.items()})
    leaves = {k: torch.from_numpy(v).requires_grad_() for k, v in flat.items()}
    outputs = dict(_rebuild(case["outputs"], leaves),
                   teacher_clip_logits=torch.from_numpy(case["teacher"]))
    losses = crit.set_criterion(outputs, case["t"], num_classes=C, fed_uniforms=case["fed"],
                                use_fed_loss=True, fed_num_sample_cats=10,
                                dn_meta=case["port_meta"], **knobs)
    total = crit.weighted_loss(losses, crit.build_weight_dict(CFG))
    grads = torch.autograd.grad(total, list(leaves.values()), allow_unused=True)

    assert set(losses) == set(ref_losses)
    want_dn = knobs["distill_type"] == "clip_logits"
    assert ("loss_distill_dn" in losses) == want_dn and float(losses["loss_distill"].detach()) > 0
    for k in ref_losses:
        np.testing.assert_allclose(losses[k].detach().numpy(), np.asarray(ref_losses[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=TOL)
    for (k, _), g in zip(leaves.items(), grads, strict=True):
        r = np.asarray(ref_grads[k])
        g = np.zeros_like(r) if g is None else g.numpy()
        np.testing.assert_allclose(g, r, rtol=TOL, atol=TOL * max(np.abs(r).max(), 1e-3),
                                   err_msg=k)
