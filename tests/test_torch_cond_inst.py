"""The port's CondInst head (``richsem_tpu_torch/models/cond_inst.py``) held
against the JAX package's ``richsem_tpu/models/cond_inst.py``.

The layout and the parameter split exactly; the locations exactly; the
dynamic networks (with relative coordinates, scaled by instance sizes, and
without), the bilinear upsample, the mask branch on the levels of a 100 x 140
canvas (13 x 18, 7 x 9, 4 x 5) and the head's controller and instance masks
to 1e-5 of the largest magnitude, in f32, with the JAX weights through
``params_from_jax``; and ``tests/test_masks_e2e.py``'s case that the mask
follows the instance centre.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import cond_inst as jci
from richsem_tpu_torch.models import cond_inst as ci
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_dino_eval import _np_params
from tests.test_torch_segmentation import LEVELS, _close, _port

torch.set_num_threads(2)

D, B, K = 32, 2, 5


@pytest.mark.parametrize("cin,dy,layers,rel", [(1, 8, 3, True), (4, 8, 3, False),
                                                (8, 4, 2, True), (3, 6, 4, True)])
def test_layout_and_parse_match_jax(cin, dy, layers, rel):
    assert ci.dynamic_param_layout(cin, dy, layers, rel) == \
        jci.dynamic_param_layout(cin, dy, layers, rel)
    n = sum(sum(x) for x in jci.dynamic_param_layout(cin, dy, layers, rel))
    params = np.random.default_rng(cin).normal(size=(B, K, n)).astype(np.float32)
    ref = jci.parse_dynamic_params(jnp.asarray(params), cin, dy, layers, rel)
    out = ci.parse_dynamic_params(torch.from_numpy(params), cin, dy, layers, rel)
    assert len(out) == len(ref) == layers
    for (w, b), (jw, jb) in zip(out, ref):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_locations_match_jax():
    np.testing.assert_array_equal(ci.compute_locations(13, 18, 8).numpy(),
                                  np.asarray(jci.compute_locations(13, 18, 8)))


@pytest.mark.parametrize("rel,sizes", [(True, False), (True, True), (False, False)],
                         ids=["rel", "rel_hw", "no_rel"])
def test_dynamic_mask_logits_match_jax(rel, sizes):
    rng = np.random.default_rng(1)
    cm = 4
    feats = rng.normal(size=(B, 13, 18, cm)).astype(np.float32)
    n = sum(sum(x) for x in jci.dynamic_param_layout(cm, 8, 3, rel))
    params = (rng.normal(size=(B, K, n)) * 0.3).astype(np.float32)
    centers = rng.uniform(0, 140, size=(B, K, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, size=(B, K, 2)).astype(np.float32) if sizes else None
    ref = jci.dynamic_mask_logits(jnp.asarray(feats), jnp.asarray(params), jnp.asarray(centers),
                                  rel_coord=rel, sizes_px=None if wh is None else jnp.asarray(wh))
    out = ci.dynamic_mask_logits(torch.from_numpy(feats), torch.from_numpy(params),
                                 torch.from_numpy(centers), rel_coord=rel,
                                 sizes_px=None if wh is None else torch.from_numpy(wh))
    _close(out, ref)


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_aligned_upsample_matches_jax(factor):
    x = np.random.default_rng(factor).normal(size=(B, K, 7, 9)).astype(np.float32)
    _close(ci.aligned_upsample(torch.from_numpy(x), factor),
           jci.aligned_upsample(jnp.asarray(x), factor))


def test_rel_coords_move_mask():
    """The dynamic mask follows the instance centre (the relative coordinates)."""
    rng = np.random.default_rng(0)
    feats = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    n = (4 + 2) * 8 + 8 + 8 * 8 + 8 + 8 + 1
    params = torch.from_numpy((rng.normal(size=(1, 1, n)) * 0.3).astype(np.float32))
    m1 = ci.dynamic_mask_logits(feats, params, torch.tensor([[[8.0, 8.0]]]))
    m2 = ci.dynamic_mask_logits(feats, params, torch.tensor([[[40.0, 40.0]]]))
    assert not np.allclose(m1.numpy(), m2.numpy())


@pytest.fixture(scope="module")
def levels():
    rng = np.random.default_rng(2)
    return [rng.normal(size=(B, h, w, D)).astype(np.float32) for h, w in LEVELS], rng


def test_mask_branch_matches_jax(levels):
    srcs, rng = levels
    branch = jci.CondInstMaskBranch(4, hidden_channels=16, num_convs=2)
    params = _np_params(jax.eval_shape(branch.init, jax.random.PRNGKey(0), srcs), rng)
    ref = branch.apply(params, srcs)
    port = _port(ci.CondInstMaskBranch(D, 4, hidden_channels=16, num_convs=2, device="cpu"),
                 params)
    out = port([torch.from_numpy(s) for s in srcs])
    assert out.shape == (B,) + LEVELS[0] + (4,)
    _close(out.detach(), ref)


def test_head_matches_jax(levels):
    """The controller, the mask branch and the instance masks at predicted
    boxes; the controller's width ((Cm + 2) * 8 + 8 + 8 * 8 + 8 + 8 + 1)."""
    srcs, rng = levels
    hs = rng.normal(size=(B, K, D)).astype(np.float32)
    boxes = rng.uniform(0.1, 0.9, size=(B, K, 4)).astype(np.float32)
    head = jci.CondInstHead(D)

    def run(mod, srcs, hs, boxes):
        feats = mod.mask_features(srcs)
        params = mod.controller_params(hs)
        return feats, params, mod.instance_masks(feats, params, boxes)

    shapes = jax.eval_shape(lambda: head.init(jax.random.PRNGKey(0), srcs, hs, boxes,
                                              method=run))
    params = _np_params(shapes, rng)
    ref = head.apply(params, srcs, hs, boxes, method=run)
    port = _port(ci.CondInstHead(D, device="cpu"), params)
    assert port.num_gen_params == (1 + 2) * 8 + 8 + 8 * 8 + 8 + 8 + 1
    out = run(port, [torch.from_numpy(s) for s in srcs], torch.from_numpy(hs),
              torch.from_numpy(boxes))
    for o, r in zip(out, ref):
        _close(o.detach(), r)
