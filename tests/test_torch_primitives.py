"""The port's primitives held against the JAX package on the same numpy inputs:
box utilities, small numeric helpers, position encodings and the
deformable-transformer data flow. float32; exact where the math is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import richsem_tpu.models.transformer_utils as jtu
import richsem_tpu.ops.position_encoding as jpe
import richsem_tpu.utils.boxes as jbx
import richsem_tpu.utils.misc as jms
import richsem_tpu_torch.models.transformer_utils as ttu
import richsem_tpu_torch.ops.position_encoding as tpe
import richsem_tpu_torch.utils.boxes as tbx
import richsem_tpu_torch.utils.misc as tms
from richsem_tpu_torch.models.postprocess import postprocess

torch.set_num_threads(2)


def _close(out, ref, tol=1e-6):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def _boxes(rng, n):
    xy = rng.uniform(0, 1, (n, 2))
    wh = rng.uniform(0, 0.5, (n, 2))
    wh[0] = 0.0  # a degenerate box
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou",
                                  "box_iou_elementwise", "generalized_box_iou_elementwise"])
def test_box_ious(name):
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 9), _boxes(rng, 9)
    ref = getattr(jbx, name)(jnp.asarray(a), jnp.asarray(b))
    out = getattr(tbx, name)(torch.from_numpy(a), torch.from_numpy(b))
    ref, out = (ref, out) if name.startswith("generalized") else (ref[0], out[0])
    _close(out, ref)


def test_box_conversions_and_masks():
    rng = np.random.default_rng(1)
    b = _boxes(rng, 7)
    t = torch.from_numpy(b)
    _close(tbx.box_cxcywh_to_xyxy(t), jbx.box_cxcywh_to_xyxy(jnp.asarray(b)))
    _close(tbx.box_xyxy_to_cxcywh(t), jbx.box_xyxy_to_cxcywh(jnp.asarray(b)))
    _close(tbx.box_area(t), jbx.box_area(jnp.asarray(b)))
    masks = rng.uniform(size=(4, 12, 10)) > 0.8
    masks[1] = False  # an empty mask
    _close(tbx.masks_to_boxes(torch.from_numpy(masks)), jbx.masks_to_boxes(jnp.asarray(masks)))


def test_misc_helpers():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 16)).astype(np.float32)
    x[0] = 0.0
    _close(tms.l2_normalize(torch.from_numpy(x)), jms.l2_normalize(jnp.asarray(x)))
    p = rng.uniform(-0.1, 1.1, (50,)).astype(np.float32)
    _close(tms.inverse_sigmoid(torch.from_numpy(p)), jms.inverse_sigmoid(jnp.asarray(p)), 1e-5)
    mask = np.ones((2, 37, 53), bool)
    mask[0, :30, :41] = False
    mask[1] = False
    for hw in ((5, 7), (10, 13), (37, 53), (3, 2)):
        ref = np.asarray(jms.resize_mask(jnp.asarray(mask), hw))
        out = tms.resize_mask(torch.from_numpy(mask), hw).numpy()
        np.testing.assert_array_equal(out, ref)
        _close(tms.valid_ratios(torch.from_numpy(out)), jms.valid_ratios(jnp.asarray(ref)))


def test_position_encodings():
    mask = np.ones((2, 9, 13), bool)
    mask[0] = False
    mask[1, :6, :10] = False
    _close(tpe.sine_position_embedding(torch.from_numpy(mask), 16, 20.0, 20.0),
           jpe.sine_position_embedding(jnp.asarray(mask), 16, 20.0, 20.0), 1e-5)
    pos = np.random.default_rng(3).uniform(0, 1, (3, 5, 4)).astype(np.float32)
    for dim in (2, 4):
        _close(tpe.gen_sineembed_for_position(torch.from_numpy(pos[..., :dim]), 32),
               jpe.gen_sineembed_for_position(jnp.asarray(pos[..., :dim]), 32), 1e-5)


def test_transformer_data_flow():
    rng = np.random.default_rng(4)
    shapes = ((8, 12), (4, 6), (2, 3))
    b, c = 2, 8
    srcs = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in shapes]
    poss = [rng.normal(size=(b, h, w, c)).astype(np.float32) for h, w in shapes]
    masks = []
    for h, w in shapes:
        m = np.zeros((b, h, w), bool)
        m[1, h - h // 4:, :] = True
        m[1, :, w - w // 3:] = True
        masks.append(m)
    level_embed = rng.normal(size=(3, c)).astype(np.float32)
    ref = jtu.flatten_levels([jnp.asarray(x) for x in srcs], [jnp.asarray(m) for m in masks],
                             [jnp.asarray(x) for x in poss], jnp.asarray(level_embed))
    out = ttu.flatten_levels([torch.from_numpy(x) for x in srcs],
                             [torch.from_numpy(m) for m in masks],
                             [torch.from_numpy(x) for x in poss], torch.from_numpy(level_embed))
    for o, r in zip(out[:3], ref[:3]):
        _close(o, r)
    assert out[3] == ref[3] == shapes
    vr = np.stack([np.asarray(jms.valid_ratios(jnp.asarray(m))) for m in masks], 1)
    _close(ttu.encoder_reference_points(shapes, torch.from_numpy(vr)),
           jtu.encoder_reference_points(shapes, jnp.asarray(vr)))
    mem = rng.normal(size=(b, out[0].shape[1], c)).astype(np.float32)
    ref = jtu.gen_encoder_output_proposals(jnp.asarray(mem), ref[1], shapes)
    got = ttu.gen_encoder_output_proposals(torch.from_numpy(mem), out[1], shapes)
    for o, r in zip(got, ref):
        if o.dtype == torch.bool:
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        else:
            _close(o, r, 1e-5)


def test_postprocess_rejects_nms():
    """NMS, refused here before, is ported (held against JAX in
    tests/test_torch_nms.py): of two equal boxes the lower-scored one's score
    becomes -1."""
    logits = torch.tensor([[[2.0, -9.0], [1.0, -9.0], [-9.0, -9.0]]])
    out = postprocess(logits, torch.full((1, 3, 4), 0.5), torch.ones(1, 2),
                      num_select=2, nms_iou_threshold=0.5)
    assert out["scores"][0, 0] > 0 and float(out["scores"][0, 1]) == -1.0
