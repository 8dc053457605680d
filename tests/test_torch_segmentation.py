"""The port's DETRsegm head (``richsem_tpu_torch/models/segmentation.py``) held
against the JAX package's ``richsem_tpu/models/segmentation.py``.

Every case of ``tests/test_segmentation.py`` runs on the port, and each module
and loss runs beside its JAX counterpart on the same seeded numpy inputs, the
JAX weights going through ``params_from_jax``. The levels are those of a
100 x 140 canvas (C3 13 x 18, C4 7 x 9, C5 4 x 5), whose ratios are not whole,
so that a nearest resize with other pixel centres would show (JAX's
``"nearest"`` samples at half-pixel centres). Tolerances: f32 modules 1e-5
relative to the largest magnitude; the losses 1e-5 relative; the nearest
resize exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import segmentation as jseg
from richsem_tpu_torch.models import segmentation as seg
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_dino_eval import _np_params

torch.set_num_threads(2)

D, HEADS, B, Q = 32, 4, 2, 6
LEVELS = ((13, 18), (7, 9), (4, 5))  # C3, C4, C5 of a 100 x 140 canvas
REL = 1e-5


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-6))


def _port(module, flax_params):
    module.load_state_dict(params_from_jax(flax_params, expected=module.state_dict()))
    return module


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    c3, c4, c5 = (rng.normal(size=(B, h, w, D)).astype(np.float32) for h, w in LEVELS)
    q = rng.normal(size=(B, Q, D)).astype(np.float32)
    pad = np.zeros((B,) + LEVELS[2], bool)
    pad[1, :, 3:] = True
    return {"c3": c3, "c4": c4, "c5": c5, "q": q, "pad": pad, "rng": rng}


# ---- the cases of tests/test_segmentation.py, on the port -------------------
def test_attention_map_softmax():
    mod = seg.MHAttentionMap(32, 4, device="cpu")
    mod.init_weights(torch.Generator().manual_seed(0))
    attn = mod(torch.zeros(1, 5, 32), torch.zeros(1, 6, 8, 32))
    assert attn.shape == (1, 5, 4, 6, 8)
    np.testing.assert_allclose(attn.sum(dim=(-2, -1)).detach().numpy(), 1.0, rtol=1e-5)


def test_attention_map_pad_mask():
    mod = seg.MHAttentionMap(16, 2, device="cpu")
    mod.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 3, 16)).astype(np.float32))
    f = torch.from_numpy(rng.normal(size=(1, 4, 4, 16)).astype(np.float32))
    pad = torch.zeros(1, 4, 4, dtype=torch.bool)
    pad[:, :, 2:] = True
    attn = mod(q, f, pad).detach().numpy()
    assert attn[..., 2:].max() < 1e-6  # padded columns get no attention


def test_mask_head_shapes():
    head = seg.MaskHeadSmallConv(32, 4, device="cpu")
    head.init_weights(torch.Generator().manual_seed(0))
    out = head(torch.zeros(1, 5, 4, 4, 6), torch.zeros(1, 4, 6, 32),
               torch.zeros(1, 8, 12, 32), torch.zeros(1, 16, 24, 32))
    assert out.shape == (1, 5, 16, 24)
    assert bool(torch.isfinite(out).all())


def test_dice_and_focal_perfect():
    t = torch.from_numpy(np.random.default_rng(0).uniform(size=(3, 8, 8)) > 0.5)
    logits = torch.where(t, 20.0, -20.0)
    valid = torch.ones(3, dtype=torch.bool)
    assert float(seg.dice_loss(logits, t, valid, 3.0)) < 0.02
    assert float(seg.mask_focal_loss(logits, t, valid, 3.0)) < 1e-6


def test_loss_masks_matched():
    b, q, g, hm, wm = 1, 6, 2, 8, 8
    rng = np.random.default_rng(1)
    gt = torch.from_numpy(rng.uniform(size=(b, g, hm, wm)) > 0.5)
    pred = torch.full((b, q, hm, wm), -20.0)
    pred[0, 2] = torch.where(gt[0, 0], 20.0, -20.0)
    pred[0, 4] = torch.where(gt[0, 1], 20.0, -20.0)
    out = seg.loss_masks(pred, torch.tensor([[2, 4]]), gt, torch.ones(b, g, dtype=torch.bool),
                         torch.tensor(2.0))
    assert float(out["loss_mask"]) < 1e-6
    assert float(out["loss_dice"]) < 0.02


def test_postprocess_segm():
    logits = torch.full((1, 3, 4, 6), -5.0)
    logits[0, 0, 1, 1] = 5.0
    masks = seg.postprocess_segm(logits, torch.tensor([[60, 90]]), (32, 48))
    assert masks.shape == (1, 3, 32, 48)
    assert bool(masks[0, 0].any()) and not bool(masks[0, 1].any())


# ---- against the JAX modules -------------------------------------------------
def test_attention_map_matches_jax(feats):
    mod = jseg.MHAttentionMap(D, HEADS)
    params = _np_params(jax.eval_shape(mod.init, jax.random.PRNGKey(0), feats["q"],
                                       feats["c5"]), feats["rng"])
    ref = mod.apply(params, feats["q"], feats["c5"], feats["pad"])
    port = _port(seg.MHAttentionMap(D, HEADS, device="cpu"), params)
    out = port(*(torch.from_numpy(feats[k]) for k in ("q", "c5", "pad")))
    _close(out.detach(), ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mask_head_matches_jax(feats, dtype):
    """f32 levels, and bf16 levels (the detector's bf16 projections): both sides
    compute in the f32 of the parameters."""
    rng = feats["rng"]
    attn = rng.dirichlet(np.ones(20), size=(B, Q, HEADS)).reshape(B, Q, HEADS, *LEVELS[2])
    attn = attn.astype(np.float32)
    levels = [jnp.asarray(feats[k], getattr(jnp, dtype)) for k in ("c5", "c4", "c3")]
    head = jseg.MaskHeadSmallConv(D, HEADS)
    params = _np_params(jax.eval_shape(head.init, jax.random.PRNGKey(0), attn, *levels), rng)
    ref = head.apply(params, attn, *levels)
    assert ref.dtype == jnp.float32
    port = _port(seg.MaskHeadSmallConv(D, HEADS, device="cpu"), params)
    out = port(torch.from_numpy(attn),
               *(torch.from_numpy(feats[k]).to(getattr(torch, dtype)) for k in ("c5", "c4", "c3")))
    assert out.dtype == torch.float32 and out.shape == (B, Q) + LEVELS[0]
    _close(out.detach(), ref)


@pytest.mark.parametrize("src,dst", [(4, 7), (7, 13), (13, 100), (5, 9), (9, 5), (3, 3), (1, 4)])
def test_nearest_resize_matches_jax_exactly(src, dst):
    x = np.random.default_rng(src * 100 + dst).normal(size=(2, src, src + 2, 3))
    x = x.astype(np.float32)
    ref = np.asarray(jax.image.resize(x, (2, dst, dst + 1, 3), "nearest"))
    out = seg.upsample_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), (dst, dst + 1))
    np.testing.assert_array_equal(out.permute(0, 2, 3, 1).numpy(), ref)


def test_bilinear_upsample_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 3, 13, 18)).astype(np.float32)
    ref = jax.image.resize(x, (2, 3, 100, 144), "bilinear")
    _close(seg.upsample_bilinear(torch.from_numpy(x), (100, 144)), ref)


@pytest.fixture(scope="module")
def loss_case():
    rng = np.random.default_rng(5)
    g, hm, wm = 4, *LEVELS[0]
    pred = (rng.normal(size=(B, Q, hm, wm)) * 3).astype(np.float32)
    gt = rng.uniform(size=(B, g, hm, wm)) > 0.6
    col = np.asarray([[3, -1, 0, 5], [1, 2, -1, 4]], np.int32)
    valid = np.asarray([[True, True, True, False], [True, True, True, True]])
    return pred, gt, col, valid


def test_mask_losses_match_jax(loss_case):
    pred, gt, col, valid = loss_case
    ref = jseg.loss_masks(jnp.asarray(pred), jnp.asarray(col), jnp.asarray(gt),
                          jnp.asarray(valid), jnp.float32(5.0))
    out = seg.loss_masks(torch.from_numpy(pred), torch.from_numpy(col).long(),
                         torch.from_numpy(gt), torch.from_numpy(valid), torch.tensor(5.0))
    assert set(out) == set(ref) == {"loss_mask", "loss_dice"}
    for k in ref:
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=REL)
    flat = pred.reshape(-1, *pred.shape[2:])[:4]
    m = np.asarray([True, False, True, True])
    tgt = gt.reshape(-1, *gt.shape[2:])[:4]
    for jfn, fn in ((jseg.dice_loss, seg.dice_loss), (jseg.mask_focal_loss, seg.mask_focal_loss)):
        r = jfn(jnp.asarray(flat), jnp.asarray(tgt), jnp.asarray(m), 3.0)
        o = fn(torch.from_numpy(flat), torch.from_numpy(tgt), torch.from_numpy(m), 3.0)
        np.testing.assert_allclose(float(o), float(r), rtol=REL)


def test_postprocess_segm_matches_jax(loss_case):
    pred = loss_case[0]
    ref = np.asarray(jseg.postprocess_segm(jnp.asarray(pred), jnp.asarray([[60, 90]] * B),
                                           (104, 144)))
    out = seg.postprocess_segm(torch.from_numpy(pred), torch.tensor([[60, 90]] * B), (104, 144))
    assert out.dtype == torch.bool and out.shape == ref.shape
    # equal where the upsampled probability is not within rounding of the threshold
    p = torch.sigmoid(seg.upsample_bilinear(torch.from_numpy(pred), (104, 144))).numpy()
    firm = np.abs(p - 0.5) > 1e-6
    assert firm.mean() > 0.99
    np.testing.assert_array_equal(out.numpy()[firm], ref[firm])
