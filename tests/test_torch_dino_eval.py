"""The port's eval slice held against the JAX package end to end.

A tiny DINO (hidden 64, 4 heads, 2+2 layers, FFN 128, 20 queries, 12
classes, a 64-d text bank and the distill projection, the R50 backbone, ``msda_impl='pallas2'``, which
JAX routes to its 'tiled' composition on the CPU) gets one set of weights,
drawn with numpy from a seed and converted with ``params_from_jax``. Every
kernel the flax init zeroes (sampling offsets, attention weights, the last
box-head layers) gets noise too, so the clamp, the softmax and the box
refinement all do work.

Two canvases: 128x192, where the encoder's offset clamp applies, and 96x96,
where the tile plan is not integral and it must not. Tolerances are float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import make_eval_step as jax_make_eval_step
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models.dino import DINO, DINOConfig
from richsem_tpu_torch.models.transformer_utils import gen_encoder_output_proposals
from richsem_tpu_torch.ops.ms_deform_attn import tiled_supported
from richsem_tpu_torch.train.engine import make_eval_step
from richsem_tpu_torch.utils.convert import params_from_jax
from richsem_tpu_torch.utils.misc import resize_mask

torch.set_num_threads(2)

TINY = dict(
    num_classes=12, hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
    dim_feedforward=128, num_queries=20, dn_labelbook_size=12,
    use_language=True, use_visual_distill=True, clip_embed_dim=64,
    msda_impl="pallas2", msda_margin=6, msda_tile=(16, 16),
)
B = 2
NUM_SELECT = 100  # <= num_queries * num_classes = 240
TOL = 1e-3


def _np_params(shapes, rng):
    """Seeded numpy weights for a flax tree of shapes (fan-in scaled kernels,
    noisy norms and biases, positive BN variances)."""
    gains = {"sampling_offsets": 3.0}

    def leaf(path, sds):
        names = [p.key for p in path]
        name, parent = names[-1], names[-2] if len(names) > 1 else ""
        shape = sds.shape
        if name == "kernel":
            fan_in = shape[0] if parent in ("query", "key", "value") else np.prod(shape[:-1])
            w = rng.normal(size=shape) / np.sqrt(fan_in) * gains.get(parent, 1.0)
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            w = 0.1 * rng.normal(size=shape)
        elif name == "logit_scale":
            w = np.full(shape, np.log(1 / 0.07))
        else:  # level_embed, tgt_embed
            w = rng.normal(size=shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def models():
    jax_model = JaxDINO(JaxDINOConfig(**TINY))
    rng = np.random.default_rng(0)
    text_embed = rng.normal(size=(TINY["num_classes"], TINY["clip_embed_dim"]))
    text_embed = text_embed.astype(np.float32)
    shapes = jax.eval_shape(
        jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        jnp.zeros((1, 64, 64), bool), text_embed=jnp.asarray(text_embed),
    )
    params = _np_params(shapes, rng)
    model = DINO(DINOConfig(**TINY), device="cpu").eval()
    model.load_state_dict(params_from_jax(params, expected=model.state_dict()))
    return jax_model, jax.tree.map(jnp.asarray, params), model, text_embed


def _batch(canvas, valid, seed):
    h, w = canvas
    rng = np.random.default_rng(seed)
    images = rng.uniform(-1, 1, (B, h, w, 3)).astype(np.float32)
    pad = np.ones((B, h, w), bool)
    pad[0] = False
    vh, vw = valid
    pad[1, :vh, :vw] = False
    orig = np.asarray([[h, w], [vh, vw]], np.float32)
    return {"images": images, "pad_mask": pad, "orig_size": orig}


def _levels(canvas):
    h, w = canvas
    shapes = [(h // s, w // s) for s in (8, 16, 32)]
    shapes.append(((shapes[-1][0] - 1) // 2 + 1, (shapes[-1][1] - 1) // 2 + 1))
    return tuple(shapes)


def _anchor_index(boxes, pad_mask, canvas):
    """Token index of each selected two-stage proposal, from its anchor box
    (anchors are unique: grid position within a level, size across levels)."""
    shapes = _levels(canvas)
    mask_flat = torch.cat(
        [resize_mask(pad_mask, hw).reshape(B, -1) for hw in shapes], dim=1)
    _, props, _ = gen_encoder_output_proposals(
        torch.zeros(B, mask_flat.shape[1], 1), mask_flat, shapes)
    anchors = torch.sigmoid(props).numpy()
    dist = np.abs(np.asarray(boxes)[:, :, None, :] - anchors[:, None, :, :]).sum(-1)
    assert (dist.min(-1) < 1e-5).all()
    return dist.argmin(-1)


# (canvas, valid extent of the second image, does the clamp apply). With the
# clamp, the second image's valid extent is a multiple of 64, so every level
# has the same valid ratio: where the ratios differ across levels, the JAX
# windowed kernels drop taps near a tile's edge that the clamp was meant to
# keep in the window (ROADMAP F3), and the port, which gathers exactly, differs.
CANVASES = [((128, 192), (64, 128), True), ((96, 96), (70, 68), False)]


@pytest.mark.parametrize("canvas,valid,clamped", CANVASES, ids=["128x192", "96x96"])
def test_forward_parity(models, canvas, valid, clamped):
    jax_model, params, model, text_embed = models
    assert tiled_supported(_levels(canvas), TINY["msda_tile"]) == clamped
    batch = _batch(canvas, valid, seed=1)
    ref = jax.jit(lambda p, i, m: jax_model.apply(p, i, m, text_embed=jnp.asarray(text_embed)))(
        params, jnp.asarray(batch["images"]), jnp.asarray(batch["pad_mask"]))
    offsets = []
    hook = model.encoder_layer0.self_attn.sampling_offsets.register_forward_hook(
        lambda mod, args, result: offsets.append(result))
    with torch.no_grad():
        out = model(torch.from_numpy(batch["images"]), torch.from_numpy(batch["pad_mask"]),
                    text_embed=torch.from_numpy(text_embed))
    hook.remove()
    # the raw offsets reach past +-(margin - 0.5), so where the clamp applies it binds
    assert float(offsets[0].abs().max()) > TINY["msda_margin"] - 0.5

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL, atol=TOL)

    close(out["pred_logits"], ref["pred_logits"])
    close(out["pred_boxes"], ref["pred_boxes"])
    for aux, aux_ref in zip(out["aux_outputs"], ref["aux_outputs"], strict=True):
        close(aux["pred_logits"], aux_ref["pred_logits"])
        close(aux["pred_boxes"], aux_ref["pred_boxes"])
    for key in ("interm_outputs", "interm_outputs_for_matching_pre"):
        close(out[key]["pred_logits"], ref[key]["pred_logits"])
        close(out[key]["pred_boxes"], ref[key]["pred_boxes"])
    close(out["pred_clip_embed"], ref["pred_clip_embed"])
    close(out["pred_clip_logits"], ref["pred_clip_logits"])

    pad = torch.from_numpy(batch["pad_mask"])
    jax_idx = _anchor_index(ref["interm_outputs_for_matching_pre"]["pred_boxes"], pad, canvas)
    port_idx = _anchor_index(out["interm_outputs_for_matching_pre"]["pred_boxes"], pad, canvas)
    np.testing.assert_array_equal(port_idx, out["topk_idx"].numpy())
    np.testing.assert_array_equal(out["topk_idx"].numpy(), jax_idx)


@pytest.mark.parametrize("canvas,valid,clamped", CANVASES, ids=["128x192", "96x96"])
def test_eval_step_parity(models, canvas, valid, clamped):
    jax_model, params, model, text_embed = models
    cfg = {"num_select": NUM_SELECT, "nms_iou_threshold": -1}
    batch = _batch(canvas, valid, seed=2)
    ref = jax_make_eval_step(jax_model, JaxConfig(cfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(text_embed))
    out = make_eval_step(model, Config(cfg))(
        {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(text_embed))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    for k in ("scores", "labels"):
        assert out[k].shape == (B, NUM_SELECT)
    assert out["boxes"].shape == (B, NUM_SELECT, 4)
    np.testing.assert_allclose(out["scores"], ref["scores"], rtol=TOL, atol=TOL)
    # ranks are only defined where the score is apart from both neighbours
    s = ref["scores"]
    gap = np.full(s.shape, np.inf)
    gap[:, 1:] = np.minimum(gap[:, 1:], s[:, :-1] - s[:, 1:])
    gap[:, :-1] = np.minimum(gap[:, :-1], s[:, :-1] - s[:, 1:])
    apart = gap > 1e-5
    assert apart.mean() > 0.9
    np.testing.assert_array_equal(out["labels"][apart], ref["labels"][apart])
    scale = batch["orig_size"].max()
    np.testing.assert_allclose(out["boxes"][apart], ref["boxes"][apart],
                               rtol=TOL, atol=TOL * scale)


def test_from_config_matches_jax():
    path = "configs/richsem/richsem_4scale_lvis.py"
    ref = dataclasses.asdict(JaxDINOConfig.from_config(JaxConfig.fromfile(path)))
    out = dataclasses.asdict(DINOConfig.from_config(Config.fromfile(path)))
    assert set(out) == set(ref)
    assert jnp.dtype(ref.pop("compute_dtype")).name == "bfloat16"
    assert out.pop("compute_dtype") is torch.bfloat16
    for key, value in ref.items():
        assert out[key] == value, key


def test_no_dn_or_clip_features_in_the_eval_slice(models):
    _, _, model, text_embed = models
    x = torch.zeros(1, 64, 64, 3)
    m = torch.zeros(1, 64, 64, dtype=torch.bool)
    # DN queries come with the training slice, labels and boxes together
    with pytest.raises(ValueError, match="together"):
        model(x, m, dn_labels=torch.zeros(1, 4, dtype=torch.long),
              text_embed=torch.from_numpy(text_embed))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model(x, m, clip_features=torch.zeros(1, 2, 2, 8),
              text_embed=torch.from_numpy(text_embed))
