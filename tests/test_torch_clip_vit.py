"""The port's CLIP ViT tower (``richsem_tpu_torch/models/clip/model.py:
VisionTransformer``) held against ``richsem_tpu/models/clip/model.py``.

A tiny ViT (patch 4, a 7x7 positional grid from a 28-pixel resolution, width
32, 4 heads, 2 blocks; the tiny text tower of ``tests/test_torch_clip.py``)
with seeded numpy weights in every leaf, converted with
``clip_params_from_jax``:

* ``encode_image`` with and without ``ret_sp`` against JAX, in f32 to 5e-5 of
  the largest magnitude and with the bf16 tower within one bf16 rounding step
  of it for each block (the patch convolution agrees to 1e-6; each block's
  attention and MLP round their bf16 results at other points in XLA:CPU and
  PyTorch: measured 0.56-0.71 steps after one block, 1.19-1.24 after two): on
  the 7x7 grid itself, where ``_resize_pos_embed`` grows it (7x7 -> 28x42) and where it shrinks it (7x7 -> 2x3, where
  ``jax.image.resize`` antialiases: the positional tables are also compared
  alone there, to 1e-6).
* The converter at the full ViT-B/32 width from ``jax.eval_shape``: every
  leaf once, with its shape.
* The ViT text bank (``build_text_embedding``) against JAX's, to 1e-5.
* ``attnpool`` raises for ViT in both packages, and so does a train step with
  the ViT teacher under ``use_visual_distill``, at ``attnpool``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.clip.model import CLIP as JaxCLIP
from richsem_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from richsem_tpu.models.clip.model import _resize_pos_embed as jax_resize_pos_embed
from richsem_tpu.models.clip_align import build_text_embedding as jax_text_bank
from richsem_tpu.models.clip.tokenizer import HashTokenizer as JaxHashTokenizer
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models.build import build_clip_teacher, clip_spatial_width
from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig, resize_pos_embed
from richsem_tpu_torch.models.clip.tokenizer import HashTokenizer
from richsem_tpu_torch.models.clip_align import build_text_embedding
from richsem_tpu_torch.utils.convert import clip_params_from_jax
from tests.test_torch_clip import np_params

torch.set_num_threads(2)

TINY_VIT = dict(name="ViT-tiny", embed_dim=16, vision_layers=(2,), vision_width=32,
                vision_heads=4, image_resolution=28, vision_patch_size=4, is_vit=True,
                vocab_size=64, transformer_width=16, transformer_heads=2,
                transformer_layers=1, context_length=8)
# (input h, w) -> patch grid: the table's own 7x7, grown, shrunk
CANVASES = {"7x7": (28, 28), "28x42": (112, 168), "2x3": (8, 12)}


def vit_pair(seed=0, dtype=None, **over):
    """-> (JAX module, params, port module) of the tiny ViT, one set of weights."""
    kw = dict(TINY_VIT, **over)
    jax_model = JaxCLIP(JaxCLIPConfig(**kw, dtype=None if dtype is None else jnp.bfloat16))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 3)),
                            jnp.zeros((1, 8), jnp.int32))
    params = np_params(shapes, np.random.default_rng(seed))
    port = CLIP(CLIPConfig(**kw, dtype=dtype), device="cpu")
    port.load_state_dict(clip_params_from_jax(params, expected=port.state_dict()))
    return jax_model, params, port.eval().requires_grad_(False)


@pytest.fixture(scope="module", params=[None, torch.bfloat16], ids=["f32", "bf16"])
def pair(request):
    return request.param, vit_pair(dtype=request.param)


@pytest.mark.parametrize("ret_sp", [False, True], ids=["pooled", "ret_sp"])
@pytest.mark.parametrize("canvas", list(CANVASES))
def test_encode_image_matches_jax(pair, canvas, ret_sp):
    dtype, (jax_model, params, port) = pair
    h, w = CANVASES[canvas]
    img = np.random.default_rng(1).normal(size=(2, h, w, 3)).astype(np.float32)
    ref = np.asarray(jax_model.apply(params, jnp.asarray(img), ret_sp,
                                     method=JaxCLIP.encode_image).astype(jnp.float32))
    out = port.encode_image(torch.from_numpy(img), ret_sp=ret_sp)
    gh, gw = h // 4, w // 4
    assert out.shape == ((2, gh, gw, 16) if ret_sp else (2, 16)) and out.dtype == torch.float32
    scale = float(np.abs(ref).max())
    # bf16: one rounding step of the largest magnitude a block (XLA:CPU and
    # PyTorch round the blocks' bf16 products, softmax and sums at other points)
    tol = 5e-5 if dtype is None else 2 ** -8 * TINY_VIT["vision_layers"][0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("grid", [(7, 7), (28, 42), (2, 3), (7, 3), (1, 1), (9, 5)])
def test_resize_pos_embed_matches_jax(grid):
    """The table alone, f32, where the grid is kept, grown, shrunk (antialiased)
    and both at once."""
    pos = np.random.default_rng(2).normal(size=(50, 24)).astype(np.float32)
    ref = np.asarray(jax_resize_pos_embed(jnp.asarray(pos), *grid))
    out = resize_pos_embed(torch.from_numpy(pos), *grid)
    assert out.shape == ref.shape == (1, grid[0] * grid[1] + 1, 24)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_vit_b32_tree_maps_one_to_one():
    """At ViT-B/32's width every flax leaf of the vision tower and the text
    tower maps to exactly one parameter of the port, with its shape."""
    jax_model = JaxCLIP(JaxCLIPConfig.vit_b32())
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = CLIP(CLIPConfig.vit_b32(), device="meta")
    expected = port.state_dict()
    state = clip_params_from_jax(params, expected=expected)  # raises on any mismatch
    assert len(state) == len(jax.tree.leaves(params)) == len(expected)
    for name, shape in (("visual.conv1.weight", (768, 3, 32, 32)),
                        ("visual.class_embedding", (768,)),
                        ("visual.positional_embedding", (50, 768)),
                        ("visual.ln_pre.weight", (768,)),
                        ("visual.block11.attn.query.weight", (768, 768)),
                        ("visual.block0.mlp_c_fc.weight", (3072, 768)),
                        ("visual.ln_post.bias", (768,)), ("visual.proj", (768, 512)),
                        ("text_projection", (512, 512))):
        assert tuple(state[name].shape) == shape, name
    assert "visual.conv1.bias" not in expected
    # every tensor on the device asked for; the text tower computes in f32
    assert {t.device.type for t in port.state_dict().values()} == {"meta"}
    assert port.text_block0.attn.query.compute_dtype == torch.float32
    assert CLIPConfig.vit_b32() == dataclasses.replace(
        CLIPConfig(), **{k: getattr(JaxCLIPConfig.vit_b32(), k)
                         for k in ("name", "embed_dim", "vision_layers", "vision_width",
                                   "vision_heads", "is_vit")})


def test_vit_text_bank_matches_jax():
    jax_model, params, port = vit_pair(seed=3, vocab_size=1100)  # word ids in [1000, 1098)
    cats = {1: {"name": "traffic_light"}, 2: {"name": "zebra"}, 4: {"name": "sea lion"}}
    ref = np.asarray(jax_text_bank(jax_model, jax.tree.map(jnp.asarray, params), cats,
                                   JaxHashTokenizer(1100), 8))
    out = build_text_embedding(port, cats, HashTokenizer(1100), 8)
    assert out.shape == ref.shape == (5, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_build_clip_teacher_builds_the_vit():
    cfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
    cfg.clip_model = "ViT-B/32"
    teacher = build_clip_teacher(cfg, "bfloat16", device="meta")
    assert teacher.cfg.is_vit and teacher.cfg.embed_dim == 512
    assert teacher.cfg.dtype == torch.bfloat16 and teacher.cfg.image_resolution == 224
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    assert clip_spatial_width(cfg) == 512  # the ViT map is proj-wide
    cfg.clip_model = "RN101"
    with pytest.raises(ValueError, match="RN101"):
        build_clip_teacher(cfg, device="meta")


def test_attnpool_refuses_the_vit_as_jax():
    jax_model, params, port = vit_pair()
    x = np.zeros((2, 7, 7, 16), np.float32)
    with pytest.raises(NotImplementedError, match="attnpool is the RN path") as ref:
        jax_model.apply(params, jnp.asarray(x), method=JaxCLIP.attnpool)
    with pytest.raises(NotImplementedError, match="attnpool is the RN path") as out:
        port.attnpool(torch.from_numpy(x))
    assert str(out.value) == str(ref.value)


def test_distill_step_with_the_vit_raises_at_attnpool():
    """A train step under ``use_visual_distill`` crops the teacher's map and
    pools the crops with ``attnpool``, which the ViT lacks: the step raises
    there, as JAX's raises at its trace."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer
    from tests.test_torch_flagship_train import CONFIG, FLAGSHIP, _batches, _with_teacher_keys

    cfg = Config.fromfile(CONFIG)
    cfg.update(dict(FLAGSHIP, clip_spatial_dim=16))
    model, _, _ = build_model("richsem", cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    # the distillation crops 7 x 7 RoIs (image_resolution // 32), the table's grid
    _, _, teacher = vit_pair(image_resolution=224, vision_patch_size=32)
    step = make_train_step(model, cfg, device="cpu", clip_model=teacher)
    batch = _with_teacher_keys(_batches()[:1])[0]
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    t["labels"] = t["labels"].long()
    text = torch.randn((cfg.num_classes, 16), generator=torch.Generator().manual_seed(1))
    with pytest.raises(NotImplementedError, match="attnpool is the RN path") as err:
        step(create_train_state(model, build_optimizer(model, cfg)), t, text)
    assert "attnpool" in err.traceback[-1].name
