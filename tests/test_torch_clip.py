"""The port's CLIP teacher held against ``richsem_tpu/models/clip``.

A tiny CLIP (``TINY_CLIP`` of ``tests/test_richsem_distill.py``: RN blocks
(1, 1, 1, 1) of width 8, a 2x2 attention-pool grid, a one-block text tower of
width 16) with seeded numpy weights in every leaf (the frozen batch norms
included), converted with ``clip_params_from_jax``: the spatial map
(``ret_sp``), the attention pool and the text encoder against JAX in f32, and
the attention pool in bf16. The converter runs once more at the full RN50
width from ``jax.eval_shape``, with nothing initialized. The tokenizers are
plain Python copies, held to the JAX ones on the same texts.
"""

import dataclasses
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.clip import tokenizer as jax_tok
from richsem_tpu.models.clip.model import CLIP as JaxCLIP
from richsem_tpu.models.clip.model import CLIPConfig as JaxCLIPConfig
from richsem_tpu.models.clip.model import denorm_imagenet_to_clip as jax_denorm
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models.build import build_clip_teacher
from richsem_tpu_torch.models.clip import tokenizer as port_tok
from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig, denorm_imagenet_to_clip
from richsem_tpu_torch.utils.convert import clip_params_from_jax

torch.set_num_threads(2)

TINY = dict(embed_dim=16, vision_layers=(1, 1, 1, 1), vision_width=8, vision_heads=4,
            image_resolution=64, vocab_size=64, transformer_width=16,
            transformer_heads=2, transformer_layers=1, context_length=8)


def np_params(shapes, rng):
    """Seeded weights for a flax tree of shapes, noise in every leaf."""
    def leaf(path, sds):
        name = path[-1].key
        parent = path[-2].key if len(path) > 1 else ""
        shape = sds.shape
        if name == "kernel":
            fan_in = shape[0] if parent in ("query", "key", "value") else np.prod(shape[:-1])
            w = rng.normal(size=shape) / np.sqrt(fan_in)
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "var":
            w = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            w = 0.1 * rng.normal(size=shape)
        elif name == "logit_scale":
            w = np.asarray(np.log(1 / 0.07))
        else:  # embeddings and projections
            w = rng.normal(size=shape) / np.sqrt(shape[-1])
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_pair(seed=0, dtype=None, **over):
    """-> (JAX module, params, port module) with the same weights."""
    kw = dict(TINY, **over)
    jax_model = JaxCLIP(JaxCLIPConfig(**kw, dtype=None if dtype is None else jnp.bfloat16))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, kw["context_length"]), jnp.int32))
    params = np_params(shapes, np.random.default_rng(seed))
    port = CLIP(CLIPConfig(**kw, dtype=dtype), device="cpu")
    port.load_state_dict(clip_params_from_jax(params, expected=port.state_dict()))
    return jax_model, params, port.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair()


def test_spatial_map_matches_jax(pair):
    """encode_image(ret_sp=True) on a non-square image, through the stem, the
    anti-aliased strides and the frozen batch norms."""
    jax_model, params, port = pair
    img = np.random.default_rng(1).normal(size=(2, 64, 96, 3)).astype(np.float32)
    ref = jax_model.apply(params, jnp.asarray(img), True, method=JaxCLIP.encode_image)
    out = port.encode_image(torch.from_numpy(img), ret_sp=True)
    assert out.shape == (2, 2, 3, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_attnpool_matches_jax(dtype):
    """The mean-token query pool of 2x2 maps (and of the whole image), f32 and
    with the bf16 tower (f32 softmax, cast back)."""
    jax_model, params, port = tiny_pair(dtype=dtype)
    x = np.random.default_rng(2).normal(size=(5, 2, 2, 256)).astype(np.float32)
    ref = np.asarray(jax_model.apply(params, jnp.asarray(x), method=JaxCLIP.attnpool)
                     .astype(jnp.float32))
    out = port.attnpool(torch.from_numpy(x))
    assert out.dtype == (dtype or torch.float32)
    # bf16: products rounded to bf16 at the flax cast points, summed in another order
    tol = 1e-5 if dtype is None else 3e-2
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))
    if dtype is None:
        img = np.random.default_rng(3).normal(size=(2, 64, 64, 3)).astype(np.float32)
        ref = jax_model.apply(params, jnp.asarray(img), method=JaxCLIP.encode_image)
        out = port.encode_image(torch.from_numpy(img))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()))


def test_encode_text_matches_jax(pair):
    """Causal blocks and EOT pooling (the EOT token has the largest id)."""
    jax_model, params, port = pair
    toks = np.asarray([[62, 5, 9, 63, 0, 0, 0, 0],
                       [62, 17, 33, 2, 40, 11, 63, 0],
                       [62, 63, 0, 0, 0, 0, 0, 0]], np.int32)
    ref = jax_model.apply(params, jnp.asarray(toks), method=JaxCLIP.encode_text)
    out = port.encode_text(torch.from_numpy(toks).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_denorm_matches_jax():
    x = np.random.default_rng(4).normal(size=(1, 4, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(denorm_imagenet_to_clip(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_denorm(jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def test_rn50_tree_maps_one_to_one():
    """At the full RN50 width every flax leaf maps to exactly one parameter or
    buffer of the port's teacher, with its shape; shapes from eval_shape, the
    port on the meta device."""
    jax_model = JaxCLIP(JaxCLIPConfig.rn50())
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)), jnp.zeros((1, 77), jnp.int32))
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    port = CLIP(CLIPConfig.rn50(), device="meta")
    expected = port.state_dict()
    state = clip_params_from_jax(params, expected=expected)  # raises on any mismatch
    assert len(state) == len(jax.tree.leaves(params)) == len(expected)
    for name, shape in (("visual.attnpool.positional_embedding", (50, 2048)),
                        ("visual.attnpool.c_proj.weight", (1024, 2048)),
                        ("visual.layer4_block0.downsample_bn.running_var", (2048,)),
                        ("text_block11.attn.out.weight", (512, 512)),
                        ("token_embedding", (49408, 512)), ("logit_scale", ())):
        assert tuple(state[name].shape) == shape, name
    params["params"]["visual"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="unexpected"):
        clip_params_from_jax(params, expected=expected)


def test_build_clip_teacher_is_frozen():
    cfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
    teacher = build_clip_teacher(cfg, "bfloat16", device="meta")
    assert not teacher.training
    assert not any(p.requires_grad for p in teacher.parameters())
    assert teacher.cfg.dtype == torch.bfloat16 and teacher.cfg.embed_dim == 1024
    cfg.clip_model = "ViT-B/32"  # the ViT tower (tests/test_torch_clip_vit.py)
    teacher = build_clip_teacher(cfg, device="meta")
    assert teacher.cfg.is_vit and not any(p.requires_grad for p in teacher.parameters())


TEXTS = ["a photo of a cat.", "Hello hell  HELLO", "the sea_lion's fins", "x" * 200,
         "café &amp; bar"]


def test_bpe_tokenizer_matches_jax(tmp_path):
    merges = "#version tiny\nh e\nl l\nhe ll</w>\nc a\nca t</w>\nt h\nth e</w>\n"
    path = tmp_path / "bpe.txt.gz"
    with gzip.open(path, "wt") as f:
        f.write(merges)
    ref, tok = jax_tok.SimpleTokenizer(str(path)), port_tok.SimpleTokenizer(str(path))
    for text in TEXTS:
        assert tok.encode(text) == ref.encode(text), text
        assert tok.decode(tok.encode(text)) == ref.decode(ref.encode(text))
    np.testing.assert_array_equal(port_tok.tokenize(TEXTS, tok, 16),
                                  jax_tok.tokenize(TEXTS, ref, 16))
    with pytest.raises(ValueError, match="too long"):
        port_tok.tokenize(TEXTS, tok, 16, truncate=False)


def test_hash_tokenizer_matches_jax():
    ref, tok = jax_tok.HashTokenizer(200), port_tok.HashTokenizer(200)
    np.testing.assert_array_equal(port_tok.tokenize(TEXTS, tok, 12),
                                  jax_tok.tokenize(TEXTS, ref, 12))
