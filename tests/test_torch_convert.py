"""``params_from_jax``: the flax tree of ``richsem_tpu`` -> the port's state dict.

At production width (the flagship 6+6 layers, d 256, 900 queries, 1204
classes, open-vocab classifier and distill projection) every flax leaf must
map to a port parameter or buffer of the right shape, and every port
parameter and buffer must be covered. The shapes come from
``jax.eval_shape`` and the port is built on the meta device, so nothing is
computed at that width. Small modules check that the reshapes and transposes
give the same function on both sides.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models.dino import DINO, DINOConfig, MultiHeadAttention
from richsem_tpu_torch.models.layers import Conv, Dense
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

FLAGSHIP = "configs/richsem/richsem_4scale_lvis.py"


def test_flagship_tree_maps_one_to_one():
    jcfg = JaxDINOConfig.from_config(JaxConfig.fromfile(FLAGSHIP))
    assert (jcfg.enc_layers, jcfg.dec_layers, jcfg.hidden_dim, jcfg.num_queries,
            jcfg.num_classes) == (6, 6, 256, 900, 1204)
    assert jcfg.use_language and jcfg.use_visual_distill
    shapes = jax.eval_shape(
        JaxDINO(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 256, 384, 3)),
        jnp.zeros((1, 256, 384), bool),
        text_embed=jnp.zeros((jcfg.num_classes, jcfg.clip_embed_dim)),
    )
    # zero-filled host arrays are not touched until the converter reads them
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    n_leaves = len(jax.tree.leaves(params))

    port = DINO(DINOConfig.from_config(Config.fromfile(FLAGSHIP)), device="meta")
    expected = port.state_dict()
    state = params_from_jax(params, expected=expected)  # raises on any mismatch
    assert len(state) == n_leaves == len(expected)
    assert n_leaves > 300
    for name in ("encoder_layer0.self_attn.value_proj.weight",
                 "input_proj3.conv.weight", "backbone.layer2_block0.conv2.weight",
                 "decoder_layer5.self_attn.query.weight",
                 "backbone.stem_bn.running_var", "clip_visual_proj.weight",
                 "class_embed.dino_visual_proj.weight", "label_proj.weight",
                 "logit_scale"):
        assert tuple(state[name].shape) == tuple(expected[name].shape), name


def test_leftovers_raise():
    params = {"params": {"enc_output": {"kernel": np.zeros((4, 4), np.float32),
                                        "bias": np.zeros(4, np.float32)}}}
    with pytest.raises(ValueError, match="missing"):
        params_from_jax(params, expected={"enc_output.weight": (4, 4),
                                          "enc_output.bias": (4,),
                                          "tgt_embed": (2, 4)})
    with pytest.raises(ValueError, match="wrong shapes"):
        params_from_jax(params, expected={"enc_output.weight": (4, 5),
                                          "enc_output.bias": (4,)})
    with pytest.raises(ValueError, match="no port mapping"):
        params_from_jax({"params": {"x": {"kernel": np.zeros((2, 2, 2), np.float32)}}})


def _load(module, flax_params):
    """Load a standalone flax module's params (nested under one name, as in a model)."""
    holder = torch.nn.ModuleDict({"m": module})
    nested = {"m": flax_params["params"]}
    holder.load_state_dict(params_from_jax(nested, expected=holder.state_dict()))
    return module


def _rand_params(tree, rng):
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), tree)


def test_dense_and_conv_give_the_same_function():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    for flax_mod, port_mod in (
        (nn.Dense(5), Dense(6, 5)),
        (nn.Conv(5, (3, 3), strides=(2, 2), padding=[(1, 1), (1, 1)]),
         Conv(6, 5, 3, stride=2, padding=1)),
        (nn.Conv(5, (1, 1), strides=(2, 2), use_bias=False), Conv(6, 5, 1, stride=2, bias=False)),
    ):
        params = _rand_params(jax.eval_shape(flax_mod.init, jax.random.PRNGKey(0), x), rng)
        ref = np.asarray(flax_mod.apply(params, x))
        with torch.no_grad():
            out = _load(port_mod, params)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_multihead_attention_gives_the_same_function():
    """flax MultiHeadDotProductAttention (query/key/value kernels [in, h, hd],
    out kernel [h, hd, out], query scaled by 1/sqrt(hd)) vs the port's."""
    rng = np.random.default_rng(1)
    dim, heads, n = 32, 4, 7
    q = rng.normal(size=(2, n, dim)).astype(np.float32)
    v = rng.normal(size=(2, n, dim)).astype(np.float32)
    mask = rng.uniform(size=(2, 1, n, n)) > 0.3
    mask[..., 0] = True  # every query attends to something
    flax_mha = nn.MultiHeadDotProductAttention(num_heads=heads, qkv_features=dim)
    params = _rand_params(
        jax.eval_shape(flax_mha.init, jax.random.PRNGKey(0), q, q, v), rng)
    ref = np.asarray(flax_mha.apply(params, q, q, v, mask=mask))
    port = _load(MultiHeadAttention(dim, heads, torch.float32), params)
    with torch.no_grad():
        out = port(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v),
                   mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
