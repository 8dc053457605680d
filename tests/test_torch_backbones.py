"""The port's Swin, ConvNeXt and FocalNet backbones held against the JAX package's.

Each backbone at a small width (Swin: embed 32, depths (2, 2, 2, 2), window 4,
so every stage has a shifted block; ConvNeXt and FocalNet of similar width)
gets one set of weights, drawn with numpy from a seed and converted with
``params_from_jax`` (``expected=``: every key matched). Three canvases: 64x64
(a multiple of every window and merge), 72x104 (padded windows: 18x26 at
stride 4, 9x13 and 5x7 after it) and 36x52 (odd sides at every merge).

The JAX side runs jitted, as its detector does. Tolerances, set from
readings of this file's cases. float32: 1e-4. bf16: each block alone, on one
f32 input, within two bf16 rounding steps of its largest magnitude (measured:
up to 1.73 steps FocalNet, 0.58 Swin, 0.39 ConvNeXt). The port's GELU is
``F.gelu``, which rounds the tanh GELU once, where XLA:CPU rounds after each
of its operations, and FocalNet's gated focal contexts carry the most GELUs.
The whole backbone, within ten such steps: a patch convolution, a LayerNorm
or one of XLA's fusions that sums or rounds in another order flips a bf16
rounding now and then, and the later blocks carry the flip on (measured: up
to 7.88 steps FocalNet, 4.24 Swin, 2.42 ConvNeXt).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models import convnext as jc
from richsem_tpu.models import focalnet as jf
from richsem_tpu.models import swin as js
from richsem_tpu_torch.models import convnext as tc
from richsem_tpu_torch.models import focalnet as tf
from richsem_tpu_torch.models import swin as ts
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

SMALL = {
    "swin": dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 2, 4, 4), window_size=4),
    "convnext": dict(depths=(1, 1, 2, 1), dims=(16, 32, 64, 128)),
    "focalnet": dict(embed_dim=16, depths=(1, 1, 2, 1), focal_level=2),
}
FAMILIES = {  # family -> (JAX config, JAX module, port config, port module)
    "swin": (js.SwinConfig, js.SwinTransformer, ts.SwinConfig, ts.SwinTransformer),
    "convnext": (jc.ConvNeXtConfig, jc.ConvNeXt, tc.ConvNeXtConfig, tc.ConvNeXt),
    "focalnet": (jf.FocalNetConfig, jf.FocalNet, tf.FocalNetConfig, tf.FocalNet),
}
VARIANTS = {
    "swin": ("swin_T_224_1k", "swin_B_224_22k", "swin_B_384_22k", "swin_L_224_22k",
             "swin_L_384_22k"),
    "convnext": ("convnext_tiny", "convnext_small", "convnext_base", "convnext_large",
                 "convnext_xlarge_22k"),
    "focalnet": ("focalnet_L_384_22k", "focalnet_L_384_22k_fl4", "focalnet_XL_384_22k",
                 "focalnet_XL_384_22k_fl4", "focalnet_H_224_22k", "focalnet_H_224_22k_fl4"),
}
CANVASES = ((64, 64), (72, 104), (36, 52))
DTYPES = {"f32": (None, None), "bf16": (jnp.bfloat16, torch.bfloat16)}


def np_params(shapes, rng):
    """Seeded numpy weights for a flax tree of shapes: fan-in scaled kernels,
    noisy norms and biases, a position bias of 0.1 and a layer scale near 0.5
    (so that every block does work)."""
    def leaf(path, sds):
        name = path[-1].key
        if name == "kernel":
            w = rng.normal(size=sds.shape) / np.sqrt(np.prod(sds.shape[:-1]))
        elif name == "scale":
            w = 1.0 + 0.1 * rng.normal(size=sds.shape)
        elif name == "gamma":
            w = 0.5 + 0.1 * rng.normal(size=sds.shape)
        else:  # bias, rel_pos_bias
            w = 0.1 * rng.normal(size=sds.shape)
        return np.asarray(w, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def bf16_step(x: np.ndarray) -> float:
    """One bf16 rounding step at the largest magnitude of ``x``."""
    return float(2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7))


def _run(jax_module, port_module, x, port_dtype):
    """-> (JAX outputs, port outputs) as float32 numpy, from one set of weights."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = np_params(shapes, np.random.default_rng(0))
    port_module.load_state_dict(params_from_jax(params, expected=port_module.state_dict()))
    xt = torch.from_numpy(x)
    if port_dtype is not None and x.shape[-1] == 3:  # images enter in the compute dtype
        xt = xt.to(port_dtype)
    ref = jax.jit(jax_module.apply)(params, jnp.asarray(xt.float().numpy()).astype(
        jnp.bfloat16 if port_dtype is not None and x.shape[-1] == 3 else jnp.float32))
    with torch.no_grad():
        out = port_module(xt)
    as_list = (lambda o: list(o)) if isinstance(out, tuple) else (lambda o: [o])
    return ([np.asarray(r, np.float32) for r in as_list(ref)],
            [o.float().numpy() for o in as_list(out)])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("canvas", CANVASES, ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_backbone_matches_jax(family, canvas, dtype):
    jcfg, jmod, pcfg, pmod = FAMILIES[family]
    jdt, pdt = DTYPES[dtype]
    x = np.random.default_rng(1).uniform(-1, 1, (2, *canvas, 3)).astype(np.float32)
    ref, out = _run(jmod(jcfg(**SMALL[family], dtype=jdt)),
                    pmod(pcfg(**SMALL[family], dtype=pdt), device="cpu"), x, pdt)
    assert len(ref) == len(out) == 3
    for i, (r, o) in enumerate(zip(ref, out)):
        assert r.shape == o.shape, i
        tol = 1e-4 if dtype == "f32" else 10 * bf16_step(r)
        np.testing.assert_allclose(o, r, rtol=0, atol=tol, err_msg=f"{family} out {i}")


def _blocks():
    bf = jnp.bfloat16
    return {
        "swin shifted": (js.SwinBlock(32, 2, 4, 2, 4.0, 0.0, dtype=bf),
                         ts.SwinBlock(32, 2, 4, 2, 4.0, 0.0, dtype=torch.bfloat16)),
        "swin unshifted": (js.SwinBlock(32, 2, 4, 0, 4.0, 0.0, dtype=bf),
                           ts.SwinBlock(32, 2, 4, 0, 4.0, 0.0, dtype=torch.bfloat16)),
        "convnext": (jc.ConvNeXtBlock(32, 0.0, 0.5, dtype=bf),
                     tc.ConvNeXtBlock(32, 0.0, 0.5, dtype=torch.bfloat16)),
        "focalnet": (jf.FocalBlock(32, 2, 3, 0.0, dtype=bf),
                     tf.FocalBlock(32, 2, 3, 0.0, dtype=torch.bfloat16)),
    }


@pytest.mark.parametrize("hw", ((12, 12), (9, 13)), ids=lambda c: f"{c[0]}x{c[1]}")
@pytest.mark.parametrize("block", sorted(_blocks()))
def test_bf16_block_within_two_steps(block, hw):
    """One block in bf16 on one f32 input (9x13 pads the Swin window)."""
    jmod, pmod = _blocks()[block]
    x = np.random.default_rng(2).normal(size=(2, *hw, 32)).astype(np.float32)
    (r,), (o,) = _run(jmod, pmod, x, None)
    np.testing.assert_allclose(o, r, rtol=0, atol=2 * bf16_step(r))


@pytest.mark.parametrize("ws", (2, 4, 7, 12))
def test_rel_pos_index_equals_jax(ws):
    np.testing.assert_array_equal(ts._rel_pos_index(ws), js._rel_pos_index(ws))


@pytest.mark.parametrize("hp,wp,ws", ((8, 8, 4), (12, 16, 4), (24, 36, 12), (28, 42, 7)))
def test_shift_mask_equals_jax(hp, wp, ws):
    block = js.SwinBlock(8, 2, ws, ws // 2, 4.0, 0.0)
    ref = block.apply({}, hp, wp, method=js.SwinBlock._shift_mask)
    np.testing.assert_array_equal(ts._shift_mask(hp, wp, ws, ws // 2), np.asarray(ref))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_variant_tables_equal_jax(family):
    jcfg, _, pcfg, _ = FAMILIES[family]
    for name in VARIANTS[family]:
        j, p = jcfg.variant(name), pcfg.variant(name)
        for field in ("depths", "drop_path_rate", "out_indices"):
            assert getattr(j, field) == getattr(p, field), (name, field)
        assert j.num_channels() == p.num_channels(), name
        assert {k: v for k, v in vars(j).items() if k != "dtype"} == {
            k: v for k, v in vars(p).items() if k != "dtype"}, name
    with pytest.raises(KeyError):
        jcfg.variant(f"{family}_unknown")
    with pytest.raises(KeyError):
        pcfg.variant(f"{family}_unknown")


def test_depthwise_kernel_converts_to_torch_layout():
    """flax ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``, the same convolution."""
    k = np.random.default_rng(4).normal(size=(7, 7, 1, 6)).astype(np.float32)
    sd = params_from_jax({"dw": {"kernel": k}})
    assert tuple(sd["dw.weight"].shape) == (6, 1, 7, 7)
    np.testing.assert_array_equal(sd["dw.weight"].numpy()[2, 0], k[:, :, 0, 2])
