"""The gradient of the port's deformable attention (the plain version of K1,
whose autograd gradient is what K1-bwd computes on the card) held against
three JAX paths: the VJP of the exact gather, the Pallas-v2 windowed kernel's
VJP in interpret mode (clamped, in-window offsets on a pyramid whose valid
extent is the whole canvas, ROADMAP F3), and the separable decoder path at
decoder shapes (box references, unclamped offsets, taps out of bounds).

Inputs and the upstream gradient are drawn with numpy from fixed seeds and
handed to both sides. Offsets are skewed off exact integer pixels, where the
floor-based bilinear derivative and the windowed kernel's tent derivative
pick different subgradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import richsem_tpu.ops.ms_deform_attn_pallas2 as mp2
from richsem_tpu.models.transformer_utils import encoder_reference_points
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu.ops.ms_deform_attn_sep import ms_deform_attn_sep
from richsem_tpu_torch.models.layers import clip
from richsem_tpu_torch.ops import ms_deform_attn as port

torch.set_num_threads(2)

SHAPES = ((32, 24), (16, 12), (8, 6), (4, 3))  # tile (8, 8) plan is integral
S = sum(h * w for h, w in SHAPES)
B, M, D, P = 2, 4, 8, 4
# f32: both sides sum the same products in another order
TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _softmax_aw(rng, b, q):
    a = rng.normal(size=(b, q, M, 4 * P)).astype(np.float32)
    a = np.exp(a - a.max(-1, keepdims=True))
    return (a / a.sum(-1, keepdims=True)).reshape(b, q, M, 4, P)


def _encoder_inputs(seed, bound):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, S, M, D)).astype(np.float32)
    refs = np.asarray(encoder_reference_points(SHAPES, jnp.ones((B, 4, 2), jnp.float32)))
    offs = (rng.uniform(-bound, bound, (B, S, M, 4, P, 2)) * 0.9973 + 0.00137)
    loc = port.compute_sampling_locations(_t(refs), _t(offs), SHAPES, P).numpy()
    return val, loc, _softmax_aw(rng, B, S), rng.normal(size=(B, S, M * D)).astype(np.float32)


def _decoder_inputs(seed, q=37):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, S, M, D)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.0, 1.0, (B, q, 4, 2)),
                            rng.uniform(0.05, 0.9, (B, q, 4, 2))], -1).astype(np.float32)
    offs = rng.normal(size=(B, q, M, 4, P, 2)).astype(np.float32) * 4
    loc = port.compute_sampling_locations(_t(boxes), _t(offs), SHAPES, P).numpy()
    assert ((loc < 0) | (loc > 1)).any()
    return val, loc, _softmax_aw(rng, B, q), rng.normal(size=(B, q, M * D)).astype(np.float32)


def _port_grads(val, loc, aw, g):
    leaves = [_t(x).requires_grad_() for x in (val, loc, aw)]
    out = port.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    return [t.numpy() for t in torch.autograd.grad(out, leaves, _t(g))]


def _jax_grads(fn, val, loc, aw, g):
    _, vjp = jax.vjp(lambda v, l, a: fn(v, SHAPES, l, a),
                     jnp.asarray(val), jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _close(out, ref, tol):
    for o, r, name in zip(out, ref, ("d_value", "d_loc", "d_aw"), strict=True):
        # d_loc is scaled by the level's size (up to 32 here): relative there
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol * max(1.0, np.abs(r).max()),
                                   err_msg=name)


@pytest.mark.parametrize("case", ["encoder", "decoder"])
def test_plain_grad_matches_jax_gather_vjp(case):
    inputs = _encoder_inputs(0, 5.5) if case == "encoder" else _decoder_inputs(1)
    _close(_port_grads(*inputs), _jax_grads(jax_msda, *inputs), TOL)


@pytest.fixture
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    monkeypatch.setattr(mp2.pl, "pallas_call", patched)


@pytest.mark.parametrize("tile,margin", [((8, 8), 4), ((16, 8), 6)])
def test_plain_grad_matches_pallas2_vjp_interpret(_interpret_mode, tile, margin):
    """Offsets within the clamp bound: the windowed kernel is exact there, and
    its VJP is the gradient K1-bwd computes."""
    inputs = _encoder_inputs(2, margin - 0.5)
    ref = _jax_grads(lambda v, s, l, a: mp2.ms_deform_attn_pallas2(
        v, s, l, a, tile=tile, margin=margin), *inputs)
    _close(_port_grads(*inputs), ref, TOL)


def test_plain_grad_matches_sep_at_decoder_shapes():
    inputs = _decoder_inputs(3, q=61)
    _close(_port_grads(*inputs), _jax_grads(ms_deform_attn_sep, *inputs), TOL)


def test_bf16_value_grad_is_folded_in_f32():
    """A bf16 value gets a bf16 d_value that is the f32 gradient rounded once."""
    val, loc, aw, g = _encoder_inputs(4, 3.0)
    vb = _t(val).to(torch.bfloat16)
    leaves = [vb.clone().requires_grad_(), _t(loc), _t(aw)]
    out = port.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    (dv,) = torch.autograd.grad(out, leaves[:1], _t(g).to(torch.bfloat16))
    assert dv.dtype == torch.bfloat16
    ref = _port_grads(vb.float().numpy(), loc, aw, _t(g).to(torch.bfloat16).float().numpy())[0]
    # one bf16 rounding of the f32 sum: 2^-8 relative
    np.testing.assert_allclose(dv.float().numpy(), ref, rtol=2 ** -8, atol=1e-6)


def test_clip_has_jnp_clip_gradient_at_the_bound():
    """The encoder's offset clamp: same values as jnp.clip, and the same
    gradient, 1/2 at a value equal to a bound (layers.py:170-172)."""
    x = np.asarray([-7.0, -5.5, -1.25, 0.0, 5.5, 9.0], np.float32)
    lo, hi = -5.5, 5.5
    xt = _t(x).requires_grad_()
    y = clip(xt, lo, hi)
    (gx,) = torch.autograd.grad(y.sum(), [xt])
    y_ref, vjp = jax.vjp(lambda v: jnp.clip(v, lo, hi), jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(vjp(jnp.ones_like(y_ref))[0]))


def test_backward_wrapper_never_runs_on_the_cpu():
    """K1-bwd called directly takes CUDA tensors only; nothing was launched."""
    val, loc, aw, g = _decoder_inputs(5, q=3)
    with pytest.raises(RuntimeError, match="no kernel"):
        port.ms_deform_attn_backward(_t(val), SHAPES, _t(loc), _t(aw), _t(g))
    assert port.ms_deform_attn_backward.launches == 0
