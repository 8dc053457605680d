"""The gradient of the port's deformable attention (the plain version of K1,
whose autograd gradient is what K1-bwd computes on the card) held against
three JAX paths: the VJP of the exact gather, the Pallas-v2 windowed kernel's
VJP in interpret mode (clamped, in-window offsets on a pyramid whose valid
extent is the whole canvas, ROADMAP F3), and the separable decoder path at
decoder shapes (box references, unclamped offsets, taps out of bounds).

A test-local emulation of how K1-bwd splits the work (16-query blocks, eight
lanes a tap with four channels each, the lanes' shuffle tree, and d_value
from the deterministic pass of ``tests/msda_dvalue_pass.py``: the taps listed
by their top-left corner, each element's terms summed in fixed point) is
held against the same VJPs, on F3's canvas too, where it must match the
exact gather that the TPU kernel's windows miss.

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

import msda_dvalue_pass as dvalue_pass
import richsem_tpu.ops.ms_deform_attn_pallas2 as mp2
from richsem_tpu.models.transformer_utils import encoder_reference_points
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu.ops.ms_deform_attn_sep import ms_deform_attn_sep
from richsem_tpu_torch.models.layers import clip
from richsem_tpu_torch.models.transformer_utils import (
    encoder_reference_points as encoder_reference_points_torch)
from richsem_tpu_torch.ops import ms_deform_attn as port
from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios

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


def _encoder_inputs(seed, bound, d=D):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, S, M, d)).astype(np.float32)
    refs = np.asarray(encoder_reference_points(SHAPES, jnp.ones((B, 4, 2), jnp.float32)))
    offs = (rng.uniform(-bound, bound, (B, S, M, 4, P, 2)) * 0.9973 + 0.00137)
    loc = port.compute_sampling_locations(_t(refs), _t(offs), SHAPES, P).numpy()
    return val, loc, _softmax_aw(rng, B, S), rng.normal(size=(B, S, M * d)).astype(np.float32)


def _decoder_inputs(seed, q=37, d=D):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, S, M, d)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.0, 1.0, (B, q, 4, 2)),
                            rng.uniform(0.05, 0.9, (B, q, 4, 2))], -1).astype(np.float32)
    offs = rng.normal(size=(B, q, M, 4, P, 2)).astype(np.float32) * 4
    loc = port.compute_sampling_locations(_t(boxes), _t(offs), SHAPES, P).numpy()
    assert ((loc < 0) | (loc > 1)).any()
    return val, loc, _softmax_aw(rng, B, q), rng.normal(size=(B, q, M * d)).astype(np.float32)


def _port_grads(val, loc, aw, g):
    leaves = [_t(x).requires_grad_() for x in (val, loc, aw)]
    out = port.ms_deform_attn(leaves[0], SHAPES, leaves[1], leaves[2])
    return [t.numpy() for t in torch.autograd.grad(out, leaves, _t(g))]


def _jax_grads(fn, val, loc, aw, g, shapes=SHAPES):
    _, vjp = jax.vjp(lambda v, l, a: fn(v, shapes, l, a),
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


def _k1_bwd_direct(val, loc, aw, g, shapes, tile=16):
    """How K1-bwd splits the work, in plain torch on the CPU (f32). A block is
    one (b, m) and ``tile`` queries; eight lanes take a tap, lane k channels
    4k .. 4k + 3. Each lane sums its four channels' products in order, and the
    lanes' sums meet in K1-bwd's shuffle tree (xor 1, then 2, then 4) for d_aw
    and d_loc; d_value comes from the deterministic pass (the taps listed by
    key in a shuffled order, each element's terms (w_k * aw) * g summed in
    fixed point). -> (d_value, d_loc, d_aw, blocks)."""
    d_value = dvalue_pass.d_value(
        loc, aw, g, shapes, np.shape(val),
        order=np.random.default_rng(0).permutation(np.asarray(aw).size))
    val, loc, aw, g = (torch.from_numpy(np.asarray(x, np.float32)) for x in (val, loc, aw, g))
    b_, s_, m_, d_ = val.shape
    q_, p_ = loc.shape[1], loc.shape[4]
    lanes = d_ // 4
    assert d_ == 32 and lanes == 8
    starts = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])])
    gq = g.view(b_, q_, m_, lanes, 4)
    flat = val.reshape(-1, 4)  # rows (b, token, m, lane)
    d_loc, d_aw = torch.zeros_like(loc), torch.zeros_like(aw)
    bi = torch.arange(b_)[:, None, None, None, None]
    mi = torch.arange(m_)[None, None, :, None, None]
    ki = torch.arange(lanes)[None, None, None, None, :]

    def tree(v):  # [..., 8 lanes] -> the value lane 0 holds after the shuffles
        v = v[..., 0::2] + v[..., 1::2]
        v = v[..., 0::2] + v[..., 1::2]
        return v[..., 0] + v[..., 1]

    blocks = 0
    for q0 in range(0, q_, tile):
        qs = slice(q0, min(q0 + tile, q_))
        blocks += b_ * m_
        for lvl, (h, w) in enumerate(shapes):
            x = loc[:, qs, :, lvl, :, 0] * w - 0.5  # [B, T, M, P]
            y = loc[:, qs, :, lvl, :, 1] * h - 0.5
            a = aw[:, qs, :, lvl]
            inside = ((x > -1) & (x < w) & (y > -1) & (y < h))[..., None]
            x0, y0 = torch.floor(x), torch.floor(y)
            dx, dy = (x - x0)[..., None, None], (y - y0)[..., None, None]
            cx = [x0, x0 + 1, x0, x0 + 1]
            cy = [y0, y0, y0 + 1, y0 + 1]
            wk = [(1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx]
            gg = gq[:, qs, :, None]  # [B, T, M, 1, 8, 4]
            v = []
            for c in range(4):
                ok = inside & ((cx[c] >= 0) & (cx[c] < w) & (cy[c] >= 0) & (cy[c] < h))[..., None]
                tok = starts[lvl] + (cy[c].clamp(0, h - 1) * w + cx[c].clamp(0, w - 1)).long()
                row = ((bi * s_ + tok[..., None]) * m_ + mi) * lanes + ki  # [B, T, M, P, 8]
                v.append(torch.where(ok[..., None], flat[row], 0.0))
            s_aw = torch.zeros(v[0].shape[:-1])
            s_x, s_y = torch.zeros_like(s_aw), torch.zeros_like(s_aw)
            for i in range(4):  # a lane's four channels, in order
                vi = [t[..., i] for t in v]
                gi = gg[..., i]
                s_aw = s_aw + gi * (wk[0][..., 0] * vi[0] + wk[1][..., 0] * vi[1]
                                    + wk[2][..., 0] * vi[2] + wk[3][..., 0] * vi[3])
                s_x = s_x + gi * ((1 - dy[..., 0]) * (vi[1] - vi[0]) + dy[..., 0] * (vi[3] - vi[2]))
                s_y = s_y + gi * ((1 - dx[..., 0]) * (vi[2] - vi[0]) + dx[..., 0] * (vi[3] - vi[1]))
            s_aw, s_x, s_y = (torch.where(inside, t, 0.0) for t in (s_aw, s_x, s_y))
            d_aw[:, qs, :, lvl] = tree(s_aw)
            d_loc[:, qs, :, lvl, :, 0] = a * tree(s_x) * w
            d_loc[:, qs, :, lvl, :, 1] = a * tree(s_y) * h
    return d_value, d_loc.numpy(), d_aw.numpy(), blocks


def _f3_inputs(seed, bound=5.5, d=D):
    """F3's geometry: a 256 x 384 canvas whose valid extent is 200 x 300, so
    the levels' valid ratios differ and the windowed TPU kernel drops taps."""
    shapes = ((32, 48), (16, 24), (8, 12), (4, 6))
    pad = torch.ones(B, 256, 384, dtype=torch.bool)
    pad[:, :200, :300] = False
    vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in shapes], 1)
    s = sum(h * w for h, w in shapes)
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, s, M, d)).astype(np.float32)
    refs = encoder_reference_points_torch(shapes, vr)
    offs = rng.uniform(-bound, bound, (B, s, M, 4, P, 2)) * 0.9973 + 0.00137
    loc = port.compute_sampling_locations(refs, _t(offs), shapes, P).numpy()
    return shapes, (val, loc, _softmax_aw(rng, B, s), rng.normal(size=(B, s, M * d)).astype(np.float32))



@pytest.mark.parametrize("case", ["encoder", "decoder", "f3", "encoder-bf16"])
def test_k1_bwd_split_matches_jax_gather_vjp(case):
    """The emulated K1-bwd against the VJP of the JAX exact gather (f32; the
    same products summed in another order, TOL): the clamped encoder, the
    unclamped decoder with taps out of bounds and a query count that is not a
    multiple of the block's 16, and F3's canvas, where the TPU kernel's windows
    drop taps and K1-bwd keeps every one. encoder-bf16: the kernel reads a
    bf16 value and gradient and its wrapper rounds the f32 d_value to bf16
    once (2^-8 relative)."""
    shapes = SHAPES
    if case == "f3":
        shapes, inputs = _f3_inputs(7, d=32)
    elif case == "decoder":
        inputs = _decoder_inputs(9, q=37, d=32)
    else:
        inputs = _encoder_inputs(6, 5.5, d=32)
    tol = TOL
    if case == "encoder-bf16":
        val, loc, aw, g = inputs
        val, g = (_t(x).to(torch.bfloat16).float().numpy() for x in (val, g))
        inputs = (val, loc, aw, g)
    d_value, d_loc, d_aw, blocks = _k1_bwd_direct(*inputs, shapes)
    q = inputs[1].shape[1]
    assert blocks == B * M * -(-q // 16)
    ref = _jax_grads(jax_msda, *inputs, shapes=shapes)
    if case == "encoder-bf16":
        d_value = _t(d_value).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(d_value, ref[0], rtol=2 ** -8,
                                   atol=TOL * np.abs(ref[0]).max(), err_msg="d_value")
        d_value = ref[0]
    _close([d_value, d_loc, d_aw], ref, tol)


def test_k1_bwd_split_matches_pallas2_vjp_interpret(_interpret_mode):
    """On a canvas that F3 does not touch (valid extent = canvas), with offsets
    inside the windowed kernel's margin, the emulated K1-bwd matches the VJP of
    ``ms_deform_attn_pallas2`` in interpret mode."""
    inputs = _encoder_inputs(8, 3.5, d=32)
    d_value, d_loc, d_aw, _ = _k1_bwd_direct(*inputs, SHAPES)
    ref = _jax_grads(lambda v, s, l, a: mp2.ms_deform_attn_pallas2(
        v, s, l, a, tile=(8, 8), margin=4), *inputs)
    _close([d_value, d_loc, d_aw], ref, TOL)
