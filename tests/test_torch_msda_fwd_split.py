"""How K1 (``csrc/ms_deform_attn_fwd.cu``) splits the forward gather, emulated
in plain torch on the CPU and held against the JAX package: the exact gather
at encoder and decoder shapes and on F3's canvas (a 256 x 384 canvas whose
200 x 300 valid extent gives the levels different valid ratios), and the
Pallas-v2 windowed kernel in interpret mode inside its margin.

The emulation follows the kernel: a half-warp serves one (b, q, m) row and
takes its taps 16 at a time; the lane that loads a tap rounds its pixel
coordinate as PyTorch does (loc * size, then - 0.5); four lanes of eight
channels serve a tap, so lane group g (of 4) of the row takes taps 4 r + g in
rounds r = 0 .. 3, adds each corner's weighted channels in f32, in order,
with the weight zeroed for a corner or tap that is out; the groups then meet
in the kernel's shuffle tree (xor 4, then xor 8: ((g0 + g1) + (g2 + g3))).
The kernel's products are fused multiply-adds, the emulation's separate
ones: a rounding apart per product, far inside the f32 tolerance (5e-5, as
``chip_smoke.py`` holds the kernel to the plain version).

Inputs are drawn with numpy from fixed seeds and handed to both sides, with
offsets skewed off exact integer pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import richsem_tpu.ops.ms_deform_attn_pallas2 as mp2
from richsem_tpu.models.transformer_utils import encoder_reference_points
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu_torch.models.transformer_utils import (
    encoder_reference_points as encoder_reference_points_torch)
from richsem_tpu_torch.ops import ms_deform_attn as port
from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios

torch.set_num_threads(2)

SHAPES = ((32, 24), (16, 12), (8, 6), (4, 3))  # tile (8, 8) plan is integral
B, M, D, P = 2, 4, 32, 4
TOL = 5e-5  # f32


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _softmax_aw(rng, b, q):
    a = rng.normal(size=(b, q, M, 4 * P)).astype(np.float32)
    a = np.exp(a - a.max(-1, keepdims=True))
    return (a / a.sum(-1, keepdims=True)).reshape(b, q, M, 4, P)


def _encoder_inputs(seed, bound, shapes=SHAPES, vr=None):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in shapes)
    val = rng.normal(size=(B, s, M, D)).astype(np.float32)
    if vr is None:
        refs = _t(np.asarray(encoder_reference_points(shapes, jnp.ones((B, 4, 2), jnp.float32))))
    else:
        refs = encoder_reference_points_torch(shapes, vr)
    offs = rng.uniform(-bound, bound, (B, s, M, 4, P, 2)) * 0.9973 + 0.00137
    loc = port.compute_sampling_locations(refs, _t(offs), shapes, P).numpy()
    return val, loc, _softmax_aw(rng, B, s)


def _decoder_inputs(seed, q=37):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, sum(h * w for h, w in SHAPES), M, D)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.0, 1.0, (B, q, 4, 2)),
                            rng.uniform(0.05, 0.9, (B, q, 4, 2))], -1).astype(np.float32)
    offs = rng.normal(size=(B, q, M, 4, P, 2)).astype(np.float32) * 4
    loc = port.compute_sampling_locations(_t(boxes), _t(offs), SHAPES, P).numpy()
    assert ((loc < 0) | (loc > 1)).any()
    return val, loc, _softmax_aw(rng, B, q)


def _f3_inputs(seed):
    shapes = ((32, 48), (16, 24), (8, 12), (4, 6))
    pad = torch.ones(B, 256, 384, dtype=torch.bool)
    pad[:, :200, :300] = False
    vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in shapes], 1)
    return shapes, _encoder_inputs(seed, 5.5, shapes, vr)


def _k1_fwd_emulated(val, loc, aw, shapes):
    """K1's split in plain torch (f32 in, f32 out [B, Q, M * D])."""
    val, loc, aw = (torch.from_numpy(np.asarray(x, np.float32)) for x in (val, loc, aw))
    b_, s_, m_, d_ = val.shape
    q_, n_lvl, p_ = loc.shape[1], loc.shape[3], loc.shape[4]
    lanes = 4  # a tap's lanes, eight channels each
    lp, groups = n_lvl * p_, 16 // lanes
    rows = b_ * q_ * m_
    locr, awr = loc.reshape(rows, lp, 2), aw.reshape(rows, lp)
    row = torch.arange(rows)
    bi, mi = row // (q_ * m_), row % m_
    starts = np.concatenate([[0], np.cumsum([h * w for h, w in shapes])])
    flat = val.reshape(b_ * s_ * m_, d_)  # rows (b, token, m)
    acc = torch.zeros(rows, groups, d_)
    for t0 in range(0, lp, 16):
        for r in range(lanes):  # a group's rounds, in order
            for g in range(groups):
                t = t0 + r * groups + g
                if t >= lp:
                    continue  # weight 0: adds nothing
                lvl = t // p_
                h, w = shapes[lvl]
                x = locr[:, t, 0] * w - 0.5  # two roundings, as pixel() in msda_common.cuh
                y = locr[:, t, 1] * h - 0.5
                ok = (x > -1) & (x < w) & (y > -1) & (y < h)
                x, y = torch.where(ok, x, 0.0), torch.where(ok, y, 0.0)
                a = torch.where(ok, awr[:, t], 0.0)
                x0, y0 = torch.floor(x), torch.floor(y)
                dx, dy = x - x0, y - y0
                wk = [(1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx]
                for e in range(4):  # corners in order
                    cx, cy = x0.long() + (e & 1), y0.long() + (e >> 1)
                    inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                    tok = starts[lvl] + cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)
                    cw = torch.where(inb, a * wk[e], 0.0)
                    acc[:, g] = acc[:, g] + cw[:, None] * flat[(bi * s_ + tok) * m_ + mi]
    while acc.shape[1] > 1:  # the shuffle tree: xor over the groups, lowest first
        acc = acc[:, 0::2] + acc[:, 1::2]
    return acc[:, 0].reshape(b_, q_, m_ * d_)


def _plain(val, loc, aw, shapes, dtype=torch.float32):
    return port.ms_deform_attn_plain(_t(val).to(dtype), shapes, _t(loc), _t(aw))


def _jax(val, loc, aw, shapes):
    return np.asarray(jax_msda(jnp.asarray(val), shapes, jnp.asarray(loc), jnp.asarray(aw)))


@pytest.mark.parametrize("case", ["encoder", "decoder", "f3"])
def test_k1_split_matches_plain_and_jax_gather(case):
    """f32, to 5e-5: the clamped encoder; the unclamped decoder with taps out of
    bounds; F3's canvas, where the TPU kernel's windows drop taps and K1 keeps
    every one."""
    shapes = SHAPES
    if case == "f3":
        shapes, inputs = _f3_inputs(11)
    elif case == "decoder":
        inputs = _decoder_inputs(12)
    else:
        inputs = _encoder_inputs(13, 5.5)
    out = _k1_fwd_emulated(*inputs, shapes).numpy()
    np.testing.assert_allclose(out, _plain(*inputs, shapes).numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(out, _jax(*inputs, shapes), rtol=0, atol=TOL)


@pytest.mark.parametrize("p", [3, 5])
def test_k1_split_ragged_tap_chunks(p):
    """A tap count that is not a multiple of 16 (L * P = 12 or 20): the last
    16-tap chunk is partly empty and its spare lanes carry weight 0. Decoder
    inputs with taps out of bounds, f32, to 5e-5 against the plain version
    and JAX's exact gather."""
    val, loc, aw = _decoder_inputs(16 + p)
    loc, aw = loc[:, :, :, :, :p].copy(), aw[:, :, :, :, :p].copy()
    out = _k1_fwd_emulated(val, loc, aw, SHAPES).numpy()
    np.testing.assert_allclose(out, _plain(val, loc, aw, SHAPES).numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(out, _jax(val, loc, aw, SHAPES), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["encoder", "decoder", "f3"])
def test_k1_split_bf16_is_one_rounding_of_the_f32_sum(case):
    """A bf16 value: the kernel sums the bf16 values in f32 and rounds the sum
    once; against the plain version in bf16, at most one bf16 step apart
    (chip_smoke.py's 1e-2 + 1e-2 * |plain|)."""
    shapes = SHAPES
    if case == "f3":
        shapes, (val, loc, aw) = _f3_inputs(19)
    elif case == "decoder":
        val, loc, aw = _decoder_inputs(20)
    else:
        val, loc, aw = _encoder_inputs(14, 5.5)
    val = _t(val).to(torch.bfloat16).float().numpy()
    out = _k1_fwd_emulated(val, loc, aw, shapes).to(torch.bfloat16).float()
    ref = _plain(val, loc, aw, shapes, torch.bfloat16).float()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-2, atol=1e-2)


@pytest.fixture
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    monkeypatch.setattr(mp2.pl, "pallas_call", patched)


def test_k1_split_matches_pallas2_interpret(_interpret_mode):
    """Offsets inside the windowed kernel's margin on a canvas that F3 does not
    touch: the emulated K1 against ``ms_deform_attn_pallas2`` in interpret
    mode, at the tolerance the plain version is held to there (2e-3)."""
    val, loc, aw = _encoder_inputs(15, 3.5)
    ref = mp2.ms_deform_attn_pallas2(jnp.asarray(val), SHAPES, jnp.asarray(loc),
                                     jnp.asarray(aw), tile=(8, 8), margin=4)
    out = _k1_fwd_emulated(val, loc, aw, SHAPES).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_k1_head_dim_other_than_32_raises_before_launching():
    """K1 and K1-bwd take a head dim of 32 only (ROADMAP F-P5): the wrappers'
    check refuses another before any kernel is built."""
    value = torch.empty(1, 12, 2, 16, device="meta")
    with pytest.raises(ValueError, match="head dim of 32"):
        port._check_head_dim(value)
    assert port.ms_deform_attn.launches == 0
