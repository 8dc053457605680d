"""The port's deformable attention (plain version of K1, and its module) held
against the JAX package: the exact gather, the Pallas-v2 windowed kernel in
interpret mode, the separable decoder path, and the flax ``MSDeformAttn``
module with the offset clamp on and off.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
Tolerances are float32 ones unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import richsem_tpu.ops.ms_deform_attn_pallas2 as mp2
from richsem_tpu.models.layers import MSDeformAttn as JaxMSDeformAttn
from richsem_tpu.models.transformer_utils import encoder_reference_points
from richsem_tpu.ops.ms_deform_attn import compute_sampling_locations
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu.ops.ms_deform_attn_sep import ms_deform_attn_sep
from richsem_tpu.ops.ms_deform_attn_tiled import tiled_supported as jax_tiled_supported
from richsem_tpu_torch.models.layers import MSDeformAttn
from richsem_tpu_torch.ops import ms_deform_attn as port
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

SHAPES = ((32, 24), (16, 12), (8, 6), (4, 3))  # tile (8, 8) plan is integral
B, M, D, P = 2, 4, 8, 4


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _softmax_aw(rng, b, q, m, n_lvl, p):
    a = rng.normal(size=(b, q, m, n_lvl * p)).astype(np.float32)
    a = np.exp(a - a.max(-1, keepdims=True))
    return (a / a.sum(-1, keepdims=True)).reshape(b, q, m, n_lvl, p)


def _s(shapes):
    return sum(h * w for h, w in shapes)


def test_plain_matches_jax_gather_with_out_of_bounds_taps():
    rng = np.random.default_rng(0)
    q = 53
    val = rng.normal(size=(B, _s(SHAPES), M, D)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (B, q, M, 4, P, 2)).astype(np.float32)
    aw = _softmax_aw(rng, B, q, M, 4, P)
    ref = np.asarray(jax_msda(jnp.asarray(val), SHAPES, jnp.asarray(loc), jnp.asarray(aw)))
    out = port.ms_deform_attn(_t(val), SHAPES, _t(loc), _t(aw)).numpy()
    assert out.shape == (B, q, M * D)
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_plain_bf16_value_keeps_value_dtype():
    rng = np.random.default_rng(1)
    q = 11
    val = rng.normal(size=(1, _s(SHAPES), M, D)).astype(np.float32)
    loc = rng.uniform(0.0, 1.0, (1, q, M, 4, P, 2)).astype(np.float32)
    aw = _softmax_aw(rng, 1, q, M, 4, P)
    vb = _t(val).to(torch.bfloat16)
    out = port.ms_deform_attn(vb, SHAPES, _t(loc), _t(aw))
    assert out.dtype == torch.bfloat16
    # f32 accumulation of the bf16-rounded values, then one bf16 rounding
    ref = port.ms_deform_attn(vb.float(), SHAPES, _t(loc), _t(aw))
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("ref_dim", [2, 4])
def test_compute_sampling_locations_parity(ref_dim):
    rng = np.random.default_rng(2)
    refs = rng.uniform(0.1, 0.9, (B, 13, 4, ref_dim)).astype(np.float32)
    offs = rng.normal(size=(B, 13, M, 4, P, 2)).astype(np.float32) * 3
    ref = compute_sampling_locations(jnp.asarray(refs), jnp.asarray(offs), SHAPES, P)
    out = port.compute_sampling_locations(_t(refs), _t(offs), SHAPES, P)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shapes,tile", [
    (SHAPES, (8, 8)),
    (((112, 168), (56, 84), (28, 42), (14, 21)), (16, 16)),  # flagship 896x1344
    (((12, 20), (6, 10), (3, 5), (2, 3)), (16, 16)),  # 96x160: not divisible by 64
    (((12, 12), (6, 6), (3, 3), (2, 2)), (16, 16)),
])
def test_tiled_supported_parity(shapes, tile):
    assert port.tiled_supported(shapes, tile) == jax_tiled_supported(shapes, tile)


@pytest.fixture
def _interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    monkeypatch.setattr(mp2.pl, "pallas_call", patched)


def test_plain_matches_pallas2_interpret(_interpret_mode):
    """Encoder case, Q == S, offsets within the clamp bound of margin 4: the
    windowed kernel is exact there, so it computes the port's function."""
    rng = np.random.default_rng(3)
    s = _s(SHAPES)
    val = rng.normal(size=(B, s, M, D)).astype(np.float32)
    refs = np.asarray(encoder_reference_points(SHAPES, jnp.ones((B, 4, 2), jnp.float32)))
    offs = (rng.uniform(-3.5, 3.5, (B, s, M, 4, P, 2)) * 0.9973 + 0.00137).astype(np.float32)
    loc = port.compute_sampling_locations(_t(refs), _t(offs), SHAPES, P)
    aw = _softmax_aw(rng, B, s, M, 4, P)
    ref = mp2.ms_deform_attn_pallas2(
        jnp.asarray(val), SHAPES, jnp.asarray(loc.numpy()), jnp.asarray(aw),
        tile=(8, 8), margin=4,
    )
    out = port.ms_deform_attn(_t(val), SHAPES, loc, _t(aw))
    # the tolerance of tests/test_msda_pallas2.py for the same comparison
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_decoder_case_matches_sep():
    """Decoder case: Q=37 queries, 4-d box references, unclamped offsets that
    send some taps out of bounds."""
    rng = np.random.default_rng(4)
    q = 37
    val = rng.normal(size=(B, _s(SHAPES), M, D)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.0, 1.0, (B, q, 4, 2)),
                            rng.uniform(0.05, 0.9, (B, q, 4, 2))], -1).astype(np.float32)
    offs = rng.normal(size=(B, q, M, 4, P, 2)).astype(np.float32) * 4
    loc = port.compute_sampling_locations(_t(boxes), _t(offs), SHAPES, P)
    assert ((loc < 0) | (loc > 1)).any()
    aw = _softmax_aw(rng, B, q, M, 4, P)
    ref = ms_deform_attn_sep(jnp.asarray(val), SHAPES, jnp.asarray(loc.numpy()),
                             jnp.asarray(aw))
    out = port.ms_deform_attn(_t(val), SHAPES, loc, _t(aw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_non_cpu_tensor_never_falls_back():
    """The wrapper runs the plain version only for CPU tensors."""
    val = torch.zeros(1, _s(SHAPES), M, D, device="meta")
    loc = torch.zeros(1, 3, M, 4, P, 2, device="meta")
    aw = torch.zeros(1, 3, M, 4, P, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port.ms_deform_attn(val, SHAPES, loc, aw)
    assert port.ms_deform_attn.launches == 0


def _module_params(rng, d, n_lvl, n_heads, n_pts, offset_gain):
    mlp = n_heads * n_lvl * n_pts

    def dense(i, o, gain=1.0):
        return {"kernel": rng.normal(size=(i, o)) / np.sqrt(i) * gain,
                "bias": rng.normal(size=(o,)) * 0.1}

    return {"params": {
        "value_proj": dense(d, d),
        # the flax init zeroes these kernels; noise makes the clamp and the
        # softmax do work
        "sampling_offsets": dense(d, 2 * mlp, offset_gain),
        "attention_weights": dense(d, mlp),
        "output_proj": dense(d, d),
    }}


@pytest.mark.parametrize("canvas,clamped", [((256, 192), True), ((96, 160), False)])
def test_module_parity(canvas, clamped):
    """flax MSDeformAttn(impl='pallas2') vs the port's module, encoder call.

    256x192 gives a pyramid on which the (8, 8) tile plan is integral, so the
    clamp to +-(margin - 0.5) binds; 96x160 is not divisible by 64 and the
    clamp must not apply (ROADMAP F2)."""
    d, n_lvl, n_heads, n_pts, margin, tile = 32, 4, 4, 4, 4, (8, 8)
    shapes = tuple((canvas[0] // s, canvas[1] // s) for s in (8, 16, 32)) + (
        ((canvas[0] // 32 + 1) // 2, (canvas[1] // 32 + 1) // 2),)
    assert jax_tiled_supported(shapes, tile) == clamped
    rng = np.random.default_rng(5)
    s = _s(shapes)
    src = rng.normal(size=(B, s, d)).astype(np.float32)
    pad = np.zeros((B, s), bool)
    pad[1, -7:] = True
    vr = np.ones((B, n_lvl, 2), np.float32)
    refs = np.asarray(encoder_reference_points(shapes, jnp.asarray(vr)))
    params = _module_params(rng, d, n_lvl, n_heads, n_pts, offset_gain=6.0)

    kw = dict(d_model=d, n_levels=n_lvl, n_heads=n_heads, n_points=n_pts,
              impl="pallas2", tiled_margin=margin, tiled_tile=tile)
    jax_mod = JaxMSDeformAttn(**kw)
    ref = jax.jit(lambda p, x, r, m: jax_mod.apply(p, x, r, x, shapes, m))(
        params, jnp.asarray(src), jnp.asarray(refs), jnp.asarray(pad)
    )
    mod = MSDeformAttn(**kw)
    mod.load_state_dict(params_from_jax(params, expected=mod.state_dict()))
    assert mod.clamps(s, s, shapes) == clamped
    with torch.no_grad():
        offsets = mod.sampling_offsets(_t(src))
        out = mod(_t(src), _t(refs), _t(src), shapes, torch.from_numpy(pad))
    # the offsets do reach past the bound, so the clamp (when on) changes the result
    assert float(offsets.abs().max()) > margin - 0.5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_plain_backward_repeats_bit_for_bit_across_threads():
    """The plain version's d_value adds every tap in a fixed order, whatever
    the number of threads: three backward passes at 4 threads over 64,000
    taps into 80 value rows (many taps a row) give the same gradient bit for
    bit. An indexed read's backward (``index_put_`` with accumulation) adds
    with atomics across threads, whose order changes from run to run."""
    rng = np.random.default_rng(7)
    shapes = ((8, 8), (4, 4))
    s, q = sum(h * w for h, w in shapes), 500
    value = _t(rng.normal(size=(1, s, 8, 32))).requires_grad_(True)
    loc = _t(rng.uniform(-0.1, 1.1, size=(1, q, 8, 2, 4, 2)))
    aw = _t(rng.uniform(size=(1, q, 8, 2, 4)))
    dy = _t(rng.normal(size=(1, q, 8 * 32)))
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        grads = []
        for _ in range(3):
            value.grad = None
            port.ms_deform_attn_plain(value, shapes, loc, aw).backward(dy)
            grads.append(value.grad.clone())
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(grads[0], g) for g in grads[1:])
