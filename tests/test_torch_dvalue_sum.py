"""The plain fixed-point d_value sum of K1-bwd and K3-bwd
(``ops/ms_deform_attn.py:ms_deform_attn_dvalue_plain``,
``ops/ms_deform_attn_sep.py:ms_deform_attn_sep_dvalue_plain``), the oracle
that ``chip_smoke.py`` holds the kernels' d_value to bit for bit.

* Against ``tests/msda_dvalue_pass.py``'s emulation of the pass, bit for bit,
  with the emulation's taps in three orders: F3's 256 x 384 canvas with a
  200 x 300 valid extent and every offset on the clamp's edge, unclamped
  decoder queries, K3 in f32 and bf16; a g or an attention weight that is
  not finite (NaN in every row a term reaches, with the kernels' bits); a row
  with no keyed tap, whose g K1-bwd leaves out of the bound; no keyed tap.
* Against the JAX package's VJPs: the exact gather (f32, within 1e-5 of the
  largest magnitude) and ``ms_deform_attn_sep_pallas`` in interpret mode (f32
  within 5e-5; bf16 within one bf16 step), the tolerances of
  ``test_torch_determinism.py``.
* Its shift ``dv_shift`` against the emulation's.

Inputs are drawn with numpy from fixed seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msda_dvalue_pass as dvalue_pass
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu.ops.ms_deform_attn_sep_pallas import ms_deform_attn_sep_pallas
from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
from richsem_tpu_torch.ops import ms_deform_attn as k1
from richsem_tpu_torch.ops import ms_deform_attn_sep as k3
from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios

F3_SHAPES = ((32, 48), (16, 24), (8, 12), (4, 6))  # the 256 x 384 canvas's pyramid
SEP_SHAPES = ((12, 10), (6, 5))


def _inputs(seed, q=None, shapes=F3_SHAPES, m=2, d=32, p=4):
    """F3's encoder (offsets on the clamp's edge, +-5.5 px, the reference
    points scaled by the levels' unequal valid ratios) or ``q`` unclamped
    decoder queries, some taps out of bounds. -> (val, loc, aw, g) f32."""
    rng = np.random.default_rng(seed)
    b, n_lvl = 2, len(shapes)
    s = sum(h * w for h, w in shapes)
    val = rng.normal(size=(b, s, m, d)).astype(np.float32)
    if q is None:
        q = s
        pad = torch.ones(b, 256, 384, dtype=torch.bool)
        pad[:, :200, :300] = False
        vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in shapes], 1)
        offs = np.where(rng.uniform(size=(b, s, m, n_lvl, p, 2)) < 0.5, 5.5, -5.5)
        loc = k1.compute_sampling_locations(encoder_reference_points(shapes, vr),
                                            torch.from_numpy(offs.astype(np.float32)),
                                            shapes, p).numpy()
    else:
        loc = rng.uniform(-0.1, 1.1, (b, q, m, n_lvl, p, 2)).astype(np.float32)
    a = rng.uniform(0.05, 1.0, (b, q, m, n_lvl * p))
    aw = (a / a.sum(-1, keepdims=True)).reshape(b, q, m, n_lvl, p).astype(np.float32)
    return val, loc, aw, rng.normal(size=(b, q, m * d)).astype(np.float32)


def _orders(n, which):
    if which == "taps":
        return np.arange(n)
    if which == "reversed":
        return np.arange(n)[::-1]
    return np.random.default_rng(3).permutation(n)


def _oracle(kernel, val, shapes, loc, aw, g, bf16=False):
    """The wrapper module's oracle on CPU tensors -> d_value in the value's dtype."""
    dt = torch.bfloat16 if bf16 else torch.float32
    fn = k1.ms_deform_attn_dvalue_plain if kernel == "k1" else k3.ms_deform_attn_sep_dvalue_plain
    out = fn(torch.from_numpy(val).to(dt), shapes, torch.from_numpy(loc), torch.from_numpy(aw),
             torch.from_numpy(g).to(dt))
    assert out.dtype == dt and out.shape == val.shape
    return out


def _emulated(kernel, val, shapes, loc, aw, g, bf16=False, order="taps"):
    if bf16:
        g = torch.from_numpy(g).bfloat16().float().numpy()
    return dvalue_pass.d_value(loc, aw, g, shapes, val.shape, kernel=kernel, bf16=bf16,
                               order=_orders(aw.size, order))


@pytest.mark.parametrize("case", ["f3_clamp_edge", "decoder"])
@pytest.mark.parametrize("order", ["taps", "reversed", "shuffled"])
def test_k1_oracle_matches_the_emulated_pass(case, order):
    """K1-bwd's oracle equals the emulated pass bit for bit, whatever order the
    emulation places the taps in."""
    shapes = F3_SHAPES
    val, loc, aw, g = _inputs(20, q=None if case == "f3_clamp_edge" else 50, shapes=shapes)
    got = _oracle("k1", val, shapes, loc, aw, g).numpy()
    np.testing.assert_array_equal(got, _emulated("k1", val, shapes, loc, aw, g, order=order))
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("order", ["taps", "reversed", "shuffled"])
def test_k3_oracle_matches_the_emulated_pass(order, dtype):
    """K3-bwd's oracle equals the emulated pass bit for bit in three orders; in
    bf16 after the one rounding of the sum."""
    bf16 = dtype == "bf16"
    val, loc, aw, g = _inputs(21, q=37, shapes=SEP_SHAPES)
    got = _oracle("k3", val, SEP_SHAPES, loc, aw, g, bf16).float().numpy()
    np.testing.assert_array_equal(
        got, _emulated("k3", val, SEP_SHAPES, loc, aw, g, bf16, order=order))
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("what", ["g", "aw"])
@pytest.mark.parametrize("kernel,dtype", [("k1", "f32"), ("k1", "bf16"), ("k3", "f32"),
                                          ("k3", "bf16")])
def test_oracle_with_a_bound_that_is_not_finite(kernel, dtype, what):
    """An infinity in g or in an attention weight (a step that diverged): every
    element of a row that a term reaches is NaN, with the kernels' bits
    (0x7fffffff in f32, 0x7fff in bf16), every other element 0, as in the
    emulated pass."""
    bf16 = dtype == "bf16"
    shapes = SEP_SHAPES
    val, loc, aw, g = _inputs(22, q=23, shapes=shapes)
    if what == "g":
        g[0, 0] = np.inf
    else:  # a tap inside its level
        aw[0, 0, 0, 0, 0] = np.inf
        loc[0, 0, 0, 0, 0] = 0.5
    got = _oracle(kernel, val, shapes, loc, aw, g, bf16)
    ref = _emulated(kernel, val, shapes, loc, aw, g, bf16)
    nan = np.isnan(ref)
    assert nan.any() and (ref[~nan] == 0).all()
    np.testing.assert_array_equal(np.isnan(got.float().numpy()), nan)
    ints = got.view(torch.int16 if bf16 else torch.int32).numpy()
    assert (ints[nan] == (0x7FFF if bf16 else 0x7FFFFFFF)).all()
    assert (ints[~nan] == 0).all()


def test_k1_bound_leaves_out_rows_without_a_keyed_tap():
    """K1-bwd takes max|g| over the rows (b, q, m) with a tap inside its level:
    a row whose taps all fall outside moves no shift, whatever its g (K3-bwd
    takes every row)."""
    shapes = F3_SHAPES
    val, loc, aw, g = _inputs(23, q=40, shapes=shapes)
    loc[0, 3, 1] = -0.5  # every tap of row (0, 3, 1) outside every level
    base = _oracle("k1", val, shapes, loc, aw, g).numpy()
    g.reshape(2, 40, 2, 32)[0, 3, 1] = 1e30
    got = _oracle("k1", val, shapes, loc, aw, g).numpy()
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(got, _emulated("k1", val, shapes, loc, aw, g))
    sep = _oracle("k3", val, shapes, loc, aw, g).numpy()  # the bound moves: another shift
    g.reshape(2, 40, 2, 32)[0, 3, 1] = 0
    assert not np.array_equal(sep, _oracle("k3", val, shapes, loc, aw, g).numpy())


@pytest.mark.parametrize("kernel", ["k1", "k3"])
def test_oracle_without_a_keyed_tap_is_zero(kernel):
    """No tap inside any level: d_value is all +0."""
    val, loc, aw, g = _inputs(24, q=5, shapes=SEP_SHAPES)
    loc[:] = 1.5
    got = _oracle(kernel, val, SEP_SHAPES, loc, aw, g)
    assert (got.view(torch.int32) == 0).all()


def test_k1_oracle_matches_jax_gather_on_f3_clamp_edge():
    """K1-bwd's oracle within 1e-5 of the largest magnitude of JAX's
    exact-gather VJP on F3's canvas, every tap on the clamp's edge."""
    val, loc, aw, g = _inputs(10, shapes=F3_SHAPES, m=4)
    got = _oracle("k1", val, F3_SHAPES, loc, aw, g).numpy()
    _, vjp = jax.vjp(lambda v: jax_msda(v, F3_SHAPES, jnp.asarray(loc), jnp.asarray(aw)),
                     jnp.asarray(val))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.fixture
def _interpret_mode(monkeypatch):
    import richsem_tpu.ops.ms_deform_attn_sep_pallas as sp
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    monkeypatch.setattr(sp.pl, "pallas_call", patched)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k3_oracle_matches_sep_pallas_vjp(_interpret_mode, dtype):
    """K3-bwd's oracle against the VJP of ``ms_deform_attn_sep_pallas`` in
    interpret mode: f32 within 5e-5 of the largest magnitude, bf16 within one
    bf16 step."""
    bf16 = dtype == "bf16"
    val, loc, aw, g = _inputs(11, q=37, shapes=SEP_SHAPES)
    if bf16:
        val, g = (torch.from_numpy(x).bfloat16().float().numpy() for x in (val, g))
    got = _oracle("k3", val, SEP_SHAPES, loc, aw, g, bf16).float().numpy()
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    _, vjp = jax.vjp(lambda v: ms_deform_attn_sep_pallas(v, SEP_SHAPES, jnp.asarray(loc),
                                                         jnp.asarray(aw)),
                     jnp.asarray(val, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0], np.float32)
    scale = np.abs(ref).max()
    if bf16:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * scale)


@pytest.mark.parametrize("mx,n", [(1.0, 1), (1.0, 2), (0.75, 3), (3.0e38, 4096), (1e-45, 1),
                                  (1e-45, 70_000), (6.1e-5, 17_600), (2.0 ** -126, 5),
                                  (np.float32(1 - 2 ** -24), 2 ** 20)])
def test_oracle_shift_matches_the_emulated_shift(mx, n):
    """The oracle's ``dv_shift`` (frexp's exponents in PyTorch) equals the
    emulation's, for one row and for a row of each count up to n."""
    got = k1.dv_shift(torch.tensor(mx, dtype=torch.float32), torch.tensor([n, 1, 2, 3]))
    want = [int(dvalue_pass.dv_shift(mx, c)) for c in (n, 1, 2, 3)]
    assert got.tolist() == want
