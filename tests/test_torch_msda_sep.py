"""The port's separable decoder sampler (the plain version of K3 and K3-bwd)
held against ``richsem_tpu/ops/ms_deform_attn_sep_pallas.py`` run in Pallas
interpret mode, as the JAX package's own tests run it on the CPU.

The plain version repeats the TPU kernel's cast points (``hxw`` and ``rh``
rounded to the value's dtype, ``r`` and the sums in f32), so in bf16 the two
differ only where an f32 sum taken in another order rounds to the other side
of a bf16 step. Its backward is the TPU kernel's explicit one, whose hat
derivative is 0 at ``|diff| = 0`` and at ``|diff| = 1``; the special-point
cases put samples exactly there.

The module test runs in f32, where the JAX model's CPU route (the XLA ``sep``
composition, ``layers.py:207``) and ``sep_pallas`` compute the same function
(ROADMAP F7: in bf16 they round at other points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.layers import MSDeformAttn as JaxMSDeformAttn
from richsem_tpu.ops.ms_deform_attn_sep_pallas import ms_deform_attn_sep_pallas
from richsem_tpu_torch.models.layers import MSDeformAttn
from richsem_tpu_torch.ops import ms_deform_attn_sep as port
from richsem_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

SHAPES = ((12, 10), (6, 5), (3, 3))
S = sum(h * w for h, w in SHAPES)
B, M, D, P, Q = 2, 2, 8, 3, 11
L = len(SHAPES)


def _inputs(seed, q=Q, lo=-0.15, hi=1.15):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(B, S, M, D)).astype(np.float32)
    loc = rng.uniform(lo, hi, (B, q, M, L, P, 2)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, (B, q, M, L, P)).astype(np.float32)
    aw = (a / a.sum(axis=(-2, -1), keepdims=True)).astype(np.float32)
    g = rng.normal(size=(B, q, M * D)).astype(np.float32)
    return val, loc, aw, g


def _special_loc(seed):
    """Samples at exact pixel centres (diff 0), exactly one pixel from a tap
    (|diff| = 1 on the level's border), on integer pixel coordinates of every
    level, and outside the level."""
    rng = np.random.default_rng(seed)
    loc = np.empty((B, Q, M, L, P, 2), np.float32)
    for lvl, (h, w) in enumerate(SHAPES):
        for axis, size in ((0, w), (1, h)):
            # pixel c -> loc = (c + 0.5) / size; c = -1 and c = size are |diff| = 1
            # from the border taps, c beyond them is out
            pix = rng.integers(-2, size + 2, (B, Q, M, P)).astype(np.float32)
            frac = rng.choice([0.0, 0.0, 0.25, 0.5], size=pix.shape).astype(np.float32)
            loc[:, :, :, lvl, :, axis] = (pix + frac + 0.5) / size
    return loc


def _jax_fwd(val, loc, aw, dtype):
    return np.asarray(ms_deform_attn_sep_pallas(
        jnp.asarray(val, dtype), SHAPES, jnp.asarray(loc), jnp.asarray(aw)
    ).astype(jnp.float32))


def _port_fwd(val, loc, aw, dtype):
    out = port.ms_deform_attn_sep(torch.from_numpy(val).to(dtype), SHAPES,
                                  torch.from_numpy(loc), torch.from_numpy(aw))
    assert out.dtype == dtype
    return out.float().numpy()


def _check_fwd(val, loc, aw, dtype):
    got = _port_fwd(val, loc, aw, dtype)
    want = _jax_fwd(val, loc, aw, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    scale = np.abs(want).max()
    if dtype == torch.float32:
        # the same products; the sum over points in another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    else:
        # at most one bf16 step (2^-8 relative) where the f32 sums round apart
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6 * scale)
        assert np.mean(got == want) > 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_matches_sep_pallas(dtype):
    val, loc, aw, _ = _inputs(0)
    _check_fwd(val, loc, aw, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_forward_special_points(dtype):
    val, _, aw, _ = _inputs(1)
    loc = _special_loc(2)
    _check_fwd(val, loc, aw, dtype)


def test_forward_is_row_chunked(monkeypatch):
    """More than one row chunk gives the single-chunk result (to the f32
    rounding of products that the matrix library fuses differently by shape)."""
    val, loc, aw, g = _inputs(3, q=16)
    args = (torch.from_numpy(val), SHAPES, torch.from_numpy(loc), torch.from_numpy(aw))
    one = port.ms_deform_attn_sep_plain(*args)
    grads_one = port.ms_deform_attn_sep_backward_plain(*args, torch.from_numpy(g))
    monkeypatch.setattr(port, "_CK_TARGET", 5)
    assert port._num_chunks(16 * P) > 1
    torch.testing.assert_close(port.ms_deform_attn_sep_plain(*args), one, rtol=1e-6, atol=1e-6)
    for a, b in zip(port.ms_deform_attn_sep_backward_plain(*args, torch.from_numpy(g)),
                    grads_one):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _jax_vjp(val, loc, aw, g, dtype):
    v = jnp.asarray(val, dtype)
    _, vjp = jax.vjp(lambda v_, l_, a_: ms_deform_attn_sep_pallas(v_, SHAPES, l_, a_),
                     v, jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, dtype))]


@pytest.mark.parametrize("case", ["random", "special"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_sep_pallas_vjp(dtype, case):
    """The explicit backward (what K3-bwd computes), through autograd of the
    public op, against JAX's VJP of ``sep_pallas``."""
    val, loc, aw, g = _inputs(4)
    if case == "special":
        loc = _special_loc(5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = _jax_vjp(val, loc, aw, g, jdt)
    v = torch.from_numpy(val).to(dtype).requires_grad_()
    lt = torch.from_numpy(loc).requires_grad_()
    at = torch.from_numpy(aw).requires_grad_()
    out = port.ms_deform_attn_sep(v, SHAPES, lt, at)
    got = torch.autograd.grad(out, (v, lt, at), torch.from_numpy(g).to(dtype))
    for name, a, b in zip(("d_value", "d_loc", "d_aw"), got, want):
        a = a.float().numpy()
        # f32: the same products summed in another order; bf16: d_value is
        # rounded once to bf16 and may land one step (2^-8) apart
        rel = 1e-5 if dtype == torch.float32 else 2 ** -7
        np.testing.assert_allclose(a, b, rtol=rel, atol=1e-5 * np.abs(b).max(), err_msg=name)


def test_dhat_is_zero_at_a_tie():
    """A sample one pixel from a tap: autograd of max/abs would give that tap
    a derivative of +-1/2; the TPU kernel's and the port's is 0."""
    val = np.zeros((1, S, 1, 1), np.float32)
    val[0, 1, 0, 0] = 1.0  # level 0, pixel (y 0, x 1)
    loc = np.zeros((1, 1, 1, L, 1, 2), np.float32)
    loc[..., 0] = 0.5 / 10  # x = 0: tap x 1 is at |diff| = 1
    loc[..., 1] = 0.5 / 12
    aw = np.ones((1, 1, 1, L, 1), np.float32)
    _, d_loc, _ = port.ms_deform_attn_sep_backward_plain(
        torch.from_numpy(val), SHAPES, torch.from_numpy(loc), torch.from_numpy(aw),
        torch.ones(1, 1, 1))
    assert float(d_loc[0, 0, 0, 0, 0, 0]) == 0.0
    want = _jax_vjp(val, loc, aw, np.ones((1, 1, 1), np.float32), jnp.float32)[1]
    assert want[0, 0, 0, 0, 0, 0] == 0.0


def test_module_sep_pallas_matches_jax():
    """MSDeformAttn(impl='sep_pallas') as a decoder cross-attention (box
    references, unclamped offsets) against the flax module, f32."""
    d, n_heads, n_pts = 16, 2, 3
    rng = np.random.default_rng(6)
    mlp = n_heads * L * n_pts

    def dense(i, o, gain=1.0):
        return {"kernel": rng.normal(size=(i, o)) / np.sqrt(i) * gain,
                "bias": rng.normal(size=(o,)) * 0.1}

    params = {"params": {"value_proj": dense(d, d), "sampling_offsets": dense(d, 2 * mlp, 3.0),
                         "attention_weights": dense(d, mlp), "output_proj": dense(d, d)}}
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    q = 9
    query = rng.normal(size=(B, q, d)).astype(np.float32)
    src = rng.normal(size=(B, S, d)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.1, 0.9, (B, q, 1, 2)),
                            rng.uniform(0.1, 0.6, (B, q, 1, 2))], -1)
    refs = np.repeat(boxes, L, axis=2).astype(np.float32)
    pad = np.zeros((B, S), bool)
    pad[1, -4:] = True
    kw = dict(d_model=d, n_levels=L, n_heads=n_heads, n_points=n_pts, impl="sep_pallas")
    jax_mod = JaxMSDeformAttn(**kw)
    ref = jax_mod.apply(params, jnp.asarray(query), jnp.asarray(refs), jnp.asarray(src),
                        SHAPES, jnp.asarray(pad))
    mod = MSDeformAttn(**kw)
    mod.load_state_dict(params_from_jax(params, expected=mod.state_dict()))
    out = mod(torch.from_numpy(query), torch.from_numpy(refs), torch.from_numpy(src),
              SHAPES, torch.from_numpy(pad))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    out.sum().backward()  # the explicit backward runs through the module
    assert torch.isfinite(mod.sampling_offsets.weight.grad).all()


def test_non_cpu_tensor_never_falls_back():
    """The wrapper runs the plain version only for CPU tensors."""
    val = torch.zeros(1, S, M, D, device="meta")
    loc = torch.zeros(1, 3, M, L, P, 2, device="meta")
    aw = torch.zeros(1, 3, M, L, P, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port.ms_deform_attn_sep(val, SHAPES, loc, aw)
    with pytest.raises(RuntimeError, match="no kernel"):
        port.ms_deform_attn_sep_backward(val, SHAPES, loc, aw, torch.zeros(1, 3, M * D))
    assert port.ms_deform_attn_sep.launches == 0
    assert port.ms_deform_attn_sep_backward.launches == 0
