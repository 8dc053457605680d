"""The gradient of the port's encoder tail (the plain version of K2, whose
autograd gradient is what K2-bwd computes on the card) held against the VJP
of JAX ``fused_encoder_tail`` (its Pallas backward kernel in interpret mode on
the CPU) and of ``xla_encoder_tail``: all ten gradients, in f32 and bf16.

A test-local emulation of how K2-bwd splits the work (row blocks, bf16
transients, split-K partials added in a fixed order) is held against the
fused VJP and, at ragged N, against the plain version's gradient.

N = 1100 is not a multiple of the Pallas block (1024 rows), so the JAX side
runs its padded last block. Tolerances are those of ``tests/test_fused_ffn.py``
for the fused VJP against the XLA one (1e-4 in f32, 5e-2 in bf16, relative to
each gradient's largest magnitude): in bf16 the two frameworks round the
hidden, the matmul outputs and the weight gradients at the same points but
may land one bf16 step apart where an f32 sum differs in its last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.ops.fused_ffn import fused_encoder_tail, xla_encoder_tail
from richsem_tpu_torch.ops import fused_ffn as port

torch.set_num_threads(2)

N, D, F = 1100, 64, 128
EPS = 1e-5
KEYS = ("w1", "b1", "w2", "b2", "s1", "sb1", "s2", "sb2")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(N, D)).astype(np.float32) * 0.5
    attn = rng.normal(size=(N, D)).astype(np.float32) * 0.5
    p = dict(
        w1=rng.normal(size=(D, F)) * 0.1, b1=rng.normal(size=(F,)) * 0.1,
        w2=rng.normal(size=(F, D)) * 0.1, b2=rng.normal(size=(D,)) * 0.1,
        s1=1.0 + rng.normal(size=(D,)) * 0.1, sb1=rng.normal(size=(D,)) * 0.1,
        s2=1.0 + rng.normal(size=(D,)) * 0.1, sb2=rng.normal(size=(D,)) * 0.1,
    )
    cot = rng.normal(size=(N, D)).astype(np.float32)
    return src, attn, {k: v.astype(np.float32) for k, v in p.items()}, cot


def _jax_grads(fn, src, attn, p, cot, cdt):
    def f(s, a, *w):
        return fn(s, a, *w, EPS, cdt)

    args = [jnp.asarray(src), jnp.asarray(attn)] + [jnp.asarray(p[k]) for k in KEYS]
    _, vjp = jax.vjp(f, *args)
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(cot))]


def _port_grads(src, attn, p, cot, cdt):
    # nn.Linear layout: the transposes of the flax kernels
    w = {k: torch.from_numpy(v.T.copy() if k in ("w1", "w2") else v) for k, v in p.items()}
    leaves = [torch.from_numpy(src), torch.from_numpy(attn)] + [w[k] for k in KEYS]
    leaves = [t.requires_grad_() for t in leaves]
    y = port.encoder_tail(*leaves, EPS, cdt)
    grads = [g.float().numpy() for g in torch.autograd.grad(y, leaves, torch.from_numpy(cot))]
    grads[2], grads[4] = grads[2].T, grads[4].T  # back to the flax layout
    return grads


@pytest.mark.parametrize("jax_fn,cdt,tol", [
    (xla_encoder_tail, "float32", 1e-4),
    (fused_encoder_tail, "float32", 1e-4),
    (xla_encoder_tail, "bfloat16", 5e-2),
    (fused_encoder_tail, "bfloat16", 5e-2),
], ids=["xla-f32", "fused_interpret-f32", "xla-bf16", "fused_interpret-bf16"])
def test_plain_tail_grads_match_jax(data, jax_fn, cdt, tol):
    src, attn, p, cot = data
    ref = _jax_grads(jax_fn, src, attn, p, cot, getattr(jnp, cdt))
    out = _port_grads(src, attn, p, cot, getattr(torch, cdt))
    names = ("d_src", "d_attn") + tuple(f"d{k}" for k in KEYS)
    for o, r, name in zip(out, ref, names, strict=True):
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, rtol=tol, atol=tol * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


def test_backward_wrapper_never_runs_on_the_cpu(data):
    """K2-bwd called directly takes CUDA tensors only; nothing was launched."""
    src, attn, p, cot = data
    w = [torch.from_numpy(p[k]) for k in KEYS]
    x = torch.from_numpy(src)
    with pytest.raises(RuntimeError, match="no kernel"):
        port.encoder_tail_backward(x, x, *w, EPS, torch.bfloat16, torch.from_numpy(cot))
    assert port.encoder_tail_backward.launches == 0


def _k2_bwd_emulated(src, attn, w1, b1, w2, b2, s1, sb1, s2, sb2, dy, *, block=128,
                     chunk=64, splits=4):
    """How K2-bwd splits the work, in plain torch on the CPU: row blocks of
    ``block`` rows (rows past N read zeros), hidden chunks of ``chunk`` with the
    bf16 transients and the relu mask of the first walk reused by the second,
    dx accumulated onto du2, per-block column sums added in block order, and
    dW1, dW2 as split-K products over 64-row tiles whose f32 partials are added
    in split order. Weights in nn.Linear layout, f32 in and out."""
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    n, d = src.shape
    f = w1.shape[0]
    n_pad = -(-n // block) * block
    u1 = torch.cat([src + attn, src.new_zeros(n_pad - n, d)])
    dyp = torch.cat([dy, dy.new_zeros(n_pad - n, d)])
    w1b, w2b, b1b, b2b = bf(w1), bf(w2), bf(b1), bf(b2)
    xb, du2c = torch.zeros(n_pad, d), torch.zeros(n_pad, d)
    h1, dh1 = torch.zeros(n_pad, f), torch.zeros(n_pad, f)
    du1 = torch.zeros(n_pad, d)
    part_vec, part_db1 = [], []
    for r0 in range(0, n_pad, block):
        rows = slice(r0, r0 + block)
        u, g = u1[rows], dyp[rows]
        mean = u.mean(-1, keepdim=True)
        rstd = torch.rsqrt((u * u).mean(-1, keepdim=True) - mean * mean + EPS)
        x = (u - mean) * rstd * s1 + sb1
        xb[rows] = bf(x)
        h2acc, masks = torch.zeros(block, d), []
        for f0 in range(0, f, chunk):
            cols = slice(f0, f0 + chunk)
            h1c = torch.relu(bf(bf(xb[rows] @ w1b[cols].t()) + b1b[cols]))
            masks.append(h1c > 0)
            h1[rows, cols] = h1c
            h2acc += h1c @ w2b[:, cols].t()
        u2 = x + bf(bf(h2acc) + b2b)
        m2_ = u2.mean(-1, keepdim=True)
        r2 = torch.rsqrt((u2 * u2).mean(-1, keepdim=True) - m2_ * m2_ + EPS)
        xh2 = (u2 - m2_) * r2
        dxh = g * s2
        du2 = r2 * (dxh - dxh.mean(-1, keepdim=True) - xh2 * (dxh * xh2).mean(-1, keepdim=True))
        du2c[rows] = bf(du2)
        dx, db1 = du2.clone(), torch.zeros(f)
        for ci, f0 in enumerate(range(0, f, chunk)):
            cols = slice(f0, f0 + chunk)
            dh1c = bf(du2c[rows] @ w2b[:, cols]) * masks[ci]
            dh1[rows, cols] = dh1c
            db1[cols] = dh1c.sum(0)
            dx += dh1c @ w1b[cols]
        xh1 = (u - mean) * rstd
        dxh1 = dx * s1
        du1[rows] = rstd * (dxh1 - dxh1.mean(-1, keepdim=True)
                            - xh1 * (dxh1 * xh1).mean(-1, keepdim=True))
        part_vec.append(torch.stack([(dx * xh1).sum(0), dx.sum(0), (g * xh2).sum(0), g.sum(0),
                                     du2.sum(0)]))
        part_db1.append(db1)
    nk = -(-n_pad // 64)
    n_split = min(splits, nk)
    bounds = [64 * (nk * s // n_split) for s in range(n_split + 1)]

    def split_k(a, b):  # a^T b, partials over the row splits added in order
        total = None
        for s in range(n_split):
            rows = slice(bounds[s], bounds[s + 1])
            part = a[rows].t() @ b[rows]
            total = part if total is None else total + part
        return total

    def in_order(parts):
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    ds1, dsb1, ds2, dsb2, db2 = in_order(part_vec).unbind(0)
    return (du1[:n], split_k(dh1, xb), in_order(part_db1), split_k(du2c, h1), db2,
            ds1, dsb1, ds2, dsb2)


def _torch_inputs(src, attn, p, cot):
    w = {k: torch.from_numpy(v.T.copy() if k in ("w1", "w2") else v) for k, v in p.items()}
    return [torch.from_numpy(src), torch.from_numpy(attn)] + [w[k] for k in KEYS], torch.from_numpy(cot)


def test_k2_bwd_decomposition_matches_fused_vjp(data):
    """The emulated K2-bwd split (row blocks, bf16 transients, fixed-order
    split-K) against the VJP of JAX ``fused_encoder_tail`` (Pallas backward in
    interpret mode) in bf16, at the tolerance of the bf16 cases above: both
    round the hidden and the products at the same points but may land one bf16
    step apart where an f32 sum differs in its last bits."""
    src, attn, p, cot = data
    ref = _jax_grads(fused_encoder_tail, src, attn, p, cot, jnp.bfloat16)
    tensors, dy = _torch_inputs(src, attn, p, cot)
    du1, dw1, db1, dw2, db2, ds1, dsb1, ds2, dsb2 = _k2_bwd_emulated(*tensors, dy)
    out = [du1, du1, dw1.t(), db1, dw2.t(), db2, ds1, dsb1, ds2, dsb2]
    names = ("d_src", "d_attn") + tuple(f"d{k}" for k in KEYS)
    for o, r, name in zip(out, ref, names, strict=True):
        o = o.numpy()
        assert o.shape == r.shape, name
        np.testing.assert_allclose(o, r, rtol=5e-2, atol=5e-2 * max(np.abs(r).max(), 1e-6),
                                   err_msg=name)


@pytest.mark.parametrize("n", [1, 200])
def test_k2_bwd_decomposition_ragged_rows(data, n):
    """At N = 1 and 200 (not multiples of the 128-row block or the 64-row
    split tile) the emulated split matches the plain version's autograd
    gradient in bf16 (5e-2 of the largest magnitude, as above), and the zero
    rows that pad the last block add nothing: 8-row blocks, which pad less
    and split the rows elsewhere, give the same sums to f32 rounding."""
    src, attn, p, cot = data
    tensors, dy = _torch_inputs(src[:n], attn[:n], p, cot[:n])
    out = _k2_bwd_emulated(*tensors, dy)
    leaves = [t.clone().requires_grad_() for t in tensors]
    y = port.encoder_tail_plain(*leaves, EPS, torch.bfloat16)
    ref = torch.autograd.grad(y, leaves, dy)
    ref = [ref[0]] + list(ref[2:])  # d_src == d_attn
    names = ("du1", "dW1", "db1", "dW2", "db2", "ds1", "dsb1", "ds2", "dsb2")
    for o, r, name in zip(out, ref, names, strict=True):
        np.testing.assert_allclose(o.numpy(), r.float().numpy(), rtol=5e-2,
                                   atol=5e-2 * max(float(r.abs().max()), 1e-6), err_msg=name)
    small = _k2_bwd_emulated(*tensors, dy, block=8)
    for a, b, name in zip(out, small, names, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * max(float(b.abs().max()), 1e-6), err_msg=name)
