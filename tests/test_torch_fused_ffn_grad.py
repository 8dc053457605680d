"""The gradient of the port's encoder tail (the plain version of K2, whose
autograd gradient is what K2-bwd computes on the card) held against the VJP
of JAX ``fused_encoder_tail`` (its Pallas backward kernel in interpret mode on
the CPU) and of ``xla_encoder_tail``: all ten gradients, in f32 and bf16.

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
