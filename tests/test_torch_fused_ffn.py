"""The port's encoder tail (plain version of K2) held against the JAX package:
``fused_encoder_tail`` (its Pallas kernel in interpret mode on the CPU) and
``xla_encoder_tail``.

N = 1100 is not a multiple of the Pallas block (1024 rows), so the JAX side
runs its padded last block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.ops.fused_ffn import fused_encoder_tail, xla_encoder_tail
from richsem_tpu_torch.ops import fused_ffn as port

torch.set_num_threads(2)

N, D, F = 1100, 64, 128
EPS = 1e-5


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
    return src, attn, {k: v.astype(np.float32) for k, v in p.items()}


def _jax(fn, src, attn, p, cdt):
    args = [jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2", "s1", "sb1", "s2", "sb2")]
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(attn), *args, EPS, cdt), np.float32)


def _port(src, attn, p, cdt):
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    # nn.Linear layout: the transposes of the flax kernels
    return port.encoder_tail(
        torch.from_numpy(src), torch.from_numpy(attn), t["w1"].t(), t["b1"],
        t["w2"].t(), t["b2"], t["s1"], t["sb1"], t["s2"], t["sb2"], EPS, cdt,
    ).numpy()


# bf16 against xla_encoder_tail: both round x, the hidden and the second
# matmul to bf16 at the same points and accumulate in f32; they agree to ~1e-6
# here, and 1e-4 leaves room for f32 sums taken in another order. Against the
# interpreted Pallas kernel the bound is 3e-2, the one tests/test_fused_ffn.py
# holds that kernel to against the XLA composition in bf16: the two JAX
# versions themselves differ by 8e-3 here (a bf16 rounding step of the hidden
# that flips, carried through W2 and LN2).
@pytest.mark.parametrize("jax_fn,cdt,tol", [
    (xla_encoder_tail, "float32", 1e-5),
    (fused_encoder_tail, "float32", 1e-5),
    (xla_encoder_tail, "bfloat16", 1e-4),
    (fused_encoder_tail, "bfloat16", 3e-2),
], ids=["xla-f32", "fused_interpret-f32", "xla-bf16", "fused_interpret-bf16"])
def test_plain_tail_matches_jax(data, jax_fn, cdt, tol):
    src, attn, p = data
    ref = _jax(jax_fn, src, attn, p, getattr(jnp, cdt))
    out = _port(src, attn, p, getattr(torch, cdt))
    assert out.shape == (N, D) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_non_cpu_tensor_never_falls_back(data):
    src, attn, p = data
    meta = {k: torch.empty(v.shape, device="meta") for k, v in p.items()}
    x = torch.empty(N, D, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        port.encoder_tail(x, x, meta["w1"].t(), meta["b1"], meta["w2"].t(),
                          meta["b2"], meta["s1"], meta["sb1"], meta["s2"],
                          meta["sb2"], EPS, torch.bfloat16)
    assert port.encoder_tail.launches == 0
