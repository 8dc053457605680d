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


def _encoder_layer(p, cdt, fused_tail):
    """A DeformableEncoderLayer whose tail holds ``p``'s weights."""
    from richsem_tpu_torch.models.dino import DeformableEncoderLayer, DINOConfig

    c = DINOConfig(hidden_dim=D, dim_feedforward=F, nheads=4, compute_dtype=cdt,
                   enc_fused_tail=fused_tail)
    layer = DeformableEncoderLayer(c, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        layer.norm1.weight.copy_(t["s1"])
        layer.norm1.bias.copy_(t["sb1"])
        layer.ffn.linear1.weight.copy_(t["w1"].t())
        layer.ffn.linear1.bias.copy_(t["b1"])
        layer.ffn.linear2.weight.copy_(t["w2"].t())
        layer.ffn.linear2.bias.copy_(t["b2"])
        layer.ffn.norm.weight.copy_(t["s2"])
        layer.ffn.norm.bias.copy_(t["sb2"])
    return layer


@pytest.mark.parametrize("cdt,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_unfused_route_matches_jax_xla_tail(data, cdt, tol, monkeypatch):
    """F-P14: ``enc_fused_tail=False`` runs the modules' composition (LN1, then
    the FFN block), which computes JAX's ``xla_encoder_tail`` (f32 to 1e-5,
    bf16 to 1e-4 as above), and never calls ``encoder_tail``; the fused route
    on the CPU (the plain tail) agrees with it."""
    from richsem_tpu_torch.models import dino

    src, attn, p = data
    ref = _jax(xla_encoder_tail, src, attn, p, getattr(jnp, cdt))
    x = torch.from_numpy(src)[None]
    a = torch.from_numpy(attn)[None]
    calls = []
    monkeypatch.setattr(dino, "encoder_tail", lambda *args: calls.append(1) or
                        port.encoder_tail(*args))
    outs = {}
    for fused in (False, True):
        layer = _encoder_layer(p, getattr(torch, cdt), fused)
        monkeypatch.setattr(layer.self_attn, "forward", lambda *args, **kw: a)
        with torch.no_grad():
            outs[fused] = layer(x, x, None, None, None)[0].numpy()
        assert len(calls) == int(fused)
        np.testing.assert_allclose(outs[fused], ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(outs[False], outs[True], rtol=tol, atol=tol)


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches K2's wrapper
    checks without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_f32_on_the_card_refuses_naming_the_knob(data):
    """K2 computes in bf16 only (ROADMAP F-P5): a float32 compute dtype on a
    CUDA tensor raises before any launch, and the message names the route
    that takes it, ``enc_fused_tail=False``."""
    _, _, p = data

    def on_card(*shape):
        return torch.empty(*shape, device="meta").as_subclass(_OnCard)

    w = {k: on_card(*v.shape) for k, v in p.items()}
    x = on_card(N, D)
    with pytest.raises(NotImplementedError, match="enc_fused_tail=False"):
        port.encoder_tail(x, x, w["w1"].t(), w["b1"], w["w2"].t(), w["b2"], w["s1"],
                          w["sb1"], w["s2"], w["sb2"], EPS, torch.float32)
    assert port.encoder_tail.launches == 0
