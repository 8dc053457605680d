"""The CLIP-align head (``ClipAlignHead``) held against the JAX head
(``richsem_tpu/models/dino.py:ClipAlignHead``), forward and VJP.

The JAX head rounds the L2-normalised query projection and text bank to
``compute_dtype`` and takes their product with f32 accumulation and an f32
result (``dot_general(..., preferred_element_type=f32)``). On the card the
port runs that product for bf16 operands on the tensor cores
(``aten::mm.dtype`` inside the ``torch.autograd.Function`` ``_HeadProduct``,
whose backward is written out, since ``aten::mm.dtype`` has none); on the CPU
it runs the plain f32 product, ``head_product_plain``.

* The head's output and its gradients with respect to ``hs`` and the
  ``dino_visual_proj`` kernel, on the CPU, against ``jax.vjp`` of the JAX head
  on the same weights, inputs and cotangent: f32 to 1e-5 of the largest
  magnitude; bf16 to 5e-4 of it, about one bf16 step of one term (the two
  agree to 2e-7 here; a head that skipped the rounding to bf16 is 2e-3 off).
* ``_HeadProduct``, forced through on the CPU (its forward there is the plain
  product), against autograd of ``head_product_plain``: the output and both
  operands' gradients bit for bit, since its backward is the plain product's
  VJP (the f32 cotangent times the other operand in f32, rounded to the
  operand's dtype).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.dino import ClipAlignHead as JaxHead
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu_torch.models import dino
from richsem_tpu_torch.models.dino import ClipAlignHead, DINOConfig

H, LD, C = 32, 16, 24  # hidden, CLIP embedding, classes
LOGIT_SCALE = float(np.log(1 / 0.07))
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 5e-4)}
SHAPES = {"tokens": (2, 7), "decoder-stack": (3, 2, 5)}  # [B, N] and [L, B, N]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    hs = rng.normal(size=shape + (H,)).astype(np.float32)
    text = rng.normal(size=(C, LD)).astype(np.float32)
    kernel = (rng.normal(size=(H, LD)) / np.sqrt(H)).astype(np.float32)
    cot = rng.normal(size=shape + (C,)).astype(np.float32)
    return hs, text, kernel, cot


def _close(out, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
@pytest.mark.parametrize("dtype", DTYPES.keys())
def test_head_matches_jax_forward_and_vjp(dtype, shape):
    jdt, tdt, rel = DTYPES[dtype]
    hs, text, kernel, cot = _inputs(shape)
    jhead = JaxHead(dataclasses.replace(JaxDINOConfig(), hidden_dim=H, clip_embed_dim=LD,
                                        compute_dtype=jdt))
    params = {"params": {"dino_visual_proj": {"kernel": jnp.asarray(kernel)}}}
    ref, vjp = jax.vjp(lambda p, x: jhead.apply(p, x, jnp.asarray(text),
                                                jnp.asarray(LOGIT_SCALE)),
                       params, jnp.asarray(hs))
    d_params, d_hs = vjp(jnp.asarray(cot))

    head = ClipAlignHead(DINOConfig(hidden_dim=H, clip_embed_dim=LD, compute_dtype=tdt),
                         device="cpu")
    with torch.no_grad():
        head.dino_visual_proj.weight.copy_(torch.from_numpy(kernel.T))
    x = torch.from_numpy(hs).requires_grad_(True)
    out = head(x, torch.from_numpy(text), torch.tensor(LOGIT_SCALE))
    out.backward(torch.from_numpy(cot))
    assert out.dtype == torch.float32 and out.shape == shape + (C,)
    _close(out.detach().numpy(), ref, rel, "logits")
    _close(x.grad.numpy(), d_hs, rel, "d hs")
    _close(head.dino_visual_proj.weight.grad.numpy().T,
           d_params["params"]["dino_visual_proj"]["kernel"], rel, "d dino_visual_proj")


@pytest.mark.parametrize("shape", SHAPES.values(), ids=SHAPES.keys())
def test_tensor_core_product_backward_is_the_plain_vjp(shape):
    hs, text, _, cot = _inputs(shape, seed=1)
    outs, grads = [], []
    for fn in (dino._HeadProduct.apply, dino.head_product_plain):
        v = torch.from_numpy(hs[..., :LD]).to(torch.bfloat16).requires_grad_(True)
        t = torch.from_numpy(text).to(torch.bfloat16).requires_grad_(True)
        out = fn(v, t)
        out.backward(torch.from_numpy(cot))
        outs.append(out.detach())
        grads.append((v.grad, t.grad))
    assert outs[0].dtype == torch.float32 and outs[0].shape == shape + (C,)
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_head_product_routes_cpu_tensors_to_the_plain_version():
    """On CPU tensors ``head_product`` is the plain product, bf16 or f32; only bf16
    operands on the card take ``_HeadProduct``."""
    v = torch.randn(3, 4, LD, generator=torch.Generator().manual_seed(2))
    t = torch.randn(C, LD, generator=torch.Generator().manual_seed(3))
    for dt in (torch.float32, torch.bfloat16):
        vv, tt = v.to(dt).requires_grad_(True), t.to(dt)
        out = dino.head_product(vv, tt)
        assert out.grad_fn.name() != "_HeadProductBackward"
        assert torch.equal(out, dino.head_product_plain(vv, tt))
