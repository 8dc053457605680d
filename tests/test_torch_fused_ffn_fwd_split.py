"""How K2 (``csrc/fused_encoder_tail_fwd.cu``) splits the encoder tail's
forward, emulated in plain torch on the CPU and held against JAX
``fused_encoder_tail`` (its Pallas kernel in interpret mode) and the port's
plain version, at N = 1, 200 and 1,100 (not multiples of the 128-row block)
and the kernel's width d = 256.

The emulation follows the kernel: 128-row blocks (rows past N read zeros);
LN1 in the order of ``encoder_tail_common.cuh:ln1_row`` (lane t's channels
4t .. 4t+3 and 128+4t .. 128+4t+3 summed as four pairs in order, then a
shuffle-down tree over the 32 lanes, every operation rounded as PyTorch
rounds it); the hidden in 64-wide chunks with the bf16 casts at the kernel's
points (bf16(x) @ W1c^T cast, + b1 in bf16, relu; the chunk's product with
W2c accumulated in f32 chunk after chunk); the epilogue's x recomputed from
src + attn with the kept mean and rstd, h2 = bf16(bf16(acc) + b2), and LN2
from the quad sums of the accumulator fragment (a lane's 64 columns
8 jj + 2 q + {0, 1} in order, then the quad's butterfly). Products on the
tensor cores sum in another order than the CPU's, so the outputs are held to
the bf16 tolerance that tests/test_torch_fused_ffn.py holds the plain
version to against the interpreted Pallas kernel (3e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.ops.fused_ffn import fused_encoder_tail
from richsem_tpu_torch.ops import fused_ffn as port

torch.set_num_threads(2)

N, D, F = 1100, 256, 256
EPS = 1e-5
KEYS = ("w1", "b1", "w2", "b2", "s1", "sb1", "s2", "sb2")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    src = rng.normal(size=(N, D)).astype(np.float32)
    attn = rng.normal(size=(N, D)).astype(np.float32) * 0.5
    p = dict(  # flax layout: w1 [d, F], w2 [F, d]
        w1=rng.normal(size=(D, F)) * D ** -0.5, b1=rng.normal(size=(F,)) * 0.1,
        w2=rng.normal(size=(F, D)) * F ** -0.5, b2=rng.normal(size=(D,)) * 0.1,
        s1=1.0 + rng.normal(size=(D,)) * 0.1, sb1=rng.normal(size=(D,)) * 0.1,
        s2=1.0 + rng.normal(size=(D,)) * 0.1, sb2=rng.normal(size=(D,)) * 0.1,
    )
    return src, attn, {k: v.astype(np.float32) for k, v in p.items()}


def _bf(t):
    return t.to(torch.bfloat16).float()


def _torch_params(p):
    """nn.Linear layout, bf16 weights and biases as the kernel reads them."""
    w = {k: torch.from_numpy(v.T.copy() if k in ("w1", "w2") else v) for k, v in p.items()}
    return [w[k] for k in KEYS]


def _ln1_header_order(u, s1, sb1):
    """ln1_row: -> (x f32, mean, rstd) of each row of u [rows, 256]."""
    lanes = u.view(-1, 2, 32, 4)  # [row, half, lane, k]: channel 128 half + 4 lane + k

    def lane_sums(v):
        a, b = v[:, 0], v[:, 1]  # the lane's first and second four channels
        return (((a[..., 0] + b[..., 0]) + (a[..., 1] + b[..., 1])) + (a[..., 2] + b[..., 2])
                ) + (a[..., 3] + b[..., 3])

    def tree(s):  # shuffle-down from offset 16 to 1: lane 0's value
        while s.shape[1] > 1:
            s = s[:, : s.shape[1] // 2] + s[:, s.shape[1] // 2:]
        return s[:, :1]

    mean = tree(lane_sums(lanes)) * (1.0 / 256)
    msq = tree(lane_sums(lanes * lanes)) * (1.0 / 256)
    rstd = torch.rsqrt((msq - mean * mean) + EPS)
    return ((u - mean) * rstd) * s1 + sb1, mean, rstd


def _k2_fwd_emulated(src, attn, w1, b1, w2, b2, s1, sb1, s2, sb2, *, block=128, chunk=64):
    """K2's split in plain torch: -> (y [N, 256] f32, bf16 x, bf16 h1 after the relu)."""
    n, d = src.shape
    f = w1.shape[0]
    n_pad = -(-n // block) * block
    u1 = torch.cat([src + attn, src.new_zeros(n_pad - n, d)])
    w1b, w2b, b1b, b2b = _bf(w1), _bf(w2), _bf(b1), _bf(b2)
    y, xb, h1 = torch.zeros(n_pad, d), torch.zeros(n_pad, d), torch.zeros(n_pad, f)
    for r0 in range(0, n_pad, block):
        rows = slice(r0, r0 + block)
        x, mean, rstd = _ln1_header_order(u1[rows], s1, sb1)
        xb[rows] = _bf(x)
        acc = torch.zeros(block, d)
        for f0 in range(0, f, chunk):
            cols = slice(f0, f0 + chunk)
            h1c = torch.relu(_bf(_bf(xb[rows] @ w1b[cols].t()) + b1b[cols]))
            h1[rows, cols] = h1c
            acc += h1c @ w2b[:, cols].t()
        x_again = ((u1[rows] - mean) * rstd) * s1 + sb1
        assert torch.equal(x_again, x)  # the epilogue's recompute: the same bits
        u2 = x_again + _bf(_bf(acc) + b2b)
        pairs = u2.view(block, 32, 4, 2)  # column 8 jj + 2 q + e -> [jj, q, e]

        def quad(v):
            s = v[:, 0]
            for jj in range(1, 32):
                s = s + v[:, jj]
            return (s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3])

        mean2 = quad(pairs[..., 0] + pairs[..., 1])[:, None] / d
        sq = quad(pairs[..., 0] * pairs[..., 0] + pairs[..., 1] * pairs[..., 1])[:, None]
        rstd2 = torch.rsqrt(sq / d - mean2 * mean2 + EPS)
        y[rows] = (u2 - mean2) * rstd2 * s2 + sb2
    return y[:n], xb[:n], h1[:n]


def _plain_x_mask(src, attn, w1, b1, s1, sb1):
    x = port._ln(src + attn, s1, sb1, EPS).to(torch.bfloat16)
    return x.float(), torch.relu(x @ w1.to(torch.bfloat16).t() + b1.to(torch.bfloat16)) > 0


@pytest.mark.parametrize("n", [1, 200, N])
def test_k2_split_matches_fused_interpret_and_plain(data, n):
    src, attn, p = data
    src, attn = src[:n], attn[:n]
    params = _torch_params(p)
    y, _, _ = _k2_fwd_emulated(torch.from_numpy(src), torch.from_numpy(attn), *params)
    args = [jnp.asarray(p[k]) for k in KEYS]
    ref = np.asarray(fused_encoder_tail(jnp.asarray(src), jnp.asarray(attn), *args, EPS,
                                        jnp.bfloat16), np.float32)
    plain = port.encoder_tail_plain(torch.from_numpy(src), torch.from_numpy(attn), *params,
                                    EPS, torch.bfloat16)
    assert y.shape == (n, D)
    np.testing.assert_allclose(y.numpy(), ref, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(y.numpy(), plain.numpy(), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("n", [1, 200, N])
def test_k2_split_x_and_relu_masks_match_plain(data, n):
    """bf16(x) and the relu masks, which K2 and K2-bwd must share with the
    plain version (a mask that differs changes what the backward
    differentiates). The header sums LN1 in the order of torch 2.11's CUDA
    mean; on the CPU the plain version sums in the CPU's order, so its f32 x
    may differ in the last bit, and bf16(x) by one step where that bit
    decides the rounding (8 of 281,600 elements at N = 1,100 here). The masks
    are equal. On the card, chip_smoke.py phases 4 and 5 count the elements
    that differ from the plain version's on the card."""
    src, attn, p = data
    src, attn = torch.from_numpy(src[:n]), torch.from_numpy(attn[:n])
    params = _torch_params(p)
    _, xb, h1 = _k2_fwd_emulated(src, attn, *params)
    x_p, mask_p = _plain_x_mask(src, attn, params[0], params[1], params[4], params[5])
    x_f32, _, _ = _ln1_header_order(src + attn, params[4], params[5])
    x_plain = port._ln(src + attn, params[4], params[5], EPS)
    # the two orders: a few f32 ulps apart at most
    np.testing.assert_allclose(x_f32.numpy(), x_plain.numpy(), rtol=2 ** -21, atol=2 ** -21)
    differ = xb != x_p
    assert int(differ.sum()) <= 1e-4 * xb.numel()
    assert bool(((xb - x_p).abs() <= x_p.abs() * 2 ** -7)[differ].all())  # one bf16 step
    assert torch.equal(h1 > 0, mask_p)
