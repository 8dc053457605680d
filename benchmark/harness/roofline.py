"""The card's published peaks and the least time a kernel's work can take.

Frozen copies of ``chip_smoke.py``'s arithmetic (``bound``, ``nbytes``,
``k1_taps`` and the byte and operation counts of K1, K1-bwd, K2, K2-bwd, K5
and K6 behind ``PERF.md``'s kernel table), so that a later change to the
program cannot move them. Peaks: NVIDIA H100 SXM data sheet, dense, at the
700 W power limit.
"""

from __future__ import annotations

from typing import Sequence

HBM_BPS = 3.35e12  # bytes/s
BF16_FLOPS = 989e12  # tensor cores, dense
F32_FLOPS = 67e12  # CUDA cores


def bound_ms(nbytes: float, flops: float, peak: float) -> float:
    """The larger of bytes over the HBM rate and operations over the peak of their type."""
    return max(nbytes / HBM_BPS, flops / peak) * 1e3


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_taps(loc) -> int:
    """Sampling taps of a deformable-attention call: B * Q * M * L * P."""
    return loc[..., 0].numel()


def msda_fwd_bound(value, loc, aw, out) -> float:
    """K1: each input read and the output written once; 4 corners x (multiply
    + add) per tap and channel, on the CUDA cores."""
    return bound_ms(nbytes(value, loc, aw, out), 8 * k1_taps(loc) * value.shape[-1], F32_FLOPS)


def msda_bwd_bound(value, loc, aw, grad, outs: Sequence) -> float:
    """K1-bwd: per tap and channel the sample (8), its x and y derivatives
    (10), the three products with the gradient (6), the four d_value terms (8)."""
    return bound_ms(nbytes(value, loc, aw, grad, *outs), 32 * k1_taps(loc) * value.shape[-1],
                    F32_FLOPS)


def encoder_tail_fwd_bound(n: int, d: int, f: int, src, attn, out) -> float:
    """K2: the f32 streams, bf16 weights and f32 LN parameters read once, the
    output written once; two products of 2 n d f operations on the tensor cores."""
    return bound_ms(nbytes(src, attn, out) + 2 * (2 * d * f + f + d) + 4 * 4 * d,
                    4 * n * d * f, BF16_FLOPS)


def encoder_tail_bwd_bound(n: int, d: int, f: int, src, attn, dy) -> float:
    """K2-bwd: the streams and dy read, d_src written, the weights read and
    their f32 gradients written; six products of 2 n d f operations."""
    return bound_ms(nbytes(src, attn, dy, src) + 2 * (2 * d * f + f + d) + 4 * 4 * d
                    + 4 * (2 * d * f + f + 5 * d), 12 * n * d * f, BF16_FLOPS)


def adamw_bound(n_all: int, n_train: int) -> float:
    """K5 over the ``n_all`` f32 gradient elements the global norm reads (4
    bytes each), then K6 over the ``n_train`` trainable ones: g, m, v, p read
    and m, v, p written (28 bytes)."""
    return bound_ms(4 * n_all + 28 * n_train, 0.0, BF16_FLOPS)
