"""The roofline's byte and operation counts and the reference's FLOP count
against hand counts on tiny shapes."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import eval_cell, roofline
from benchmark.reference import detector


def test_bound_takes_the_larger_side():
    assert roofline.bound_ms(3.35e12, 0.0, 1.0) == pytest.approx(1e3)
    assert roofline.bound_ms(0.0, 989e12, roofline.BF16_FLOPS) == pytest.approx(1e3)
    assert roofline.bound_ms(3.35e9, 989e12, roofline.BF16_FLOPS) == pytest.approx(1e3)


def test_msda_counts_by_hand():
    b, s, m, d, q, lv, p = 2, 30, 8, 32, 7, 4, 4
    value = torch.zeros(b, s, m, d, dtype=torch.bfloat16)
    loc, aw = torch.zeros(b, q, m, lv, p, 2), torch.zeros(b, q, m, lv, p)
    out = torch.zeros(b, q, m * d, dtype=torch.bfloat16)
    assert roofline.k1_taps(loc) == b * q * m * lv * p
    nbytes = 2 * b * s * m * d + 4 * b * q * m * lv * p * 3 + 2 * b * q * m * d
    assert roofline.nbytes(value, loc, aw, out) == nbytes
    ops = 8 * b * q * m * lv * p * d
    assert roofline.msda_fwd_bound(value, loc, aw, out) == pytest.approx(
        max(nbytes / 3.35e12, ops / 67e12) * 1e3)
    grad = torch.zeros_like(out)
    outs = (torch.zeros(b, s, m, d), loc.clone(), aw.clone())
    # the inputs, the gradient, and d_value, d_loc, d_aw in f32
    bwd_bytes = nbytes + 4 * b * s * m * d + 4 * b * q * m * lv * p * 3  # the gradient in out's place
    assert roofline.msda_bwd_bound(value, loc, aw, grad, outs) == pytest.approx(
        max(bwd_bytes / 3.35e12, 4 * ops / 67e12) * 1e3)


def test_encoder_tail_and_adamw_counts_by_hand():
    n, d, f = 1000, 256, 2048
    src, attn, out = (torch.zeros(n, d) for _ in range(3))
    w = 2 * (2 * d * f + f + d) + 16 * d
    assert roofline.encoder_tail_fwd_bound(n, d, f, src, attn, out) == pytest.approx(
        max((12 * n * d + w) / 3.35e12, 4 * n * d * f / 989e12) * 1e3)
    bwd = 16 * n * d + w + 4 * (2 * d * f + f + 5 * d)
    assert roofline.encoder_tail_bwd_bound(n, d, f, src, attn, out) == pytest.approx(
        max(bwd / 3.35e12, 12 * n * d * f / 989e12) * 1e3)
    assert roofline.adamw_bound(10, 6) == pytest.approx((40 + 168) / 3.35e12 * 1e3)


def test_flop_counter_counts_products_by_hand():
    x, w = torch.zeros(5, 7, device="meta"), torch.zeros(3, 7, device="meta")
    img, k = torch.zeros(1, 4, 9, 9, device="meta"), torch.zeros(6, 4, 3, 3, device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.linear(x, w)
        torch.nn.functional.conv2d(img, k, padding=1)
    assert fc.get_total_flops() == 2 * 5 * 7 * 3 + 2 * 81 * 6 * 4 * 9


def test_eval_flops_grow_with_the_canvas():
    from benchmark.tests import tiny

    conf = tiny.conf("richsem-r50")
    specs = _specs(conf)
    small = eval_cell.reference_flops(conf, specs, tiny.mix("eval-bs2"))
    large = eval_cell.reference_flops(conf, specs, tiny.mix("eval-bs2", canvas=[256, 384]))
    assert 3.0 < large / small < 4.5  # the backbone and encoder grow with the pixels
    assert small > 0 and math.isfinite(small)


def _specs(conf):
    from benchmark.harness import program

    prog = program.build(conf, 1, "cpu")
    return program.leaf_specs(prog.model)
