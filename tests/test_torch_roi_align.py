"""The port's RoIAlign held against ``richsem_tpu/ops/roi_align.py``: with
``method="matmul"`` and the adaptive ``sampling_ratio=0`` (detectron2's
grid), the path the CLIP teacher's targets take; and with ``method="gather"``
at static ratios 1-3, values and gradients, and ``auto`` past 2,048 cells,
the path of the visual queries on a large canvas.

Boxes: ordinary ones, degenerate ones (zero or negative extent, which must
give exact zeros), boxes partly outside the map, and boxes as large as the map,
whose adaptive grid reaches the static ``nmax`` lattice.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.ops.roi_align import roi_align as jax_roi_align
from richsem_tpu_torch.ops.roi_align import roi_align

torch.set_num_threads(2)

H, W, C, O, SCALE = 9, 13, 6, 3, 1.0 / 4.0  # map of a 36 x 52 image at stride 4


def _boxes(rng, b):
    img_h, img_w = H / SCALE, W / SCALE
    xy = rng.uniform(0, 0.7, (b, 6, 2)) * [img_w, img_h]
    wh = rng.uniform(2.0, 20.0, (b, 6, 2))
    ordinary = np.concatenate([xy, xy + wh], -1)
    special = np.asarray([
        [10.0, 10.0, 10.0, 22.0],  # zero width
        [30.0, 12.0, 20.0, 30.0],  # negative width
        [5.0, 5.0, 5.0, 5.0],  # a point
        [-10.0, -6.0, 14.0, 12.0],  # partly outside, top left
        [40.0, 20.0, 70.0, 50.0],  # partly outside, bottom right
        [0.0, 0.0, img_w, img_h],  # the whole map: the grid reaches nmax
        [-img_w, -img_h, 2 * img_w, 2 * img_h],  # larger than the map: clamped to nmax
        [3.3, 1.7, 3.4, 30.1],  # a sliver
    ])
    return np.concatenate([ordinary, np.broadcast_to(special, (b,) + special.shape)],
                          1).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_matmul_adaptive_matches_jax(dtype):
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, H, W, C)).astype(np.float32)
    boxes = _boxes(rng, 2)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = np.asarray(jax_roi_align(jnp.asarray(feats, jdt), jnp.asarray(boxes), O, SCALE,
                                   sampling_ratio=0, method="matmul").astype(jnp.float32))
    out = roi_align(torch.from_numpy(feats).to(dtype), torch.from_numpy(boxes), O, SCALE,
                    sampling_ratio=0, method="matmul")
    assert out.dtype == dtype and out.shape == (2, 14, O, O, C)
    # bf16: the interpolation matrix is rounded to bf16 on both sides; the
    # float32 products then differ only in summation order, and the final
    # bf16 rounding may land one step apart
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)
    # degenerate boxes (slots 6, 7, 8) are exactly zero
    assert (out[:, 6:9] == 0).all()
    assert (out[:, 9:] != 0).any()


def _gather_boxes(rng, b, h, w, scale):
    """Ordinary boxes and boxes partly off the map (the gather path's zero taps)."""
    img_h, img_w = h / scale, w / scale
    xy = rng.uniform(0, 0.7, (b, 5, 2)) * [img_w, img_h]
    wh = rng.uniform(2.0, 0.5 * img_w, (b, 5, 2))
    off = np.asarray([[-10.0, -6.0, 14.0, 12.0], [0.8 * img_w, 0.7 * img_h, 1.3 * img_w,
                                                  1.2 * img_h], [0.0, 0.0, img_w, img_h]])
    return np.concatenate([np.concatenate([xy, xy + wh], -1),
                           np.broadcast_to(off, (b, 3, 4))], 1).astype(np.float32)


@pytest.mark.parametrize("ratio", [1, 2, 3])
def test_gather_matches_jax_values_and_grads(ratio):
    """``method="gather"`` against JAX's at static sampling ratios, boxes partly
    off the map: the crops and the gradient of a weighted sum of them with
    respect to the map, f32 to 1e-5."""
    import jax

    rng = np.random.default_rng(ratio)
    feats = rng.normal(size=(2, H, W, C)).astype(np.float32)
    boxes = _gather_boxes(rng, 2, H, W, SCALE)
    cot = rng.normal(size=(2, 8, O, O, C)).astype(np.float32)

    def jax_loss(f):
        out = jax_roi_align(f, jnp.asarray(boxes), O, SCALE, sampling_ratio=ratio,
                            method="gather")
        return (out * cot).sum(), out

    (_, ref), ref_grad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    out = roi_align(f, torch.from_numpy(boxes), O, SCALE, sampling_ratio=ratio, method="gather")
    (out * torch.from_numpy(cot)).sum().backward()
    assert out.shape == (2, 8, O, O, C)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-5)


def test_auto_takes_the_gather_path_past_2048_cells():
    """``auto`` on a 42 x 64 map (2,688 cells: the visual queries' map of a
    1344 x 2048 canvas) is the gather path, against JAX's ``auto``; the matmul
    path computes the same crops (to 1e-5 of the largest magnitude); the
    gather path refuses the adaptive ratio with JAX's message."""
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(1, 42, 64, 8)).astype(np.float32)
    boxes = _gather_boxes(rng, 1, 42, 64, 1.0)
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes), 1, 1.0,
                                   sampling_ratio=2, method="auto"))
    t_feats, t_boxes = torch.from_numpy(feats), torch.from_numpy(boxes)
    out = roi_align(t_feats, t_boxes, 1, 1.0, sampling_ratio=2, method="auto")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    gathered = roi_align(t_feats, t_boxes, 1, 1.0, sampling_ratio=2, method="gather")
    assert torch.equal(out, gathered)
    mat = roi_align(t_feats, t_boxes, 1, 1.0, sampling_ratio=2, method="matmul")
    assert (mat - out).abs().max() <= 1e-5 * out.abs().max()
    with pytest.raises(NotImplementedError, match="adaptive sampling_ratio=0") as err:
        roi_align(t_feats, t_boxes, 1, 1.0, sampling_ratio=0, method="auto")
    with pytest.raises(NotImplementedError) as ref_err:
        jax_roi_align(jnp.asarray(feats), jnp.asarray(boxes), 1, 1.0, sampling_ratio=0,
                      method="auto")
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="unknown roi_align method"):
        roi_align(t_feats, t_boxes, 1, 1.0, method="bilinear")
