"""The port's RoIAlign held against ``richsem_tpu/ops/roi_align.py`` with
``method="matmul"`` and the adaptive ``sampling_ratio=0`` (detectron2's
grid), the path the CLIP teacher's targets take.

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


def test_unported_methods_raise():
    feats = torch.zeros(1, H, W, C)
    boxes = torch.zeros(1, 1, 4)
    for kw in ({"method": "gather", "sampling_ratio": 2}, {"sampling_ratio": 2}):
        with pytest.raises(NotImplementedError, match="item 11"):
            roi_align(feats, boxes, O, SCALE, **kw)
