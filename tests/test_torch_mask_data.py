"""The port's instance-mask data without OpenCV, held bit for bit against
``cv2`` (which this test imports; the port does not) and against the JAX
package's mask helpers, which call it:

* ``image_io.resize(..., INTER_NEAREST)`` against ``cv2.resize`` on seeded
  pairs of sizes, growing and shrinking, 1 to 300 pixels a side;
* ``image_io.fill_poly`` against ``cv2.fillPoly(mask, polys, 1)`` on seeded
  polygons: integer vertices inside the image, concave and self-intersecting
  ones (random vertex orders), several polygons an object, vertices a pixel
  or two outside, far outside and thousands of pixels out; ``line8`` against
  ``cv2.line`` and ``clip_line`` against ``cv2.clipLine``;
* ``datasets._polygons_to_mask`` and ``_rle_to_mask`` (COCO polygons with
  float vertices, RLE at another size) against JAX's; the transform's mask
  resize and the collate's stride-8 targets against JAX's.
"""

import cv2
import numpy as np
import pytest

from richsem_tpu.data import datasets as jds
from richsem_tpu.data import transforms as jtf
from richsem_tpu_torch.data import datasets as ds
from richsem_tpu_torch.data import image_io
from richsem_tpu_torch.data import transforms as tf


@pytest.mark.parametrize("seed", range(4))
def test_nearest_resize_equals_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(75):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 300, 4))
        if seed == 3:  # whole ratios, both ways
            f = int(rng.integers(2, 9))
            nh, nw = (h * f, w * f) if rng.uniform() < 0.5 else (max(h // f, 1), max(w // f, 1))
        img = rng.integers(0, 256, (h, w) + ((3,) if seed == 2 else ()), dtype=np.uint8)
        ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_NEAREST)
        np.testing.assert_array_equal(image_io.resize(img, (nw, nh), image_io.INTER_NEAREST), ref)


# (most vertices a polygon, how far outside the image vertices may go)
POLY_CASES = {"inside": (8, 0), "concave_many": (40, 0), "edge": (12, 2), "outside": (10, 60),
              "far": (6, 3000)}


@pytest.mark.parametrize("case", list(POLY_CASES))
def test_fill_poly_equals_cv2(case):
    most, out = POLY_CASES[case]
    rng = np.random.default_rng(len(case))
    for _ in range(60):
        h, w = (int(v) for v in rng.integers(1, 160, 2))
        polys = []
        for _ in range(int(rng.integers(1, 4))):
            n = int(rng.integers(3, most + 1))
            polys.append(np.stack([rng.integers(-out, w + out, n),
                                   rng.integers(-out, h + out, n)], 1).astype(np.int32))
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, polys, 1)
        got = image_io.fill_poly(np.zeros((h, w), np.uint8), polys)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} {[p.tolist() for p in polys]}")


def test_fill_poly_star_and_tiny_images():
    """A self-intersecting star (even-odd leaves its core empty), a concave
    comb, a degenerate sliver, and one- and two-pixel images."""
    shapes = [
        (40, 40, [np.asarray([[20, 2], [31, 37], [2, 14], [38, 14], [9, 37]])]),
        (30, 50, [np.asarray([[2, 28], [2, 2], [10, 20], [18, 2], [26, 20], [34, 2],
                              [42, 20], [48, 2], [48, 28]])]),
        (20, 20, [np.asarray([[3, 3], [16, 4], [3, 3]])]),
        (1, 1, [np.asarray([[6, -1], [-5, 1], [5, 1]])]),
        (2, 1, [np.asarray([[2, 3], [-2, -3], [2, -2]])]),
    ]
    for h, w, polys in shapes:
        polys = [p.astype(np.int32) for p in polys]
        ref = np.zeros((h, w), np.uint8)
        cv2.fillPoly(ref, polys, 1)
        np.testing.assert_array_equal(image_io.fill_poly(np.zeros((h, w), np.uint8), polys), ref)


def test_lines_and_clipping_equal_cv2():
    rng = np.random.default_rng(9)
    for _ in range(400):
        w, h = (int(v) for v in rng.integers(1, 60, 2))
        p1, p2 = (tuple(int(v) for v in rng.integers(-40, 100, 2)) for _ in range(2))
        ok, a1, a2 = cv2.clipLine((0, 0, w, h), p1, p2)
        assert image_io.clip_line(w, h, p1, p2) == (ok, tuple(a1), tuple(a2))
        ref = np.zeros((h, w), np.uint8)
        cv2.line(ref, p1, p2, 1)
        got = np.zeros((h, w), np.uint8)
        image_io.line8(got, p1, p2)
        np.testing.assert_array_equal(got, ref)


def test_coco_masks_equal_jax():
    """COCO segmentations through the datasets' helpers: float polygons (one
    and several an object, touching the border), uncompressed and compressed
    RLE, RLE of another size (the nearest resize)."""
    rng = np.random.default_rng(4)
    h, w = 57, 83
    polys = []
    for _ in range(30):
        seg = []
        for _ in range(int(rng.integers(1, 3))):
            n = int(rng.integers(3, 15))
            pts = np.stack([rng.uniform(-1.5, w + 1.5, n), rng.uniform(-1.5, h + 1.5, n)], 1)
            seg.append(pts.reshape(-1).tolist())
        polys.append(seg)
    for seg in polys:
        np.testing.assert_array_equal(ds._polygons_to_mask(seg, h, w),
                                      jds._polygons_to_mask(seg, h, w))
    for rh, rw in ((h, w), (20, 31), (120, 170)):
        counts = rng.integers(0, 40, 60)
        counts = counts[np.cumsum(counts) <= rh * rw].tolist()
        counts.append(rh * rw - sum(counts))
        seg = {"counts": counts, "size": [rh, rw]}
        np.testing.assert_array_equal(ds._rle_to_mask(seg, h, w), jds._rle_to_mask(seg, h, w))
        np.testing.assert_array_equal(ds._polygons_to_mask(seg, h, w),
                                      jds._polygons_to_mask(seg, h, w))
    seg = {"counts": "52203", "size": [5, 4]}  # compressed
    np.testing.assert_array_equal(ds._rle_to_mask(seg, 9, 7), jds._rle_to_mask(seg, 9, 7))


def test_transform_mask_resize_equals_jax():
    rng = np.random.default_rng(2)
    rec = {"image": rng.integers(0, 255, (61, 93, 3), dtype=np.uint8),
           "boxes": np.asarray([[5, 5, 30, 30]], np.float32), "labels": np.asarray([1]),
           "area": np.asarray([625.0], np.float32), "masks": rng.uniform(size=(3, 61, 93)) > 0.5}
    for size, max_size in ((40, None), (130, 150), (61, None)):
        out, ref = tf.resize(rec, size, max_size), jtf.resize(rec, size, max_size)
        np.testing.assert_array_equal(out["masks"], ref["masks"])
