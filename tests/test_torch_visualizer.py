"""The port's visualizer (``richsem_tpu_torch/utils/visualizer.py``) held
against the JAX package's, which draws with OpenCV:

* ``draw_detections`` equal to JAX's outside the glyphs' pixels and within 2
  a channel inside them (measured: equal everywhere), on seeded images and
  boxes at thickness 1-3, with scores and without, boxes that leave the
  image, labels that run past its top or right edge; and
  ``tests/test_misc_utils.py::test_visualizer_draws``'s case;
* ``rectangle`` against ``cv2.rectangle`` pixel for pixel (thickness -1, 0-3
  and larger, reversed and degenerate corners, corners outside the image);
  ``text_size`` against ``cv2.getTextSize``;
* the glyph table rebuilt with OpenCV equal to the committed one
  (``richsem_tpu_torch/utils/glyphs.py``; run this file as a script to
  rewrite it);
* ``save_detections``'s PNG decoding to ``draw_detections``' pixels.

``_color`` is JAX's, value for value.
"""

import os
import re
import sys

import cv2
import numpy as np
import pytest

from richsem_tpu.utils import visualizer as jvis
from richsem_tpu_torch.data.image_io import imread_rgb
from richsem_tpu_torch.utils import glyphs
from richsem_tpu_torch.utils import visualizer as vis

FONT = cv2.FONT_HERSHEY_SIMPLEX
CANVAS, ORIGIN = (64, 96), (32, 40)  # one glyph's canvas and pen


def build_glyph_table():
    """The table as OpenCV draws it: each character in white on black at a
    pen inside a canvas, its non-zero pixels' bounding box, and the advance
    ``getTextSize`` gives (its width less the thickness)."""
    table = {}
    for code in range(glyphs.FIRST, glyphs.LAST + 1):
        c = chr(code)
        img = np.zeros(CANVAS + (3,), np.uint8)
        cv2.putText(img, c, ORIGIN, FONT, 0.5, (255, 255, 255), 1, cv2.LINE_AA)
        a = img[..., 0]
        assert (img == a[..., None]).all()
        adv = cv2.getTextSize(c, FONT, 0.5, 1)[0][0] - 1
        ys, xs = np.nonzero(a)
        if not len(ys):
            table[c] = (np.zeros((0, 0), np.uint8), 0, 0, adv)
            continue
        y0, x0 = int(ys.min()), int(xs.min())
        assert 0 < y0 and ys.max() < CANVAS[0] - 1 and 0 < x0 and xs.max() < CANVAS[1] - 1
        table[c] = (a[y0:ys.max() + 1, x0:xs.max() + 1].copy(), x0 - ORIGIN[0],
                    y0 - ORIGIN[1], adv)
    return table


def test_glyph_table_equals_opencv():
    built, committed = build_glyph_table(), glyphs.table()
    assert set(built) == set(committed)
    for c, (alpha, dx, dy, adv) in built.items():
        got = committed[c]
        assert got[1:] == (dx, dy, adv), c
        np.testing.assert_array_equal(got[0], alpha, err_msg=c)
    assert {cv2.getTextSize(c, FONT, 0.5, 1)[0][1] for c in built} == {glyphs.TEXT_HEIGHT}


def test_color_matches_jax():
    for cid in range(0, 1300, 7):
        assert vis._color(cid) == jvis._color(cid)


@pytest.mark.parametrize("thickness", [-1, 0, 1, 2, 3, 4, 7])
def test_rectangle_equals_cv2(thickness):
    rng = np.random.default_rng(thickness + 10)
    for i in range(300):
        h, w = (int(v) for v in rng.integers(1, 40, 2))
        p1, p2 = (tuple(int(v) for v in rng.integers(-12, 52, 2)) for _ in range(2))
        if i % 6 == 0:
            p2 = (p1[0], p2[1])  # a vertical sliver
        if i % 6 == 1:
            p2 = p1  # one point
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        ref = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(ref, p1, p2, color, thickness)
        got = vis.rectangle(np.zeros((h, w, 3), np.uint8), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, ref, err_msg=f"{h}x{w} {p1} {p2}")


def test_text_size_and_text_equal_cv2():
    rng = np.random.default_rng(1)
    chars = [chr(c) for c in range(glyphs.FIRST, glyphs.LAST + 1)]
    for _ in range(200):
        s = "".join(rng.choice(chars, int(rng.integers(1, 14))))
        assert vis.text_size(s) == cv2.getTextSize(s, FONT, 0.5, 1)[0], s
        bg = rng.integers(0, 256, (40, 90, 3), dtype=np.uint8)
        org = (int(rng.integers(-20, 70)), int(rng.integers(-5, 50)))
        ref = bg.copy()
        cv2.putText(ref, s, org, FONT, 0.5, (255, 255, 255), 1, cv2.LINE_AA)
        got = vis.put_text(bg.copy(), s, org)
        assert np.abs(got.astype(int) - ref.astype(int)).max() <= 2, s


def test_visualizer_draws():
    img = np.zeros((40, 60, 3), np.uint8)
    out = vis.draw_detections(img, np.asarray([[5, 5, 30, 30]]), np.asarray([2]),
                              np.asarray([0.9]), {2: "cat"})
    assert out.shape == (40, 60, 3)
    assert out.sum() > 0


def _case(seed, n=6):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(40, 160, 2))
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    x0, y0 = rng.uniform(-20, w, n), rng.uniform(-10, h, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, w, n), y0 + rng.uniform(2, h, n)], 1)
    labels = rng.integers(0, 1203, n)
    scores = rng.uniform(0.1, 1.0, n)
    names = {int(c): f"class_{int(c)}" for c in labels[::2]}
    return img, boxes, labels, scores, names


def _glyph_pixels(img, boxes, labels, scores, names, thresh, with_scores):
    """Where the text of any drawn label lands (its glyphs on black)."""
    ink = np.zeros(img.shape[:2], bool)
    for i in range(len(boxes)):
        s = float(scores[i]) if with_scores else 1.0
        if s < thresh:
            continue
        x0, y0 = int(boxes[i][0]), int(boxes[i][1])
        name = names.get(int(labels[i]), str(int(labels[i])))
        text = f"{name} {s:.2f}" if with_scores else name
        layer = np.zeros(img.shape, np.uint8)
        cv2.putText(layer, text, (x0 + 1, y0 - 3), FONT, 0.5, (255, 255, 255), 1, cv2.LINE_AA)
        ink |= layer[..., 0] > 0
    return ink


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("with_scores", [True, False], ids=["scores", "no_scores"])
def test_draw_detections_matches_jax(thickness, with_scores):
    for seed in range(4):
        img, boxes, labels, scores, names = _case(seed * 10 + thickness)
        sc = scores if with_scores else None
        ref = jvis.draw_detections(img, boxes, labels, sc, names, 0.3, thickness)
        out = vis.draw_detections(img, boxes, labels, sc, names, 0.3, thickness)
        assert out.dtype == np.uint8 and out.shape == ref.shape
        ink = _glyph_pixels(img, boxes, labels, scores, names, 0.3, with_scores)
        np.testing.assert_array_equal(out[~ink], ref[~ink])
        assert np.abs(out[ink].astype(int) - ref[ink].astype(int)).max(initial=0) <= 2


def test_save_detections_writes_the_drawing(tmp_path):
    img, boxes, labels, scores, names = _case(7)
    path = os.path.join(tmp_path, "det.png")
    vis.save_detections(path, img, boxes, labels, scores, class_names=names)
    drawn = vis.draw_detections(img, boxes, labels, scores, names)
    np.testing.assert_array_equal(imread_rgb(path), drawn[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(path), drawn)
    with pytest.raises(ValueError, match="png"):
        vis.save_detections(os.path.join(tmp_path, "det.bmp"), img, boxes, labels)


def write_glyph_module(path=glyphs.__file__):
    """Rewrite ``_DATA`` in ``richsem_tpu_torch/utils/glyphs.py`` from OpenCV."""
    with open(path) as f:
        src = f.read()
    data = glyphs.pack(build_glyph_table())
    lines = "\n".join(f'    "{data[i:i + 92]}"' for i in range(0, len(data), 92))
    src = re.sub(r"_DATA = \(?[^)]*\)?\n?$|_DATA = \"\"\n", f"_DATA = (\n{lines}\n)\n", src,
                 flags=re.S)
    with open(path, "w") as f:
        f.write(src)


if __name__ == "__main__":
    sys.exit(write_glyph_module())
