"""The port's image decode and resize (``richsem_tpu_torch/data/image_io.py``)
held against OpenCV, which the JAX data path calls.

* PNG decode equals ``cv2.imread`` + ``BGR2RGB`` exactly (PNG is lossless):
  gray, gray + alpha, RGB and RGBA, each PNG filter type on every row and a
  mix of them, files written by the port's encoder, by OpenCV and (palette)
  by PIL.
* JPEG equals ``cv2.imread`` with or without OpenCV in the interpreter (the
  codec's own cases: ``tests/test_torch_jpeg.py``); other formats need it.
* ``resize`` is within one level of ``cv2.resize`` for ``INTER_LINEAR`` and
  ``INTER_AREA``, up and down, odd sizes; at most 1% of the values differ
  (measured: up to 0.55% for ``INTER_LINEAR`` upscales, where OpenCV's
  vector and scalar paths round a product differently; 0 for ``INTER_AREA``).
"""

import os
import sys

import cv2
import numpy as np
import pytest

from richsem_tpu_torch.data import image_io

FILTERS = [0, 1, 2, 3, 4, "mixed"]


def _img(h, w, ch, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    img = np.clip(base[..., None] + rng.normal(0, 30, (h, w, ch)), 0, 255).astype(np.uint8)
    return img[..., 0] if ch == 1 else img


def _cv2_read(path):
    return cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("ch", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
@pytest.mark.parametrize("filt", FILTERS)
def test_png_decode_equals_cv2(tmp_path, ch, filt):
    img = _img(37, 53, ch)
    filters = np.random.default_rng(1).integers(0, 5, 37) if filt == "mixed" else filt
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(image_io.encode_png(img, filters))
    out = image_io.imread_rgb(path)
    assert out.dtype == np.uint8 and out.shape == (37, 53, 3)
    np.testing.assert_array_equal(out, _cv2_read(path))


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_written_by_cv2(tmp_path, ch):
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, _img(64, 81, ch, seed=2))
    np.testing.assert_array_equal(image_io.imread_rgb(path), _cv2_read(path))


def test_palette_png(tmp_path):
    from PIL import Image

    path = str(tmp_path / "p.png")
    Image.fromarray(_img(29, 41, 3, seed=4)).quantize(37).save(path)
    assert open(path, "rb").read()[25] == 3  # IHDR color type: palette
    np.testing.assert_array_equal(image_io.imread_rgb(path), _cv2_read(path))


def test_missing_and_corrupt_files_read_as_none(tmp_path):
    assert image_io.imread_rgb(str(tmp_path / "missing.png")) is None
    data = image_io.encode_png(_img(20, 30, 3))
    path = str(tmp_path / "cut.png")
    with open(path, "wb") as f:
        f.write(data[: len(data) // 2])
    assert image_io.imread_rgb(path) is None
    assert cv2.imread(path) is None


def test_other_formats_need_opencv(tmp_path, monkeypatch):
    """JPEG without cv2 equals cv2: the port decodes it with its own codec in
    an interpreter without OpenCV. Formats other than PNG and JPEG still need
    OpenCV and raise without it, naming the format."""
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _img(32, 48, 3))
    ref = _cv2_read(path)
    np.testing.assert_array_equal(image_io.imread_rgb(path), ref)
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, _img(32, 48, 3))
    np.testing.assert_array_equal(image_io.imread_rgb(bmp), _cv2_read(bmp))
    monkeypatch.setitem(sys.modules, "cv2", None)  # an interpreter without OpenCV
    np.testing.assert_array_equal(image_io.imread_rgb(path), ref)
    with pytest.raises(ValueError, match="BMP.*cv2"):
        image_io.imread_rgb(bmp)
    png = str(tmp_path / "x.png")
    with open(png, "wb") as f:
        f.write(image_io.encode_png(_img(32, 48, 3)))
    assert image_io.imread_rgb(png).shape == (32, 48, 3)


SIZES = [((101, 157), (138, 215)), ((101, 157), (63, 98)), ((101, 157), (50, 78)),
         ((101, 157), (202, 314)), ((480, 640), (657, 876)), ((480, 640), (302, 403)),
         ((37, 23), (50, 31)), ((37, 23), (18, 11)), ((64, 64), (32, 32))]


# INTER_AREA only shrinks on the data path (growing takes INTER_LINEAR)
CASES = [(src, dst, mode) for src, dst in SIZES for mode in ("linear", "area")
         if mode == "linear" or (dst[0] <= src[0] and dst[1] <= src[1])]


@pytest.mark.parametrize("src,dst,mode", CASES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}-{m}" for a, b, m in CASES])
def test_resize_within_one_level_of_cv2(src, dst, mode):
    (h, w), (nh, nw) = src, dst
    img = _img(h, w, 3, seed=h + w)
    cv_mode = cv2.INTER_LINEAR if mode == "linear" else cv2.INTER_AREA
    out = image_io.resize(img, (nw, nh), mode)
    ref = cv2.resize(img, (nw, nh), interpolation=cv_mode)
    assert out.shape == ref.shape and out.dtype == np.uint8
    diff = np.abs(out.astype(int) - ref.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.01


def test_resize_identity_copies():
    img = _img(10, 12, 3)
    out = image_io.resize(img, (12, 10), "linear")
    assert out is not img and np.array_equal(out, img)


def test_no_opencv_import_on_the_png_path():
    """The module imports no cv2 at import time."""
    import subprocess

    code = ("import sys; sys.modules['cv2'] = None\n"
            "from richsem_tpu_torch.data import image_io, transforms, datasets, loader\n"
            "import numpy as np\n"
            "img = np.zeros((8, 10, 3), np.uint8)\n"
            "assert image_io.resize(img, (5, 4), 'area').shape == (4, 5, 3)\n"
            "print('OK')")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, env=dict(os.environ, PYTHONPATH=root), timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr[-2000:]
