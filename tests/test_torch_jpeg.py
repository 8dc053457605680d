"""The port's JPEG codec (``richsem_tpu_torch/csrc/jpeg_host.c`` through
``richsem_tpu_torch/data/image_io.py``) held against OpenCV and PIL, which the
JAX data path calls (``richsem_tpu/data/datasets.py:36``,
``richsem_tpu/data/misc_utils.py:89-91``).

* The decoder equals ``cv2.imdecode`` + ``BGR2RGB`` exactly on
  ``cv2.imencode``'s output: qualities 50, 75, 90 and 95; 4:4:4, 4:2:2, 4:2:0,
  4:4:0 and 4:1:1; gray; sizes 1x1, 3x5, 7x9, 17x33 and 641x479; restart
  intervals. With ``orient=False`` it equals PIL's ``.convert("RGB")``.
* ``imread_rgb`` applies the Exif orientations 1-8 as ``cv2.imread`` does.
* Progressive, arithmetic-coded, lossless, 12-bit and four-component files
  raise ``NotImplementedError`` naming the variant; a truncated stream raises
  ``ValueError`` with the byte offset.
* The encoder's quantization tables equal those in ``cv2.imencode``'s bytes
  at the same quality, and ``cv2.imdecode`` of its bytes equals
  ``cv2.imdecode`` of OpenCV's own encoding of the same image exactly.
"""

import io
import struct

import cv2
import numpy as np
import pytest

from richsem_tpu_torch.data import image_io

SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}
SIZES = [(1, 1), (3, 5), (7, 9), (17, 33), (479, 641)]


def _img(h, w, seed=0):
    """A smooth pattern with noise, as photographs and the bench's corpus are."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 80 * np.sin(xx / 6.0) * np.cos(yy / 9.0)
    return np.clip(base[..., None] + rng.normal(0, 30, (h, w, 3)), 0, 255).astype(np.uint8)


def _cv2_encode(img_rgb, *params) -> bytes:
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR), list(params))
    assert ok
    return buf.tobytes()


def _cv2_decode(data: bytes) -> np.ndarray:
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


@pytest.mark.parametrize("quality", [50, 75, 90, 95])
@pytest.mark.parametrize("sampling", list(SAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_equals_cv2(size, sampling, quality):
    h, w = size
    data = _cv2_encode(_img(h, w, seed=h * w + quality), cv2.IMWRITE_JPEG_QUALITY, quality,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
    out = image_io.decode_jpeg(data)
    assert out.dtype == np.uint8 and out.shape == (h, w, 3)
    np.testing.assert_array_equal(out, _cv2_decode(data))


@pytest.mark.parametrize("rst", [1, 3, 7])
@pytest.mark.parametrize("sampling", ["444", "420"])
def test_restart_intervals_equal_cv2(sampling, rst):
    data = _cv2_encode(_img(61, 83, seed=rst), cv2.IMWRITE_JPEG_QUALITY, 90,
                       cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                       cv2.IMWRITE_JPEG_RST_INTERVAL, rst)
    assert b"\xff\xdd" in data  # a DRI segment
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _cv2_decode(data))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (64, 80)])
def test_gray_equals_cv2(size):
    gray = _img(*size, seed=5)[..., 0]
    ok, buf = cv2.imencode(".jpg", gray, [cv2.IMWRITE_JPEG_QUALITY, 90])
    data = buf.tobytes()
    out = image_io.decode_jpeg(data)
    np.testing.assert_array_equal(out, _cv2_decode(data))
    assert (out[..., 0] == out[..., 1]).all() and (out[..., 1] == out[..., 2]).all()


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
def test_orient_false_equals_pil(sampling):
    from PIL import Image

    data = _exif(_cv2_encode(_img(48, 64, seed=3), cv2.IMWRITE_JPEG_QUALITY, 90,
                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]), 6)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    out = image_io.decode_jpeg(data, orient=False)
    assert out.shape == (48, 64, 3)  # PIL's convert leaves the orientation alone
    np.testing.assert_array_equal(out, pil)


def _exif(data: bytes, orientation: int, endian: str = "<") -> bytes:
    """``data`` with an APP1 Exif segment whose IFD0 holds ``orientation``."""
    tiff = ((b"II" if endian == "<" else b"MM") + struct.pack(endian + "HI", 42, 8)
            + struct.pack(endian + "H", 1)
            + struct.pack(endian + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(endian + "I", 0))
    body = b"Exif\x00\x00" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body + data[2:]


@pytest.mark.parametrize("endian", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_equals_cv2_imread(tmp_path, orientation, endian):
    path = str(tmp_path / "o.jpg")
    with open(path, "wb") as f:
        f.write(_exif(_cv2_encode(_img(48, 64, seed=7), cv2.IMWRITE_JPEG_QUALITY, 90),
                      orientation, endian))
    ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    out = image_io.imread_rgb(path)
    assert out.shape == ref.shape == ((48, 64, 3) if orientation < 5 else (64, 48, 3))
    np.testing.assert_array_equal(out, ref)


def test_unsupported_variants_raise(tmp_path):
    img = _img(40, 56, seed=2)
    progressive = _cv2_encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1)
    path = str(tmp_path / "prog.jpg")
    with open(path, "wb") as f:
        f.write(progressive)
    with pytest.raises(NotImplementedError, match=r"prog\.jpg: progressive JPEG \(SOF2\)"):
        image_io.imread_rgb(path)
    # the same frame header marked arithmetic-coded (SOF9), and 12-bit
    base = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, 90)
    sof = base.index(b"\xff\xc0")
    with pytest.raises(NotImplementedError, match=r"arithmetic-coded JPEG \(SOF9\)"):
        image_io.decode_jpeg(base[:sof + 1] + b"\xc9" + base[sof + 2:])
    with pytest.raises(NotImplementedError, match=r"12-bit JPEG"):
        image_io.decode_jpeg(base[:sof + 4] + b"\x0c" + base[sof + 5:])
    with pytest.raises(NotImplementedError, match=r"lossless JPEG \(SOF3\)"):
        image_io.decode_jpeg(base[:sof + 1] + b"\xc3" + base[sof + 2:])
    with pytest.raises(NotImplementedError, match=r"4-component JPEG \(CMYK or YCCK\)"):
        image_io.decode_jpeg(base[:sof + 9] + b"\x04" + base[sof + 10:])


@pytest.mark.parametrize("keep", [0.25, 0.5, 0.9])
def test_truncated_stream_raises_with_offset(tmp_path, keep):
    data = _cv2_encode(_img(64, 96, seed=4), cv2.IMWRITE_JPEG_QUALITY, 90)
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(data[: int(len(data) * keep)])
    with pytest.raises(ValueError, match=r"cut\.jpg: .*ends early.* at byte offset \d+"):
        image_io.imread_rgb(path)


def _dqt(data: bytes) -> dict:
    """The quantization tables of a JPEG's DQT segments, by id, zig-zag order."""
    tables, i = {}, 2
    while i < len(data):
        marker, n = data[i + 1], struct.unpack(">H", data[i + 2:i + 4])[0]
        if marker == 0xDB:
            seg, j = data[i + 4:i + 2 + n], 0
            while j < len(seg):
                tables[seg[j] & 15] = list(seg[j + 1:j + 65])
                j += 65
        if marker == 0xDA:
            break
        i += 2 + n
    return tables


@pytest.mark.parametrize("quality", [1, 10, 25, 50, 75, 90, 95, 100])
def test_encoder_tables_equal_cv2(quality):
    img = _img(16, 16)
    ref = _dqt(_cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality))
    assert _dqt(image_io.encode_jpeg(img, quality)) == ref


@pytest.mark.parametrize("quality", [50, 90, 95, 100])
@pytest.mark.parametrize("size", [(1, 1), (7, 9), (15, 17), (480, 640)],
                         ids=["1x1", "7x9", "15x17", "480x640"])
def test_encoder_decodes_as_cv2_encoding(size, quality):
    img = _img(*size, seed=size[0] + quality)
    ours = image_io.encode_jpeg(img, quality)
    ref = _cv2_encode(img, cv2.IMWRITE_JPEG_QUALITY, quality)
    np.testing.assert_array_equal(_cv2_decode(ours), _cv2_decode(ref))
    np.testing.assert_array_equal(image_io.decode_jpeg(ours), _cv2_decode(ours))


def test_encoder_refuses_other_layouts():
    with pytest.raises(ValueError, match="uint8"):
        image_io.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        image_io.encode_jpeg(np.zeros((4, 4, 3), np.float32))
