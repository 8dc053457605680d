"""Image decode and resize without OpenCV.

The JAX data path calls OpenCV in three places on its main path: the decode
(``cv2.imread`` + ``cvtColor``, ``richsem_tpu/data/datasets.py:35-39``) and the
two resizes (``transforms.py:82-83`` and ``:240-241``). This module takes their
place on every machine:

* :func:`imread_rgb` decodes PNG with ``zlib`` and numpy: 8-bit gray, gray +
  alpha, RGB, RGBA and palette images, non-interlaced, every filter type. PNG is
  lossless, so the pixels are ``cv2.imread``'s (alpha dropped, gray repeated).
  JPEG goes through the host codec (``csrc/jpeg_host.c``, :func:`decode_jpeg`),
  which computes libjpeg-turbo's pixels bit for bit, and the APP1 Exif
  orientation is applied as ``cv2.imread(..., IMREAD_COLOR)`` applies it. A
  JPEG variant the codec does not read (progressive, arithmetic, lossless,
  12-bit, four components) raises ``NotImplementedError`` naming the file and
  the variant; a stream that ends early or is corrupt raises ``ValueError``
  with the file and the byte offset, where OpenCV warns and pads it (ROADMAP
  F-P11). Other formats, and PNG variants this decoder does not read
  (interlaced, 16-bit, under 8 bits), go through OpenCV when it imports and
  raise a ``ValueError`` naming the format and the missing decoder when it
  does not.
* :func:`encode_jpeg` writes baseline 4:2:0 JPEG as libjpeg-turbo's defaults
  do at a quality (``cv2.imencode``'s bytes decode to the same pixels).
* :func:`resize` reproduces ``cv2.resize`` on uint8 images: ``INTER_LINEAR``
  (half-pixel centres, edge clamp, OpenCV's 11-bit fixed-point weights and its
  vectorised rounding) and ``INTER_AREA`` (for shrinking, OpenCV's overlap
  weights per axis, summed in float32; for growing, its linear variant).
  Results agree with OpenCV's within one level. ``INTER_NEAREST`` (the
  instance masks') equals OpenCV's bit for bit: source index
  ``floor(x / (dst / src))`` in double, clamped to the last pixel.
* :func:`fill_poly` rasterises polygons as ``cv2.fillPoly(img, polys, 1)``
  does (8-connected edges, 16-bit fixed-point scan lines, OpenCV's clipping of
  edges that leave the image), bit for bit; :func:`line8` draws one
  8-connected line as ``cv2.line(img, p1, p2, 1)``.
"""

from __future__ import annotations

import ctypes
import math
import os
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

INTER_LINEAR = "linear"
INTER_AREA = "area"
INTER_NEAREST = "nearest"

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples a pixel


def _format_of(head: bytes) -> str:
    if head.startswith(PNG_SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    return "unknown"


def _cv2_read(path: str, fmt: str, why: str) -> Optional[np.ndarray]:
    try:
        import cv2
    except ImportError as e:
        raise ValueError(
            f"{path}: {fmt} image ({why}) needs OpenCV's decoder, and cv2 does not "
            f"import ({e}); the built-in decoder reads 8-bit non-interlaced PNG") from e
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        return None
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters: raw [h, 1 + w * bpp] -> [h, w, bpp] uint8."""
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(h, w, bpp)
    if (ftype <= 2).all():  # None / Sub / Up: each row at once
        out = np.zeros((h, w, bpp), np.uint8)
        prior = np.zeros((w, bpp), np.uint8)
        for y in range(h):
            row = filt[y]
            if ftype[y] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint8)  # wraps modulo 256
            elif ftype[y] == 2:
                row = row + prior
            out[y] = prior = row
        return out
    # Average and Paeth depend on the left, upper and upper-left pixels: walk
    # the anti-diagonals, every row of a diagonal at once, each by its filter
    o = np.zeros((h + 1, w + 1, bpp), np.int16)  # a zero row and column in front
    f = filt.astype(np.int16)
    ft = ftype.astype(np.int16)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a, b, c = o[ys + 1, xs], o[ys, xs + 1], o[ys, xs]
        t = ft[ys][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3],
                         [np.zeros_like(a), a, b, (a + b) >> 1], _paeth(a, b, c))
        o[ys + 1, xs + 1] = (f[ys, xs] + pred) & 0xFF
    return o[1:, 1:].astype(np.uint8)


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """PNG bytes -> RGB uint8 [h, w, 3]; None for a truncated or corrupt file.
    Raises ``NotImplementedError`` for a variant the decoder does not read."""
    if not data.startswith(PNG_SIGNATURE):
        return None
    pos, idat, palette, hdr = len(PNG_SIGNATURE), [], None, None
    try:
        while pos + 8 <= len(data):
            n, kind = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + n]
            if len(body) != n:
                return None
            pos += 12 + n
            if kind == b"IHDR":
                hdr = struct.unpack(">IIBBBBB", body)
            elif kind == b"PLTE":
                palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
            elif kind == b"IDAT":
                idat.append(body)
            elif kind == b"IEND":
                break
        if hdr is None or not idat:
            return None
        w, h, depth, ctype, _, _, interlace = hdr
        if ctype not in _CHANNELS:
            return None
        if depth != 8 or interlace:
            raise NotImplementedError(f"bit depth {depth}, interlace {interlace}")
        ch = _CHANNELS[ctype]
        raw = zlib.decompress(b"".join(idat))
    except (struct.error, zlib.error, ValueError):
        return None
    if len(raw) < h * (1 + w * ch):
        return None
    raw = np.frombuffer(raw, np.uint8)[: h * (1 + w * ch)].reshape(h, 1 + w * ch)
    try:
        px = _unfilter(raw, h, w, ch)
    except ValueError:
        return None
    if ctype == 3:
        if palette is None:
            return None
        return palette[np.minimum(px[..., 0], len(palette) - 1)]
    if ctype in (0, 4):  # gray (+ alpha): the alpha is dropped, the gray repeated
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])  # RGB (+ alpha, dropped)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, filters=0, level: int = 1) -> bytes:
    """uint8 [h, w] (gray), [h, w, 3] (RGB) or [h, w, 4] (RGBA) -> PNG bytes.
    ``filters``: one PNG filter type (0-4) for every row, or one per row."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"encode_png takes uint8 [h, w(, c)], got {img.dtype} {img.shape}")
    px = img[..., None] if img.ndim == 2 else img
    h, w, ch = px.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    ft = np.broadcast_to(np.asarray(filters, np.uint8), (h,))
    x = px.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)]
    t = ft.reshape(h, 1, 1)
    filt = (x - np.select([t == k for k in range(4)], preds[:4], preds[4])) & 0xFF
    raw = np.concatenate([ft[:, None], filt.astype(np.uint8).reshape(h, w * ch)], axis=1)
    return (PNG_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------
_MSG = 240


def _codec() -> ctypes.CDLL:
    """``csrc/jpeg_host.c``, built with the host C compiler at first use."""
    from richsem_tpu_torch.ops import _build

    lib = _build.load_host("jpeg_host")
    if not getattr(lib, "_typed", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                    ctypes.c_char_p, ctypes.c_int]
        lib.jpeg_encode.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t)]
        lib.jpeg_free.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


def _raise(code: int, msg: bytes, name: str):
    text = f"{name}: {msg.decode(errors='replace')}"
    if code == 1:
        raise NotImplementedError(f"{text}: the port's JPEG decoder reads baseline and "
                                  "extended sequential Huffman JPEG only")
    raise ValueError(text)


def _exif_orientation(data: bytes) -> int:
    """The Exif orientation tag (0x0112) of IFD0 in a JPEG's APP1 segment, 1-8;
    1 when there is none or it is out of range."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker in (0xD9, 0xDA):
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        body = data[pos + 4:pos + 2 + n]
        if marker == 0xE1 and body[:6] == b"Exif\x00\x00":
            tiff = body[6:]
            try:
                end = {b"II": "<", b"MM": ">"}[tiff[:2]]
                ifd = struct.unpack(end + "I", tiff[4:8])[0]
                count = struct.unpack(end + "H", tiff[ifd:ifd + 2])[0]
                for i in range(count):
                    e = ifd + 2 + 12 * i
                    tag, typ = struct.unpack(end + "HH", tiff[e:e + 4])
                    if tag == 0x0112 and typ == 3:
                        v = struct.unpack(end + "H", tiff[e + 8:e + 10])[0]
                        return v if 1 <= v <= 8 else 1
            except (KeyError, struct.error):
                return 1
            return 1
        pos += 2 + n
    return 1


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ``applyExifOrientation``: flips and a transpose per tag 1-8."""
    flips = {1: (False, None), 2: (False, 1), 3: (False, -1), 4: (False, 0),
             5: (True, None), 6: (True, 1), 7: (True, -1), 8: (True, 0)}
    transpose, flip = flips.get(orientation, (False, None))
    if transpose:
        img = img.transpose(1, 0, 2)
    if flip == 1:
        img = img[:, ::-1]
    elif flip == 0:
        img = img[::-1]
    elif flip == -1:
        img = img[::-1, ::-1]
    return np.ascontiguousarray(img)


def decode_jpeg(data: bytes, orient: bool = True, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> RGB uint8 [h, w, 3], libjpeg-turbo's pixels. ``orient``
    applies the Exif orientation as ``cv2.imread``/``cv2.imdecode`` do;
    ``orient=False`` is PIL's ``Image.open(...).convert("RGB")``. Raises
    ``NotImplementedError`` for a variant the decoder does not read and
    ``ValueError`` for a stream that ends early or is corrupt, each naming
    ``name``."""
    lib = _codec()
    data = bytes(data)
    msg = ctypes.create_string_buffer(_MSG)
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    code = lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), msg, _MSG)
    if code:
        _raise(code, msg.value, name)
    out = np.empty((h.value, w.value, 3), np.uint8)
    code = lib.jpeg_decode(data, len(data), out.ctypes.data, msg, _MSG)
    if code:
        _raise(code, msg.value, name)
    return _apply_orientation(out, _exif_orientation(data)) if orient else out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """RGB uint8 [h, w, 3] -> baseline 4:2:0 JPEG bytes at ``quality``, as
    libjpeg-turbo's defaults write them (``cv2.imencode('.jpg', bgr,
    [IMWRITE_JPEG_QUALITY, quality])`` decodes to the same pixels)."""
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes uint8 [h, w, 3], got {img.dtype} {img.shape}")
    lib = _codec()
    px = np.ascontiguousarray(img)
    buf = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t(0)
    code = lib.jpeg_encode(px.ctypes.data, px.shape[0], px.shape[1], int(quality),
                           ctypes.byref(buf), ctypes.byref(n))
    if code:
        raise ValueError(f"encode_jpeg failed for a {img.shape} image (code {code})")
    try:
        return ctypes.string_at(buf, n.value)
    finally:
        lib.jpeg_free(buf)


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """Read an image file as RGB uint8 [h, w, 3]: ``cv2.imread`` + ``BGR2RGB``
    without OpenCV for PNG and JPEG (the Exif orientation applied). None when
    the file is missing, and for a truncated or corrupt PNG, as ``cv2.imread``
    returns; a JPEG that ends early or is corrupt raises (see the module)."""
    if not os.path.isfile(path):
        return None
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format_of(data[:16])
    if fmt == "JPEG":
        return decode_jpeg(data, name=path)
    if fmt != "PNG":
        return _cv2_read(path, fmt, "not PNG or JPEG")
    try:
        return decode_png(data)
    except NotImplementedError as e:
        return _cv2_read(path, fmt, str(e))


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS


def _linear_taps(src: int, dst: int, area_mode: bool) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's two taps and fixed-point weights along one axis -> (index [dst, 2],
    weight [dst, 2] int32)."""
    scale = src / dst
    d = np.arange(dst, dtype=np.float64)
    if area_mode:
        sx = np.floor(d * scale).astype(np.int64)
        fx = ((d + 1) - (sx + 1) * (dst / src)).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        sx = np.floor(f).astype(np.int64)
        fx = (f - np.floor(f)).astype(np.float32)
    low = sx < 0
    fx[low], sx[low] = 0, 0
    high = sx >= src - 1
    fx[high], sx[high] = 0, src - 1
    w0 = np.rint((np.float32(1) - fx) * np.float32(_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(fx * np.float32(_COEF_SCALE)).astype(np.int32)
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)], 1)
    return idx, np.stack([w0, w1], 1)


def _resize_linear(img: np.ndarray, nw: int, nh: int, area_mode: bool = False) -> np.ndarray:
    h, w = img.shape[:2]
    xi, xw = _linear_taps(w, nw, area_mode)
    yi, yw = _linear_taps(h, nh, area_mode)
    s = img.astype(np.int32)
    # horizontal pass in int32 (weights sum to 2^11), then the two rows each
    # output row reads, combined as OpenCV's vector path does: 16-bit high
    # products of the rows >> 4 with the weights, then a rounding shift by 2
    hor = s[:, xi[:, 0]] * xw[:, 0, None] + s[:, xi[:, 1]] * xw[:, 1, None]
    r0 = hor[yi[:, 0]] >> 4
    r1 = hor[yi[:, 1]] >> 4
    b0 = yw[:, 0].reshape(-1, 1, 1)
    b1 = yw[:, 1].reshape(-1, 1, 1)
    out = (((r0 * b0) >> 16) + ((r1 * b1) >> 16) + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's ``computeResizeAreaTab`` along one axis -> (index [dst, K],
    weight [dst, K] float32), K taps a destination pixel, zero-weight padded."""
    scale = src / dst
    rows = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, (sx1 - fsx1) / cell))
        taps += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wt = np.zeros((dst, k), np.float32)
    for i, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[i, j], wt[i, j] = s, a
    return idx, wt


def _resize_area(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    h, w = img.shape[:2]
    if w % nw == 0 and h % nh == 0:  # OpenCV's integer-scale path: block sums
        sx, sy = w // nw, h // nh
        blocks = img.astype(np.int32).reshape(nh, sy, nw, sx, *img.shape[2:]).sum(axis=(1, 3))
        if (sx, sy) == (2, 2):  # its vector path rounds halves up
            return ((blocks + 2) >> 2).astype(np.uint8)
        return np.clip(np.rint(blocks * np.float32(1.0 / (sx * sy))), 0, 255).astype(np.uint8)
    xi, xw = _area_tab(w, nw)
    yi, yw = _area_tab(h, nh)
    s = img.astype(np.float32)
    hor = np.zeros((h, nw) + img.shape[2:], np.float32)
    for j in range(xi.shape[1]):  # the taps in OpenCV's order, float32 sums
        wj = xw[:, j].reshape((1, nw) + (1,) * (img.ndim - 2))
        hor = hor + s[:, xi[:, j]] * wj
    out = np.zeros((nh, nw) + img.shape[2:], np.float32)
    for j in range(yi.shape[1]):
        wj = yw[:, j].reshape((nh,) + (1,) * (img.ndim - 1))
        out = out + hor[yi[:, j]] * wj
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: Tuple[int, int], interpolation: str = INTER_LINEAR
           ) -> np.ndarray:
    """``cv2.resize(img, (nw, nh), interpolation=...)`` for uint8 [h, w(, c)]."""
    nw, nh = int(size[0]), int(size[1])
    if img.dtype != np.uint8:
        raise TypeError(f"resize takes uint8 images, got {img.dtype}")
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img.copy()
    if nw < 1 or nh < 1:
        raise ValueError(f"bad target size {(nw, nh)}")
    if interpolation == INTER_AREA:
        if nw <= w and nh <= h:
            return _resize_area(img, nw, nh)
        return _resize_linear(img, nw, nh, area_mode=True)
    if interpolation == INTER_LINEAR:
        return _resize_linear(img, nw, nh)
    if interpolation == INTER_NEAREST:
        return img[_nearest_index(h, nh)][:, _nearest_index(w, nw)]
    raise ValueError(f"unknown interpolation {interpolation!r}")


def _nearest_index(src: int, dst: int) -> np.ndarray:
    """OpenCV's ``resizeNN`` source index along one axis: ``floor(x * (1 /
    (dst / src)))`` in double, clamped to ``src - 1``."""
    ifx = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * ifx).astype(np.int64), src - 1)


# ---- polygons (cv2.fillPoly) ------------------------------------------------
_XY_SHIFT = 16  # OpenCV's fixed-point scan-line coordinates
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division (towards zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1: Tuple[int, int], p2: Tuple[int, int]):
    """``cv2.clipLine((0, 0, w, h), p1, p2)`` -> (inside, p1, p2): OpenCV's
    Cohen-Sutherland clip, its quotients in double truncated towards zero; the
    points come back moved even where the line misses the image."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _inside(w: int, h: int, *pts) -> bool:
    return all(0 <= x < w and 0 <= y < h for x, y in pts)


def line8(img: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int], value=1) -> None:
    """``cv2.line(img, p1, p2, value)`` (thickness 1, 8-connected) in place:
    the line clipped to the image, walked from its left end, the minor
    coordinate stepping where Bresenham's error turns negative."""
    h, w = img.shape[:2]
    if not _inside(w, h, p1, p2):
        ok, p1, p2 = clip_line(w, h, p1, p2)
        if not ok:
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy, sy = x2 - x1, y2 - y1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1)
    # the minor steps taken after k major steps: ceil((2 minor k - major) / (2 major))
    m = (2 * minor * k + major - 1) // (2 * major) if major else np.zeros(1, np.int64)
    if vert:
        img[y1 + sy * k, x1 + m] = value
    else:
        img[y1 + sy * m, x1 + k] = value


def fill_poly(img: np.ndarray, polys, value=1) -> np.ndarray:
    """``cv2.fillPoly(img, polys, value)`` (8-connected, no shift) in place on
    a 2-D array, bit for bit: every edge drawn as :func:`line8`, then the scan
    lines between the sorted edge crossings (even-odd) from ``ceil`` of the
    left crossing to ``floor`` of the right one, in OpenCV's 16-bit fixed
    point. An edge that leaves the image takes the slope of its clipped
    segment (its x from that segment where the clip flattens it to one row),
    as OpenCV's ``CollectPolyEdges`` does. -> ``img``."""
    h, w = img.shape[:2]
    edges = []  # (y0, y1, x at y0 in fixed point, dx a row in fixed point)
    for v in polys:
        v = [(int(x), int(y)) for x, y in np.asarray(v).reshape(-1, 2)]
        pt0 = (v[-1][0] << _XY_SHIFT, v[-1][1])
        for x, y in v:
            pt1 = (x << _XY_SHIFT, y)
            t0 = ((pt0[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, pt0[1])
            t1 = ((pt1[0] + (_XY_ONE >> 1)) >> _XY_SHIFT, pt1[1])
            line8(img, t0, t1, value)
            c0, c1 = pt0, pt1
            if not _inside(w, h, t0, t1):
                _, k0, k1 = clip_line(w, h, t0, t1)
                c0 = (k0[0] << _XY_SHIFT, k0[1] if k0[1] != k1[1] else c0[1])
                c1 = (k1[0] << _XY_SHIFT, k1[1] if k0[1] != k1[1] else c1[1])
            if pt0[1] != pt1[1]:
                dx = _tdiv(c1[0] - c0[0], c1[1] - c0[1])
                lo, lo_c = (pt0, c0) if pt0[1] < pt1[1] else (pt1, c1)
                edges.append((lo[1], max(pt0[1], pt1[1]), lo_c[0] + (lo[1] - lo_c[1]) * dx, dx))
            pt0 = pt1
    if len(edges) < 2:
        return img
    y0, y1, x0, dx = (np.array(c, np.int64) for c in zip(*edges))
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << _XY_SHIFT)):
        return img
    rows, xs = [], []
    for e in range(len(edges)):  # each edge's crossing of every scan line it spans
        yy = np.arange(max(y0[e], 0), min(y1[e], h))
        rows.append(yy)
        xs.append(x0[e] + (yy - y0[e]) * dx[e])
    rows, xs = np.concatenate(rows), np.concatenate(xs)
    if not len(rows):
        return img
    order = np.lexsort((xs, rows))  # a closed path crosses each line an even number of times
    rows, xs = rows[order][0::2], xs[order]
    left = (xs[0::2] + _XY_ONE - 1) >> _XY_SHIFT
    right = xs[1::2] >> _XY_SHIFT
    keep = (left < w) & (right >= 0)
    rows, left, right = rows[keep], np.maximum(left[keep], 0), np.minimum(right[keep], w - 1)
    runs = np.zeros((h, w + 1), np.int32)
    np.add.at(runs, (rows, left), 1)
    np.add.at(runs, (rows, right + 1), -1)
    img[np.cumsum(runs[:, :w], axis=1) > 0] = value
    return img
