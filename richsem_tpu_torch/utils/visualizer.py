"""Detection visualization without OpenCV (counterpart of ``richsem_tpu/utils/visualizer.py``).

:func:`draw_detections` draws boxes with their class names and scores on an
image as the JAX package's does with ``cv2.rectangle`` and ``cv2.putText``,
and :func:`save_detections` writes the result with the port's PNG (or JPEG)
encoder. The pixels are OpenCV's:

* rectangles follow ``cv2.rectangle``'s rule (8-connected, no shift): a
  one-pixel outline for thickness 1; for thickness t > 1 a band of half-width
  ``(t + t % 2) // 2`` along each side and at each corner a filled disc of
  radius ``(t + 1) // 2`` in OpenCV's ``Circle`` spans; filled for t < 0;
  clipped to the image;
* the text is ``cv2.putText(..., FONT_HERSHEY_SIMPLEX, 0.5, white, 1,
  LINE_AA)``: each character's antialiased alpha mask, offset from the pen
  and advance come from a table made with OpenCV
  (:mod:`richsem_tpu_torch.utils.glyphs`; ASCII 32-126, any other character
  drawn as ``?``), blended as ``bg + ((255 - bg) * alpha + 127) // 255``.
"""

from __future__ import annotations

import colorsys
from typing import Dict, Optional, Tuple

import numpy as np

from richsem_tpu_torch.data.image_io import encode_jpeg, encode_png
from richsem_tpu_torch.utils import glyphs


def _color(cid: int) -> Tuple[int, int, int]:
    h = (cid * 0.618033988749895) % 1.0
    r, g, b = colorsys.hsv_to_rgb(h, 0.65, 0.95)
    return int(b * 255), int(g * 255), int(r * 255)  # BGR


def _fill(img: np.ndarray, y0: int, y1: int, x0: int, x1: int, color) -> None:
    """Set the pixels [y0, y1] x [x0, x1] (inclusive) inside ``img``."""
    h, w = img.shape[:2]
    y0, y1, x0, x1 = max(y0, 0), min(y1, h - 1), max(x0, 0), min(x1, w - 1)
    if y0 <= y1 and x0 <= x1:
        img[y0:y1 + 1, x0:x1 + 1] = color


def _disc_spans(r: int):
    """OpenCV's filled ``Circle`` of radius ``r``: (dy, x_lo, x_hi) spans."""
    spans = []
    err, dx, dy, plus, minus = 0, r, 0, 1, 2 * r - 1
    while dx >= dy:
        spans += [(-dy, -dx, dx), (dy, -dx, dx), (-dx, -dy, dy), (dx, -dy, dy)]
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    return spans


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` in place (integer
    corners, 8-connected)."""
    (x0, y0), (x1, y1) = (int(v) for v in p1), (int(v) for v in p2)
    if thickness < 0:
        _fill(img, min(y0, y1), max(y0, y1), min(x0, x1), max(x0, x1), color)
        return img
    half = 0 if thickness <= 1 else (thickness + thickness % 2) // 2
    discs = _disc_spans((thickness + 1) // 2) if thickness > 1 else ()
    corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    for (ax, ay), (bx, by) in zip(corners, corners[1:] + corners[:1]):
        if ay == by:
            _fill(img, ay - half, ay + half, min(ax, bx), max(ax, bx), color)
        else:
            _fill(img, min(ay, by), max(ay, by), ax - half, ax + half, color)
        for dy, lo, hi in discs:  # each side ends in a disc
            _fill(img, by + dy, by + dy, bx + lo, bx + hi, color)
    return img


def text_size(text: str) -> Tuple[int, int]:
    """``cv2.getTextSize(text, FONT_HERSHEY_SIMPLEX, 0.5, 1)[0]``: (width, height)."""
    if not text:
        return 0, 0
    return sum(glyphs.glyph(c)[3] for c in text) + 1, glyphs.TEXT_HEIGHT


def put_text(img: np.ndarray, text: str, org) -> np.ndarray:
    """``cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, (255, 255,
    255), 1, LINE_AA)`` in place on a uint8 image."""
    h, w = img.shape[:2]
    x, y = int(org[0]), int(org[1])
    for c in text:
        alpha, dx, dy, adv = glyphs.glyph(c)
        gy, gx = y + dy, x + dx
        y0, x0 = max(gy, 0), max(gx, 0)
        y1, x1 = min(gy + alpha.shape[0], h), min(gx + alpha.shape[1], w)
        if y1 > y0 and x1 > x0:
            a = alpha[y0 - gy:y1 - gy, x0 - gx:x1 - gx].astype(np.int32)
            if img.ndim == 3:
                a = a[..., None]
            bg = img[y0:y1, x0:x1].astype(np.int32)
            img[y0:y1, x0:x1] = (bg + ((255 - bg) * a + 127) // 255).astype(np.uint8)
        x += adv
    return img


def draw_detections(
    image: np.ndarray,  # HWC uint8 RGB
    boxes: np.ndarray,  # [N, 4] xyxy pixels
    labels: np.ndarray,  # [N]
    scores: Optional[np.ndarray] = None,
    class_names: Optional[Dict[int, str]] = None,
    score_thresh: float = 0.3,
    thickness: int = 2,
) -> np.ndarray:
    """-> BGR uint8 image with the boxes and their labels drawn."""
    canvas = np.ascontiguousarray(np.asarray(image, np.uint8)[..., ::-1])
    for i in range(len(boxes)):
        s = float(scores[i]) if scores is not None else 1.0
        if s < score_thresh:
            continue
        x0, y0, x1, y1 = [int(v) for v in boxes[i]]
        cid = int(labels[i])
        color = _color(cid)
        rectangle(canvas, (x0, y0), (x1, y1), color, thickness)
        name = (class_names or {}).get(cid, str(cid))
        text = f"{name} {s:.2f}" if scores is not None else name
        tw, th = text_size(text)
        rectangle(canvas, (x0, y0 - th - 4), (x0 + tw + 2, y0), color, -1)
        put_text(canvas, text, (x0 + 1, y0 - 3))
    return canvas


def save_detections(path: str, image, boxes, labels, scores=None, **kw) -> None:
    """Draw (:func:`draw_detections`) and write ``path``: PNG, or JPEG at
    quality 95 (``cv2.imwrite``'s default) for a ``.jpg``/``.jpeg`` name."""
    rgb = draw_detections(image, boxes, labels, scores, **kw)[..., ::-1]
    ext = path.lower().rsplit(".", 1)[-1]
    if ext in ("jpg", "jpeg"):
        data = encode_jpeg(np.ascontiguousarray(rgb), quality=95)
    elif ext == "png":
        data = encode_png(np.ascontiguousarray(rgb))
    else:
        raise ValueError(f"save_detections writes .png or .jpg, got {path!r}")
    with open(path, "wb") as f:
        f.write(data)
