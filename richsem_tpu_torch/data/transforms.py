"""Box-aware augmentation pipeline, numpy on the host (counterpart of
``richsem_tpu/data/transforms.py``: the same primitives and recipes, drawing
from the ``random.Random`` in the same order).

Capability parity with the reference aug primitives
(datasets/transforms.py:32-283) and the train/val recipes
(datasets/coco.py:529-696):

  train: HFlip(0.5) → RandomSelect( multi-scale resize 480–800 @ max 1333
         | resize{400,500,600} → RandomSizeCrop(384,600) → multi-scale
         resize ) → Normalize (ImageNet stats, boxes → normalized cxcywh)
  val:   resize 800 @ max 1333 → Normalize

Records are plain dicts of numpy arrays:
  ``image`` HWC uint8 · ``boxes`` [N,4] xyxy float32 (absolute px) ·
  ``labels`` [N] int64 · ``area`` [N] · ``iscrowd`` [N] · ``orig_size``
  (h, w) · ``size`` (h, w after aug).

PIL's bilinear resampling is replaced, as in the JAX package, by OpenCV's
(``INTER_LINEAR``, ``INTER_AREA`` for downscale), here as reproduced by
:mod:`richsem_tpu_torch.data.image_io` (within one level of ``cv2.resize``), so
no path needs OpenCV: the instance masks resize with its ``INTER_NEAREST``,
OpenCV's bit for bit.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from richsem_tpu_torch.data import image_io

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

Record = dict


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------
def hflip(r: Record) -> Record:
    r = dict(r)
    h, w = r["image"].shape[:2]
    r["image"] = np.ascontiguousarray(r["image"][:, ::-1])
    if len(r["boxes"]):
        b = r["boxes"].copy()
        b[:, [0, 2]] = w - b[:, [2, 0]]
        r["boxes"] = b
    if "masks" in r and len(r["masks"]):
        r["masks"] = np.ascontiguousarray(r["masks"][:, :, ::-1])
    if "keypoints" in r and len(r["keypoints"]):
        # (x, y, v): mirror x for visible points (the reference carries
        # keypoints untransformed, datasets/coco.py:508-521; transforming
        # them is strictly more correct)
        kp = r["keypoints"].copy()
        vis = kp[..., 2] > 0
        kp[..., 0] = np.where(vis, w - kp[..., 0], kp[..., 0])
        r["keypoints"] = kp
    return r


def _target_hw(h: int, w: int, size: int, max_size: Optional[int]) -> Tuple[int, int]:
    """Shortest-side resize with max cap (transforms.py:95-115 semantics)."""
    if max_size is not None:
        mn, mx = float(min(h, w)), float(max(h, w))
        if mx / mn * size > max_size:
            size = int(round(max_size * mn / mx))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    if w < h:
        ow = size
        oh = int(size * h / w)
    else:
        oh = size
        ow = int(size * w / h)
    return oh, ow


def resize(r: Record, size: int, max_size: Optional[int] = None) -> Record:
    r = dict(r)
    h, w = r["image"].shape[:2]
    nh, nw = _target_hw(h, w, size, max_size)
    if (nh, nw) != (h, w):
        interp = image_io.INTER_AREA if nh < h else image_io.INTER_LINEAR
        r["image"] = image_io.resize(r["image"], (nw, nh), interp)
    rw, rh = nw / w, nh / h
    if len(r["boxes"]):
        r["boxes"] = r["boxes"] * np.array([rw, rh, rw, rh], np.float32)
    if "area" in r:
        r["area"] = r["area"] * (rw * rh)
    if "masks" in r and len(r["masks"]) and (nh, nw) != (h, w):
        r["masks"] = np.stack(
            [image_io.resize(m.astype(np.uint8), (nw, nh), image_io.INTER_NEAREST)
             for m in r["masks"]]
        ).astype(bool)
    if "keypoints" in r and len(r["keypoints"]):
        kp = r["keypoints"].copy()
        kp[..., 0] *= rw
        kp[..., 1] *= rh
        r["keypoints"] = kp
    r["size"] = (nh, nw)
    return r


def crop(r: Record, top: int, left: int, ch: int, cw: int) -> Record:
    """Crop + clamp boxes + drop degenerate (transforms.py:32-73)."""
    r = dict(r)
    r["image"] = np.ascontiguousarray(r["image"][top : top + ch, left : left + cw])
    r["size"] = (ch, cw)
    if len(r["boxes"]):
        b = r["boxes"] - np.array([left, top, left, top], np.float32)
        b[:, 0::2] = b[:, 0::2].clip(0, cw)
        b[:, 1::2] = b[:, 1::2].clip(0, ch)
        keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
        r["boxes"] = b[keep]
        for f in ("labels", "area", "iscrowd"):
            if f in r:
                r[f] = r[f][keep]
        if "masks" in r and len(r["masks"]):
            r["masks"] = r["masks"][:, top : top + ch, left : left + cw][keep]
        if "keypoints" in r and len(r["keypoints"]):
            kp = r["keypoints"].copy()
            kp[..., 0] -= left
            kp[..., 1] -= top
            inside = (
                (kp[..., 0] >= 0) & (kp[..., 0] < cw)
                & (kp[..., 1] >= 0) & (kp[..., 1] < ch)
            )
            kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
            r["keypoints"] = kp[keep]
        r["area"] = (
            (r["boxes"][:, 2] - r["boxes"][:, 0])
            * (r["boxes"][:, 3] - r["boxes"][:, 1])
        )
    return r


def random_size_crop(r: Record, min_size: int, max_size: int, rng: random.Random) -> Record:
    h, w = r["image"].shape[:2]
    # clamp so small images stay valid (reference assumes shortest side ≥
    # min_size by recipe construction)
    cw = rng.randint(min(min_size, w), max(min(w, max_size), min(min_size, w)))
    ch = rng.randint(min(min_size, h), max(min(h, max_size), min(min_size, h)))
    top = rng.randint(0, h - ch)
    left = rng.randint(0, w - cw)
    return crop(r, top, left, ch, cw)


def normalize(r: Record) -> Record:
    """uint8 HWC → float32 normalized; boxes → normalized cxcywh."""
    r = dict(r)
    img = r["image"].astype(np.float32) / 255.0
    r["image"] = (img - IMAGENET_MEAN) / IMAGENET_STD
    h, w = img.shape[:2]
    if len(r["boxes"]):
        b = r["boxes"].astype(np.float32)
        cxcywh = np.stack(
            [
                (b[:, 0] + b[:, 2]) / 2,
                (b[:, 1] + b[:, 3]) / 2,
                b[:, 2] - b[:, 0],
                b[:, 3] - b[:, 1],
            ],
            axis=1,
        )
        r["boxes"] = cxcywh / np.array([w, h, w, h], np.float32)
    r["size"] = (h, w)
    return r


# ----------------------------------------------------------------------
# recipes
# ----------------------------------------------------------------------
def make_train_aug(
    scales: Sequence[int],
    max_size: int,
    scales2_resize: Sequence[int],
    scales2_crop: Tuple[int, int],
) -> Callable[[Record, random.Random], Record]:
    """The geometric train recipe, *without* the final normalize."""

    def tf(r: Record, rng: random.Random) -> Record:
        if rng.random() < 0.5:
            r = hflip(r)
        if rng.random() < 0.5:
            r = resize(r, rng.choice(list(scales)), max_size)
        else:
            r = resize(r, rng.choice(list(scales2_resize)))
            r = random_size_crop(r, scales2_crop[0], scales2_crop[1], rng)
            r = resize(r, rng.choice(list(scales)), max_size)
        return r

    return tf


def make_train_transform(
    scales: Sequence[int],
    max_size: int,
    scales2_resize: Sequence[int],
    scales2_crop: Tuple[int, int],
) -> Callable[[Record, random.Random], Record]:
    aug = make_train_aug(scales, max_size, scales2_resize, scales2_crop)

    def tf(r: Record, rng: random.Random) -> Record:
        return normalize(aug(r, rng))

    return tf


def mosaic_compose(
    records: Sequence[Record],
    rng: random.Random,
    img_scale: Tuple[int, int] = (640, 640),
    center_ratio_range: Tuple[float, float] = (0.5, 1.5),
    pad_val: int = 114,
) -> Record:
    """Compose 4 records into one 2×img_scale mosaic.

    Parity with the reference's mmdet-style Mosaic
    (datasets/transforms.py:303-601): canvas = 2×(h, w) filled with
    ``pad_val``; a random center in ``center_ratio_range × img_scale``
    splits it into 4 quadrants; each image is scale-fit to ``img_scale``
    (keep ratio) then cropped to its quadrant; boxes shift and clip, and
    degenerate boxes drop.
    """
    assert len(records) == 4
    sh, sw = img_scale
    ch, cw = 2 * sh, 2 * sw
    canvas = np.full((ch, cw, 3), pad_val, records[0]["image"].dtype)
    cy = int(rng.uniform(*center_ratio_range) * sh)
    cx = int(rng.uniform(*center_ratio_range) * sw)
    out_boxes, out_labels, out_area, out_crowd = [], [], [], []
    for pos, r in zip(("tl", "tr", "bl", "br"), records):
        img = r["image"]
        h, w = img.shape[:2]
        s = min(sh / h, sw / w)
        nh, nw = int(h * s), int(w * s)
        if (nh, nw) != (h, w):
            interp = image_io.INTER_AREA if nh < h else image_io.INTER_LINEAR
            img = image_io.resize(img, (nw, nh), interp)
        # paste coords on canvas and source-crop coords
        if pos == "tl":
            x1, y1, x2, y2 = max(cx - nw, 0), max(cy - nh, 0), cx, cy
            sx1, sy1 = nw - (x2 - x1), nh - (y2 - y1)
        elif pos == "tr":
            x1, y1, x2, y2 = cx, max(cy - nh, 0), min(cx + nw, cw), cy
            sx1, sy1 = 0, nh - (y2 - y1)
        elif pos == "bl":
            x1, y1, x2, y2 = max(cx - nw, 0), cy, cx, min(cy + nh, ch)
            sx1, sy1 = nw - (x2 - x1), 0
        else:
            x1, y1, x2, y2 = cx, cy, min(cx + nw, cw), min(cy + nh, ch)
            sx1, sy1 = 0, 0
        canvas[y1:y2, x1:x2] = img[sy1 : sy1 + (y2 - y1), sx1 : sx1 + (x2 - x1)]
        if len(r["boxes"]):
            b = r["boxes"] * s
            b = b + np.array([x1 - sx1, y1 - sy1, x1 - sx1, y1 - sy1], np.float32)
            b[:, 0::2] = b[:, 0::2].clip(x1, x2)
            b[:, 1::2] = b[:, 1::2].clip(y1, y2)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            out_boxes.append(b[keep])
            out_labels.append(r["labels"][keep])
            out_crowd.append(r.get("iscrowd", np.zeros(len(r["labels"]), np.int64))[keep])
    boxes = (
        np.concatenate(out_boxes).astype(np.float32)
        if out_boxes
        else np.zeros((0, 4), np.float32)
    )
    labels = (
        np.concatenate(out_labels) if out_labels else np.zeros((0,), np.int64)
    )
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return {
        "image": canvas,
        "boxes": boxes,
        "labels": labels,
        "area": area,
        "iscrowd": np.concatenate(out_crowd) if out_crowd else np.zeros((0,), np.int64),
        "image_id": records[0].get("image_id", 0),
        "orig_size": records[0].get("orig_size", (ch, cw)),
        "is_extra": records[0].get("is_extra", False),
        "neg_category_ids": records[0].get("neg_category_ids", []),
        "not_exhaustive_category_ids": records[0].get("not_exhaustive_category_ids", []),
        "size": (ch, cw),
    }


def make_eval_transform(scales: Sequence[int], max_size: int) -> Callable[[Record], Record]:
    size = max(scales)

    def tf(r: Record) -> Record:
        return normalize(resize(r, size, max_size))

    # deterministic: post-transform size is predictable from metadata — lets
    # the loader plan bucket-grouped batch counts without decoding images
    tf.size_hint = lambda h, w: _target_hw(h, w, size, max_size)
    return tf
