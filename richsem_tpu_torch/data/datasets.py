"""Detection datasets: COCO / LVIS / weak-label image folders (counterpart of
``richsem_tpu/data/datasets.py``; images decode through
:func:`richsem_tpu_torch.data.image_io.imread_rgb`, and the instance masks
rasterise through :func:`richsem_tpu_torch.data.image_io.fill_poly` and
resize through its ``INTER_NEAREST``, OpenCV's pixels without OpenCV).

Capability parity:
  * ``CocoDetection``-style record loading (datasets/coco.py:407-526):
    annotation → boxes/labels/area/iscrowd arrays, crowd filter, box
    clamping, degenerate-box drop; corrupt images skip to a neighbor index
    (coco.py:415-420 — including the fix for the reference's
    out-of-range ``randint(0, len(self))`` at lvis.py:167).
  * ``LvisDetection`` (datasets/lvis.py:149-182): file name from coco_url,
    per-image neg/not-exhaustive category sets kept for the evaluator.
  * ``ImageFolderDetection``/``ImagenetDetection`` (coco.py:758-801,
    lvis.py:185-233): classification folders as whole-image-box detection
    records with an optional folder→class mapping; marks ``is_extra`` for
    the weak-label loss masking path.
  * ``build_dataset`` dispatch by ``cfg.dataset_file``
    (datasets/__init__.py:20-39).

Labels are raw category ids (LVIS 1..1203 with ``num_classes=1204``), as in
the reference.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from richsem_tpu_torch.data.coco_api import CocoIndex
from richsem_tpu_torch.data.image_io import INTER_NEAREST, fill_poly, imread_rgb, resize
from richsem_tpu_torch.data.transforms import Record


def _load_image(path: str) -> Optional[np.ndarray]:
    return imread_rgb(path)


class DetectionDataset:
    """COCO/LVIS-format dataset producing raw records (pre-transform)."""

    def __init__(
        self,
        img_root: str,
        index: CocoIndex,
        transform: Optional[Callable] = None,
        is_train: bool = True,
        is_extra: bool = False,
        drop_ratio: float = 0.0,
        seed: int = 0,
        with_masks: bool = False,
    ):
        self.img_root = img_root
        self.index = index
        self.transform = transform
        self.is_train = is_train
        self.is_extra = is_extra
        self.with_masks = with_masks
        self.img_ids = index.get_img_ids()
        if drop_ratio > 0:  # lvis partial-annotation drop (lvis.py:281-293)
            rng = random.Random(seed)
            keep = int(len(self.img_ids) * (1.0 - drop_ratio))
            self.img_ids = sorted(rng.sample(self.img_ids, keep))

    def __len__(self) -> int:
        return len(self.img_ids)

    def category_ids_per_image(self) -> List[List[int]]:
        out = []
        for img_id in self.img_ids:
            out.append(
                sorted({a["category_id"] for a in self.index.load_anns_for_img(img_id)})
            )
        return out

    def load_raw(self, i: int) -> Optional[Record]:
        img_id = self.img_ids[i]
        info = self.index.load_img(img_id)
        path = os.path.join(self.img_root, CocoIndex.file_name_of(info))
        img = _load_image(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        boxes, labels, area, iscrowd, masks = [], [], [], [], []
        keypoints = []
        has_kp = False
        for a in self.index.load_anns_for_img(img_id):
            if a.get("iscrowd", 0) and self.is_train:
                continue
            x, y, bw, bh = a["bbox"]
            x0, y0 = max(x, 0), max(y, 0)
            x1, y1 = min(x + bw, w), min(y + bh, h)
            if x1 <= x0 or y1 <= y0:
                continue
            boxes.append([x0, y0, x1, y1])
            labels.append(a["category_id"])
            area.append(a.get("area", (x1 - x0) * (y1 - y0)))
            iscrowd.append(a.get("iscrowd", 0))
            if self.with_masks:
                masks.append(_polygons_to_mask(a.get("segmentation"), h, w))
            if "keypoints" in a:
                # (x, y, visibility) triplets (ConvertCocoPolysToMask,
                # datasets/coco.py:508-521)
                has_kp = True
                keypoints.append(
                    np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
                )
        extra_fields = {}
        if self.with_masks:
            extra_fields["masks"] = (
                np.stack(masks) if masks else np.zeros((0, h, w), bool)
            )
        if has_kp:
            extra_fields["keypoints"] = np.stack(keypoints)
        return {
            **extra_fields,
            "image": img,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "labels": np.asarray(labels, np.int64),
            "area": np.asarray(area, np.float32),
            "iscrowd": np.asarray(iscrowd, np.int64),
            "image_id": img_id,
            "orig_size": (h, w),
            "is_extra": self.is_extra,
            "neg_category_ids": info.get("neg_category_ids", []),
            "not_exhaustive_category_ids": info.get(
                "not_exhaustive_category_ids", []
            ),
        }

    def size_hint(self, i: int):
        """Post-transform (h, w) predicted from index metadata, or None
        when the transform is augmentation-dependent (train)."""
        hint = getattr(self.transform, "size_hint", None)
        if hint is None:
            return None
        info = self.index.load_img(self.img_ids[i])
        h, w = info.get("height"), info.get("width")
        if not h or not w:
            return None
        return hint(h, w)

    def get(self, i: int, rng: random.Random) -> Record:
        """Load with corrupt-image fallback to a random other index."""
        for _ in range(10):
            r = self.load_raw(i)
            if r is not None:
                break
            i = rng.randrange(len(self))
        else:
            raise RuntimeError("too many corrupt images")
        if self.transform is not None:
            r = (
                self.transform(r, rng) if self.is_train else self.transform(r)
            )
        return r


class ImageFolderDetection:
    """Classification folders → whole-image-box detection records.

    Each image yields one box covering the full image, labeled by mapping
    the folder name through ``folder_to_cat`` (IN-21k wnid → LVIS id); an
    unmapped folder yields an unlabeled record (pseudo-label path).
    """

    def __init__(
        self,
        root: str,
        folder_to_cat: Optional[Dict[str, int]] = None,
        transform: Optional[Callable] = None,
        is_train: bool = True,
        exts: Sequence[str] = (".jpg", ".jpeg", ".png"),
    ):
        self.root = root
        self.transform = transform
        self.is_train = is_train
        self.samples: List[tuple] = []
        self.is_extra = True
        for folder in sorted(os.listdir(root)):
            fdir = os.path.join(root, folder)
            if not os.path.isdir(fdir):
                continue
            cat = (folder_to_cat or {}).get(folder, -1)
            for fn in sorted(os.listdir(fdir)):
                if fn.lower().endswith(tuple(exts)):
                    self.samples.append((os.path.join(fdir, fn), cat))

    def __len__(self) -> int:
        return len(self.samples)

    def category_ids_per_image(self) -> List[List[int]]:
        return [[c] if c >= 0 else [] for _, c in self.samples]

    def load_raw(self, i: int) -> Optional[Record]:
        path, cat = self.samples[i]
        img = _load_image(path)
        if img is None:
            return None
        h, w = img.shape[:2]
        has_label = cat >= 0
        return {
            "image": img,
            "boxes": np.asarray([[0, 0, w, h]], np.float32)
            if has_label
            else np.zeros((0, 4), np.float32),
            "labels": np.asarray([cat] if has_label else [], np.int64),
            "area": np.asarray([float(w * h)] if has_label else [], np.float32),
            "iscrowd": np.zeros((1 if has_label else 0,), np.int64),
            "image_id": i,
            "orig_size": (h, w),
            "is_extra": True,
            "neg_category_ids": [],
            "not_exhaustive_category_ids": [],
        }

    def get(self, i: int, rng: random.Random) -> Record:
        for _ in range(10):
            r = self.load_raw(i)
            if r is not None:
                break
            i = rng.randrange(len(self))
        else:
            raise RuntimeError("too many corrupt images")
        if self.transform is not None:
            r = self.transform(r, rng) if self.is_train else self.transform(r)
        return r


class MosaicDataset:
    """4-image Mosaic wrapper for the weak-label branch.

    Parity with the reference's Mosaic-aware CocoDetection (coco.py:425-434
    pre-fetches 3 mix images via ``get_indexes``) + the imagenet transform
    recipe that appends ``T.Mosaic()`` before normalize (coco.py:655-662).
    """

    def __init__(self, base, aug_tf, prob: float = 1.0,
                 img_scale=(640, 640)):
        self.base = base
        self.aug_tf = aug_tf
        self.prob = prob
        self.img_scale = tuple(img_scale)
        self.is_extra = getattr(base, "is_extra", False)

    def __len__(self):
        return len(self.base)

    def category_ids_per_image(self):
        return self.base.category_ids_per_image()

    def _raw_aug(self, i: int, rng: random.Random) -> Record:
        for _ in range(10):
            r = self.base.load_raw(i)
            if r is not None:
                break
            i = rng.randrange(len(self.base))
        else:
            raise RuntimeError("too many corrupt images")
        return self.aug_tf(r, rng)

    def get(self, i: int, rng: random.Random) -> Record:
        from richsem_tpu_torch.data.transforms import mosaic_compose, normalize

        if rng.random() > self.prob:
            return normalize(self._raw_aug(i, rng))
        idxs = [i] + [rng.randrange(len(self.base)) for _ in range(3)]
        recs = [self._raw_aug(j, rng) for j in idxs]
        return normalize(mosaic_compose(recs, rng, self.img_scale))


def build_dataset(image_set: str, cfg, imagenet_lvis: bool = False):
    """Dispatch by ``cfg.dataset_file`` (datasets/__init__.py:20-39)."""
    from richsem_tpu_torch.data.transforms import make_eval_transform, make_train_transform

    is_train = image_set == "train"
    if is_train:
        tf = make_train_transform(
            cfg.data_aug_scales, cfg.data_aug_max_size,
            cfg.data_aug_scales2_resize, tuple(cfg.data_aug_scales2_crop),
        )
    else:
        tf = make_eval_transform(cfg.data_aug_scales, cfg.data_aug_max_size)

    root = getattr(cfg, "data_root", "DATASET")
    name = cfg.dataset_file
    if imagenet_lvis or name == "inet_lvis":
        mapping = getattr(cfg, "imagenet_lvis_mapping", None)
        folder_to_cat = None
        if mapping and os.path.isfile(mapping):
            import json

            with open(mapping) as f:
                folder_to_cat = json.load(f)
        ds = ImageFolderDetection(
            cfg.imagenet_path, folder_to_cat, transform=tf, is_train=True
        )
        if getattr(cfg, "imagenet_use_mosaic", False):
            from richsem_tpu_torch.data.transforms import make_train_aug

            aug = make_train_aug(
                cfg.data_aug_scales, cfg.data_aug_max_size,
                cfg.data_aug_scales2_resize, tuple(cfg.data_aug_scales2_crop),
            )
            ds = MosaicDataset(ds, aug)
        return ds
    if name in ("lvis", "lvis_openvocab"):
        split = "train" if is_train else "val"
        ann = os.path.join(root, "lvis_v1", f"lvis_v1_{split}.json")
        if name == "lvis_openvocab" and is_train:
            ann = os.path.join(root, "lvis_v1", "lvis_v1_train_norare.json")
        index = CocoIndex(ann)
        return DetectionDataset(
            os.path.join(root, "coco"), index, tf, is_train=is_train,
            drop_ratio=getattr(cfg, "lvis_drop_ratio", 0.0) if is_train else 0.0,
            with_masks=getattr(cfg, "masks", False),
        )
    if name == "coco":
        split = "train2017" if is_train else "val2017"
        ann = os.path.join(root, "coco", "annotations", f"instances_{split}.json")
        index = CocoIndex(ann)
        return DetectionDataset(
            os.path.join(root, "coco", split), index, tf, is_train=is_train,
            with_masks=getattr(cfg, "masks", False),
        )
    if name in ("o365", "vg", "oid", "cc3m"):
        # COCO-format extra datasets (datasets/coco.py:804-822
        # build_extra_cocostyle_data): annotations at
        # <root>/<name>/annotations/{train,val}.json, images under
        # <root>/<name>/; weak-label semantics via is_extra
        split = "train" if is_train else "val"
        ann = os.path.join(root, name, "annotations", f"{split}.json")
        index = CocoIndex(ann)
        return DetectionDataset(
            os.path.join(root, name), index, tf, is_train=is_train,
            is_extra=getattr(cfg, "use_extra_data", False),
        )
    raise ValueError(f"unknown dataset_file {name!r}")


def _rle_counts(segmentation) -> List[int]:
    """COCO RLE counts, decoding the compressed LEB128-style string form
    (the published pycocotools `rleFrString` scheme: 5-bit groups, bit 5 =
    continuation, sign-extension, and delta coding from counts[i-2])."""
    counts = segmentation["counts"]
    if isinstance(counts, list):
        return [int(c) for c in counts]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    out: List[int] = []
    i = 0
    while i < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[i]) - 48
            i += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


def _rle_to_mask(segmentation: dict, h: int, w: int) -> np.ndarray:
    """COCO RLE (crowd) segmentation → bool bitmap [h, w] (column-major
    runs, alternating background/foreground), replacing pycocotools
    annToMask for the `iscrowd=1` records (datasets/coco.py:470-490)."""
    rh, rw = segmentation.get("size", (h, w))
    counts = _rle_counts(segmentation)
    flat = np.zeros(rh * rw, bool)
    pos = 0
    val = False
    for c in counts:
        if val:
            flat[pos : pos + c] = True
        pos += c
        val = not val
    mask = flat.reshape((rw, rh)).T  # column-major
    if (rh, rw) != (h, w):
        mask = resize(mask.astype(np.uint8), (w, h), INTER_NEAREST).astype(bool)
    return mask


def _polygons_to_mask(segmentation, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygons or RLE) → bool bitmap [h, w].

    Replaces pycocotools' annToMask (ConvertCocoPolysToMask,
    datasets/coco.py:463-526): polygon lists rasterize as ``cv2.fillPoly``
    does (:func:`~richsem_tpu_torch.data.image_io.fill_poly`);
    dict segmentations (crowd RLE, compressed or uncompressed) decode via
    :func:`_rle_to_mask`.
    """
    if isinstance(segmentation, dict):
        return _rle_to_mask(segmentation, h, w)
    mask = np.zeros((h, w), np.uint8)
    if isinstance(segmentation, list):
        polys = [
            np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
            for p in segmentation
            if len(p) >= 6
        ]
        if polys:
            fill_poly(mask, polys, 1)
    return mask.astype(bool)
