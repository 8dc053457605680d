"""Side data utilities: the TSV dataset, the SSD random crop and local staging
(counterpart of ``richsem_tpu/data/misc_utils.py``).

* :class:`TsvFile`, :func:`tsv_row_to_record` and :func:`tsv_records` -- rows
  of a tab-separated file whose second column is a class id and whose last
  column is a base64-encoded image (ImageNet-style), with random row access
  through a ``.lineidx`` sidecar of byte offsets (built at first use when
  missing). JPEG rows decode with the port's codec at ``orient=False`` (the
  JAX helper's PIL ``.convert("RGB")`` leaves the Exif orientation alone), PNG
  rows with ``decode_png``; no OpenCV or PIL.
* :func:`ssd_random_crop` -- the SSD IoU-constrained crop, with the JAX
  function's draws from the same ``numpy.random.Generator``.
* :func:`prepare_local_dataset` -- copy files or trees (skipping those that
  exist), or copy and unzip ``.zip`` sources, onto local disk. Under a process
  group only rank 0 copies, and every rank waits on a barrier of the port's
  ``Dist`` group (``parallel/dist.py``), where JAX waits on its multihost
  barrier.
"""

from __future__ import annotations

import base64
import os
import shutil
import zipfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from richsem_tpu_torch.data.image_io import PNG_SIGNATURE, decode_jpeg, decode_png


# ---------------------------------------------------------------------------
# TSV dataset
# ---------------------------------------------------------------------------
class TsvFile:
    """Random access over a tab-separated file via a ``.lineidx`` sidecar."""

    def __init__(self, tsv_path: str):
        self.tsv_path = tsv_path
        self.lineidx_path = os.path.splitext(tsv_path)[0] + ".lineidx"
        if not os.path.exists(self.lineidx_path):
            self._build_lineidx()
        with open(self.lineidx_path) as f:
            self._offsets = [int(line) for line in f if line.strip()]
        self._fp = None

    def _build_lineidx(self) -> None:
        offsets, pos = [], 0
        with open(self.tsv_path, "rb") as f:
            for line in f:
                offsets.append(pos)
                pos += len(line)
        tmp = self.lineidx_path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(str(o) for o in offsets))
        os.replace(tmp, self.lineidx_path)

    def num_rows(self) -> int:
        return len(self._offsets)

    def seek(self, index: int) -> List[str]:
        if self._fp is None:
            self._fp = open(self.tsv_path, "rb")
        self._fp.seek(self._offsets[index])
        return self._fp.readline().decode("utf-8").rstrip("\n").split("\t")

    def __len__(self) -> int:
        return self.num_rows()

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def _decode_image(data: bytes) -> np.ndarray:
    """A row's image bytes -> RGB uint8 [H, W, 3], as PIL's ``.convert("RGB")``."""
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data)
        if img is None:
            raise ValueError("TSV row: truncated or corrupt PNG")
        return img
    return decode_jpeg(data, orient=False, name="TSV row")


def tsv_row_to_record(row: Sequence[str], label_map: Optional[Dict[int, int]] = None) -> Dict:
    """One TSV row -> a detection record with a whole-image box:
    ``{"image" [H,W,3] uint8, "labels", "boxes" (normalized cxcywh),
    "is_extra": True}``; an unmapped class gives an unlabeled image."""
    arr = _decode_image(base64.b64decode(row[-1]))
    cls = int(row[1])
    if label_map is not None:
        cls = label_map.get(cls, -1)
    if cls >= 0:
        labels = np.asarray([cls], np.int64)
        boxes = np.asarray([[0.5, 0.5, 1.0, 1.0]], np.float32)
    else:
        labels = np.zeros((0,), np.int64)
        boxes = np.zeros((0, 4), np.float32)
    return {"image": arr, "labels": labels, "boxes": boxes, "is_extra": True}


def tsv_records(tsv_path: str, label_map: Optional[Dict[int, int]] = None) -> Iterator[Dict]:
    """Every row of a TSV as a detection record (on the host)."""
    tsv = TsvFile(tsv_path)
    try:
        for i in range(len(tsv)):
            yield tsv_row_to_record(tsv.seek(i), label_map)
    finally:
        tsv.close()


# ---------------------------------------------------------------------------
# SSD-style IoU-constrained random crop
# ---------------------------------------------------------------------------
def _iou_one_to_many(crop: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    lt = np.maximum(crop[:2], boxes[:, :2])
    rb = np.minimum(crop[2:], boxes[:, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[:, 0] * wh[:, 1]
    a1 = (crop[2] - crop[0]) * (crop[3] - crop[1])
    a2 = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


def ssd_random_crop(image: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                    rng: np.random.Generator, max_tries: int = 50
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The SSD random crop of ``image`` [H, W, C] with xyxy pixel ``boxes``: a
    minimum IoU drawn from {0.1, 0.3, 0.5, 0.9, keep}, up to ``max_tries``
    crops of [0.3, 1] times each side with aspect in [0.5, 2], accepted when
    the best box IoU reaches the mode and a box centre lies inside; the boxes
    whose centre lies inside survive, clipped and shifted. ``rng`` is drawn
    in the JAX function's order."""
    h, w = image.shape[:2]
    while True:
        mode = rng.choice(np.asarray([0.1, 0.3, 0.5, 0.9, np.nan]))
        if np.isnan(mode):
            return image, boxes, labels
        for _ in range(max_tries):
            new_h = rng.uniform(0.3 * h, h)
            new_w = rng.uniform(0.3 * w, w)
            if not 0.5 <= new_h / new_w <= 2.0:
                continue
            left = rng.uniform(0, w - new_w)
            top = rng.uniform(0, h - new_h)
            crop = np.asarray([int(left), int(top), int(left + new_w), int(top + new_h)],
                              np.float32)
            if len(boxes) == 0:
                continue
            if _iou_one_to_many(crop, boxes.astype(np.float32)).max() < mode:
                continue
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            keep = ((centers[:, 0] > crop[0]) & (centers[:, 0] < crop[2])
                    & (centers[:, 1] > crop[1]) & (centers[:, 1] < crop[3]))
            if not keep.any():
                continue
            x0, y0, x1, y1 = crop.astype(int)
            new_boxes = boxes[keep].astype(np.float32).copy()
            new_boxes[:, :2] = np.maximum(new_boxes[:, :2], crop[:2]) - crop[:2]
            new_boxes[:, 2:] = np.minimum(new_boxes[:, 2:], crop[2:]) - crop[:2]
            return image[y0:y1, x0:x1], new_boxes, labels[keep]


# ---------------------------------------------------------------------------
# local dataset staging
# ---------------------------------------------------------------------------
def _check_and_copy(src: str, dst: str) -> Optional[str]:
    """Copy a file or tree unless ``dst`` exists -> ``dst``, or None."""
    if os.path.exists(dst):
        return None
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    if os.path.isdir(src):
        shutil.copytree(src, dst, copy_function=shutil.copyfile)
    else:
        shutil.copyfile(src, dst)
    return dst


def prepare_local_dataset(pathdict: Dict[str, str], static_paths: Dict[str, str],
                          dist=None) -> Optional[List[str]]:
    """Stage dataset files onto local disk before training. ``pathdict`` maps
    keys to local targets, ``static_paths`` the same keys to sources; a
    ``.zip`` source is copied beside its target and extracted there. ->
    the created paths (for cleanup), or None when nothing was copied.

    ``dist`` is the run's ``parallel.dist.Dist``: rank 0 copies, the other
    ranks copy nothing, and all wait on its barrier before returning. Without
    one (or with one that has no group) this process copies and waits on
    nothing."""
    from richsem_tpu_torch.parallel import dist as pdist

    copied: List[str] = []
    if dist is None or dist.lead:
        for key, tgt in pathdict.items():
            src = static_paths[key]
            if src.endswith(".zip"):
                cp_dir = os.path.dirname(tgt)
                cp_path = os.path.join(cp_dir, os.path.basename(src))
                if _check_and_copy(src, cp_path):
                    copied.append(cp_path)
                with zipfile.ZipFile(cp_path, "r") as zf:
                    zf.extractall(cp_dir or ".")
                copied.append(tgt)
            elif _check_and_copy(src, tgt):
                copied.append(tgt)
    if dist is not None:
        pdist.barrier(dist)
    return copied or None
