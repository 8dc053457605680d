"""Minimal COCO/LVIS annotation index (a copy of ``richsem_tpu/data/coco_api.py``;
pure python, no pycocotools/lvis).

The reference depends on the ``pycocotools``/``lvis`` packages for json
indexing (datasets/coco.py, datasets/lvis.py:11-129). This module provides
the subset of that API surface the framework needs — image/annotation/
category lookup tables — for both COCO-format and LVIS-format jsons
(LVIS adds ``neg_category_ids`` / ``not_exhaustive_category_ids`` per image
and stores file names inside ``coco_url``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional


class CocoIndex:
    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[dict] = None):
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {im["id"]: im for im in dataset.get("images", [])}
        self.cats: Dict[int, dict] = {c["id"]: c for c in dataset.get("categories", [])}
        self.anns: Dict[int, dict] = {a["id"]: a for a in dataset.get("annotations", [])}
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        for a in dataset.get("annotations", []):
            self.img_to_anns[a["image_id"]].append(a)

    # ---- pycocotools-compatible surface (the slice the framework uses) ----
    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs.keys())

    def get_cat_ids(self) -> List[int]:
        return sorted(self.cats.keys())

    def load_img(self, img_id: int) -> dict:
        return self.imgs[img_id]

    def load_anns_for_img(self, img_id: int) -> List[dict]:
        return self.img_to_anns.get(img_id, [])

    @staticmethod
    def file_name_of(img: dict) -> str:
        """LVIS stores the path in coco_url (datasets/lvis.py:55-60)."""
        if "file_name" in img:
            return img["file_name"]
        url = img["coco_url"]
        # e.g. http://images.cocodataset.org/val2017/xxx.jpg → val2017/xxx.jpg
        return "/".join(url.split("/")[-2:])

    def validate(self) -> None:
        """Reference sanity asserts: unique ann ids (lvis.py:66-69)."""
        ids = [a["id"] for a in self.dataset.get("annotations", [])]
        if len(ids) != len(set(ids)):
            raise ValueError("annotation ids are not unique")


def category_image_counts(index: CocoIndex, num_classes: int, cat_to_contig: Dict[int, int]):
    """Per-contiguous-class image_count table for fed loss / RFS.

    LVIS jsons carry ``image_count`` per category; COCO-style fall back to
    counting images containing the class.
    """
    import numpy as np

    counts = np.zeros((num_classes,), np.float32)
    for cid, cat in index.cats.items():
        if cid not in cat_to_contig:
            continue
        c = cat_to_contig[cid]
        if "image_count" in cat:
            counts[c] = cat["image_count"]
    if counts.sum() == 0:
        per_img = defaultdict(set)
        for a in index.dataset.get("annotations", []):
            per_img[a["category_id"]].add(a["image_id"])
        for cid, imgs in per_img.items():
            if cid in cat_to_contig:
                counts[cat_to_contig[cid]] = len(imgs)
    return counts
