"""A synthetic LVIS-v1 directory that the trainer reads, drawn from a seed:
the data of ``chip_smoke.py``'s trainer phase and of the data and trainer
tests. It needs no OpenCV: the images are PNGs written with zlib."""

from __future__ import annotations

import json
import os

import numpy as np

from richsem_tpu_torch.data.image_io import encode_png


def write_lvis(root, n_train=16, n_val=4, hw=((480, 640), (640, 960)), n_cats=1203,
               max_boxes=16, seed=0, filters=(0, 1, 2)):
    """A synthetic LVIS-v1-format dataset under ``root``, as the trainer reads
    it: ``lvis_v1/lvis_v1_{train,val}.json`` (``n_cats`` categories, ids
    1..n_cats, frequencies r/c/f with matching ``image_count``; per image
    ``neg_category_ids`` and ``not_exhaustive_category_ids``) and PNG images
    under ``coco/{train,val}2017`` (sides drawn from ``hw`` = ((h_lo, w_lo),
    (h_hi, w_hi)), each landscape or portrait; 1..``max_boxes`` boxes), written
    with zlib (PNG filter types cycled from ``filters``); drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    freq = ["r", "c", "f"]
    counts = {"r": (1, 10), "c": (11, 100), "f": (101, 5000)}
    cats = []
    for i in range(1, n_cats + 1):
        f = freq[i % 3]
        cats.append({"id": i, "name": f"category_{i}", "synset": f"category_{i}.n.01",
                     "frequency": f, "image_count": int(rng.integers(*counts[f]))})
    common = rng.choice(np.arange(1, n_cats + 1), size=min(n_cats, 24), replace=False)
    ann_id = 1
    for split, n in (("train", n_train), ("val", n_val)):
        os.makedirs(os.path.join(root, "coco", f"{split}2017"), exist_ok=True)
        images, anns = [], []
        for j in range(n):
            img_id = (1 if split == "train" else 100000) + j
            h, w = (int(rng.integers(lo, hi + 1)) for lo, hi in zip(*hw))
            if rng.random() < 0.5:
                h, w = w, h
            yy, xx = np.mgrid[0:h, 0:w]
            base = (128 + 90 * np.sin(xx / rng.uniform(5, 40) + rng.uniform(0, 6))
                    * np.cos(yy / rng.uniform(5, 40)))
            img = np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
            name = f"{img_id:012d}.png"
            with open(os.path.join(root, "coco", f"{split}2017", name), "wb") as f:
                f.write(encode_png(img, filters[j % len(filters)]))
            labels = []
            for _ in range(int(rng.integers(1, max_boxes + 1))):
                bw, bh = rng.uniform(0.05, 0.5) * w, rng.uniform(0.05, 0.5) * h
                x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
                cat = int(rng.choice(common) if rng.random() < 0.7
                          else rng.integers(1, n_cats + 1))
                labels.append(cat)
                anns.append({"id": ann_id, "image_id": img_id, "category_id": cat,
                             "bbox": [round(float(v), 2) for v in (x0, y0, bw, bh)],
                             "area": float(bw * bh), "iscrowd": 0})
                ann_id += 1
            others = [int(c) for c in rng.integers(1, n_cats + 1, 6) if c not in labels]
            images.append({"id": img_id, "height": h, "width": w,
                           "coco_url": f"http://images.cocodataset.org/{split}2017/{name}",
                           "neg_category_ids": others[:3],
                           "not_exhaustive_category_ids": sorted(set(labels))[:1]})
        os.makedirs(os.path.join(root, "lvis_v1"), exist_ok=True)
        with open(os.path.join(root, "lvis_v1", f"lvis_v1_{split}.json"), "w") as f:
            json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return root
