"""The port's evaluators (``richsem_tpu_torch/data/evaluation``) held against the
JAX package's on identical ground truth and random detections: ``summarize()``
to 1e-12, LVIS with federated ignores (negative and unverified categories) and
not-exhaustive categories, and COCO with crowd boxes and AR@k."""

import math

import numpy as np
import pytest

from richsem_tpu.data.coco_api import CocoIndex as JaxIndex
from richsem_tpu.data.evaluation import CocoEvaluator as JaxCoco
from richsem_tpu.data.evaluation import LvisEvaluator as JaxLvis
from richsem_tpu_torch.data.coco_api import CocoIndex, category_image_counts
from richsem_tpu_torch.data.evaluation import CocoEvaluator, LvisEvaluator


def _dataset(seed, n_img=12, n_cat=9, lvis=True):
    rng = np.random.default_rng(seed)
    cats = [{"id": c, "name": f"c{c}", "frequency": "rcf"[c % 3], "image_count": int(c * 7)}
            for c in range(1, n_cat + 1)]
    images, anns, aid = [], [], 1
    for i in range(1, n_img + 1):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        labels = set()
        for _ in range(int(rng.integers(0, 7))):
            bw, bh = rng.uniform(5, w / 2), rng.uniform(5, h / 2)
            x, y = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            c = int(rng.integers(1, n_cat + 1))
            labels.add(c)
            anns.append({"id": aid, "image_id": i, "category_id": c, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": int(not lvis and rng.random() < 0.1)})
            aid += 1
        img = {"id": i, "height": h, "width": w, "file_name": f"{i}.png"}
        if lvis:
            img["neg_category_ids"] = [int(c) for c in rng.integers(1, n_cat + 1, 3)
                                       if c not in labels]
            img["not_exhaustive_category_ids"] = sorted(labels)[:1]
        images.append(img)
    return {"images": images, "annotations": anns, "categories": cats}


def _predictions(ds, seed, k=30):
    """Random detections, some near the ground truth."""
    rng = np.random.default_rng(seed + 1)
    n_cat = len(ds["categories"])
    by_img = {}
    for a in ds["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a)
    preds = {}
    for img in ds["images"]:
        boxes, labels = [], []
        for a in by_img.get(img["id"], []):
            x, y, w, h = a["bbox"]
            j = rng.normal(0, 0.1, 4) * [w, h, w, h]
            boxes.append([x + j[0], y + j[1], x + w + j[2], y + h + j[3]])
            labels.append(a["category_id"] if rng.random() < 0.8 else int(rng.integers(1, n_cat + 1)))
        while len(boxes) < k:
            x0, y0 = rng.uniform(0, img["width"] * 0.8), rng.uniform(0, img["height"] * 0.8)
            boxes.append([x0, y0, x0 + rng.uniform(4, 100), y0 + rng.uniform(4, 100)])
            labels.append(int(rng.integers(1, n_cat + 1)))
        preds[img["id"]] = {"scores": rng.random(len(boxes)), "labels": np.asarray(labels),
                            "boxes": np.asarray(boxes)}
    return preds


def _same_stats(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert abs(a[k] - b[k]) <= 1e-12, (k, a[k], b[k])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lvis_summarize_equal(seed):
    ds = _dataset(seed)
    ev_j, ev_p = JaxLvis(JaxIndex(dataset=ds), max_dets=25), LvisEvaluator(CocoIndex(dataset=ds), max_dets=25)
    preds = _predictions(ds, seed)
    ev_j.update(preds)
    ev_p.update(preds)
    sj, sp = ev_j.summarize(), ev_p.summarize()
    _same_stats(sj, sp)
    assert {"APr", "APc", "APf"} <= set(sp) and 0.0 <= sp["AP"] <= 1.0
    assert ev_j.metric_vector() == pytest.approx(ev_p.metric_vector(), nan_ok=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_coco_summarize_equal(seed):
    ds = _dataset(seed, lvis=False)
    ev_j, ev_p = JaxCoco(JaxIndex(dataset=ds)), CocoEvaluator(CocoIndex(dataset=ds))
    preds = _predictions(ds, seed, k=120)
    ev_j.update(preds)
    ev_p.update(preds)
    sj, sp = ev_j.summarize(), ev_p.summarize()
    _same_stats(sj, sp)
    assert {"AR@1", "AR@10", "AR@100"} <= set(sp)


def test_perfect_detections_score_one():
    ds = _dataset(4)
    ev = LvisEvaluator(CocoIndex(dataset=ds))
    preds = {}
    for img in ds["images"]:
        anns = [a for a in ds["annotations"] if a["image_id"] == img["id"]]
        preds[img["id"]] = {
            "scores": np.linspace(1, 0.5, len(anns)), "labels": [a["category_id"] for a in anns],
            "boxes": [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                       a["bbox"][1] + a["bbox"][3]] for a in anns]}
    ev.update(preds)
    assert ev.summarize()["AP"] == pytest.approx(1.0)


def test_category_image_counts():
    ds = _dataset(5)
    counts = category_image_counts(CocoIndex(dataset=ds), 10, {c: c for c in range(1, 10)})
    assert counts.dtype == np.float32 and counts[0] == 0 and counts[4] == 28
