"""The port's panoptic evaluator (``richsem_tpu_torch/data/evaluation/panoptic_eval.py``)
held against the JAX package's: the PQ and merge cases of
``tests/test_panoptic_keypoints_rle.py`` on the port, and seeded segment maps
(matches, partial overlaps, crowd and VOID regions, things and stuff) whose
PQ, SQ, RQ (and PQ_th, PQ_st) must equal JAX's exactly, as must the merged
maps and segments of ``panoptic_map_from_instances``.
"""

import numpy as np
import pytest

from richsem_tpu.data.evaluation import PanopticEvaluator as JaxPanopticEvaluator
from richsem_tpu.data.evaluation import panoptic_map_from_instances as jax_merge
from richsem_tpu_torch.data.evaluation import PanopticEvaluator, panoptic_map_from_instances


def _square_map(h, w, boxes_ids):
    m = np.zeros((h, w), np.int32)
    for (y0, y1, x0, x1), sid in boxes_ids:
        m[y0:y1, x0:x1] = sid
    return m


def test_pq_perfect_match_is_one():
    gt = _square_map(32, 32, [((0, 16, 0, 16), 1), ((16, 32, 16, 32), 2)])
    ev = PanopticEvaluator()
    segs = [{"id": 1, "category_id": 5}, {"id": 2, "category_id": 7}]
    ev.update(gt, segs, gt.copy(), segs)
    s = ev.summarize()
    assert abs(s["PQ"] - 1.0) < 1e-9 and s["n_categories"] == 2


def test_pq_counts_fp_fn_and_partial_iou():
    gt = _square_map(32, 32, [((0, 16, 0, 16), 1)])
    pred = _square_map(32, 32, [((8, 24, 0, 16), 1)])  # IoU 1/3: FN + FP
    ev = PanopticEvaluator()
    ev.update(gt, [{"id": 1, "category_id": 5}], pred, [{"id": 1, "category_id": 5}])
    assert ev.summarize()["PQ"] == 0.0
    # inter 240, union 600 - 240 - 60 (the prediction's VOID part) = 300: IoU 0.8
    gt = _square_map(40, 10, [((0, 30, 0, 10), 1)])
    pred = _square_map(40, 10, [((6, 36, 0, 10), 1)])
    ev = PanopticEvaluator()
    ev.update(gt, [{"id": 1, "category_id": 3}], pred, [{"id": 1, "category_id": 3}])
    assert abs(ev.summarize()["PQ"] - 0.8) < 1e-9


def test_pq_crowd_gt_forgiven():
    gt = _square_map(32, 32, [((0, 32, 0, 16), 1)])
    ev = PanopticEvaluator()
    ev.update(gt, [{"id": 1, "category_id": 5, "iscrowd": 1}],
              gt.copy(), [{"id": 1, "category_id": 5}])
    assert ev.summarize()["n_categories"] == 0  # no TP, FP or FN recorded


def test_panoptic_merge_paints_by_score():
    masks = np.zeros((2, 16, 16), bool)
    masks[0] = True  # low-score full-image mask
    masks[1, 4:12, 4:12] = True  # high-score small mask
    seg, segments = panoptic_map_from_instances(masks, labels=np.array([2, 9]),
                                                scores=np.array([0.6, 0.9]))
    assert segments[0]["category_id"] == 9  # painted first
    assert seg[8, 8] == segments[0]["id"]
    assert seg[0, 0] == segments[1]["id"]


def _random_pair(rng, h=48, w=64, n=7):
    """A GT map of rectangles (some crowd, some VOID left) and a prediction of
    jittered copies, some relabelled, some dropped, one spurious."""
    gt, pred = np.zeros((h, w), np.int32), np.zeros((h, w), np.int32)
    gt_segs, pred_segs = [], []
    for sid in range(1, n + 1):
        y0, x0 = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 8))
        y1, x1 = y0 + int(rng.integers(4, 20)), x0 + int(rng.integers(4, 24))
        cat = int(rng.integers(1, 5))
        gt[y0:y1, x0:x1] = sid
        gt_segs.append({"id": sid, "category_id": cat, "iscrowd": int(rng.uniform() < 0.15)})
        if rng.uniform() < 0.85:
            dy, dx = rng.integers(-3, 4, 2)
            pred[max(y0 + dy, 0):y1 + dy, max(x0 + dx, 0):x1 + dx] = sid
            pred_segs.append({"id": sid, "category_id": cat if rng.uniform() < 0.8 else 9 - cat})
    y0, x0 = int(rng.integers(0, h - 6)), int(rng.integers(0, w - 6))
    pred[y0:y0 + 5, x0:x0 + 5] = n + 1
    pred_segs.append({"id": n + 1, "category_id": int(rng.integers(1, 5))})
    gt_segs = [s for s in gt_segs if (gt == s["id"]).any()]
    pred_segs = [s for s in pred_segs if (pred == s["id"]).any()]
    return gt, gt_segs, pred, pred_segs


@pytest.mark.parametrize("categories", [None, {1: {"isthing": 1}, 2: {"isthing": 0},
                                               3: {"isthing": 1}, 4: {"isthing": 0},
                                               5: {"isthing": 1}}], ids=["plain", "things_stuff"])
def test_pq_equals_jax_exactly(categories):
    rng = np.random.default_rng(0 if categories is None else 1)
    ev, ref = PanopticEvaluator(categories), JaxPanopticEvaluator(categories)
    for _ in range(12):
        pair = _random_pair(rng)
        ev.update(*pair)
        ref.update(*pair)
    out, want = ev.summarize(), ref.summarize()
    assert set(out) == set(want) and out["n_categories"] > 0
    assert out == want


def test_merge_equals_jax_exactly():
    rng = np.random.default_rng(3)
    for dtype in (bool, np.float32):
        n = 9  # noisy logits, positive mostly inside a rectangle an instance
        masks = rng.normal(size=(n, 24, 32)).astype(np.float32) - 2.0
        for m in masks:
            y0, x0 = rng.integers(0, 16), rng.integers(0, 24)
            m[y0:y0 + int(rng.integers(4, 12)), x0:x0 + int(rng.integers(4, 12))] += 4.0
        if dtype is bool:
            masks = masks > 0.3
        labels, scores = rng.integers(0, 20, n), rng.uniform(0.2, 1.0, n)
        seg, segments = panoptic_map_from_instances(masks, labels, scores, 0.4, 0.6)
        ref_seg, ref_segments = jax_merge(masks, labels, scores, 0.4, 0.6)
        np.testing.assert_array_equal(seg, ref_seg)
        assert segments == ref_segments and len(segments) > 1
