"""Panoptic Quality (PQ) evaluation, pure numpy (the port's copy of
``richsem_tpu/data/evaluation/panoptic_eval.py``, which it does not import).

The reference wraps panopticapi's ``pq_compute`` over dumped PNGs
(datasets/panoptic_eval.py:13-44); panopticapi does not exist in this
image, so the PQ protocol is implemented from its published definition:

* segments match when same-category IoU > 0.5 (the intersection is taken
  on the combined id map, so matches are unique by construction);
* VOID pixels (id 0) are excluded from unions; predicted segments whose
  area is > 50% VOID-or-crowd overlap do not count as false positives;
* crowd GT segments never match and never count as false negatives, and
  predicted segments of the same category overlapping them are forgiven;
* per category: PQ = Σ IoU / (TP + FP/2 + FN/2) = SQ · RQ, averaged over
  categories that appear in the ground truth.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

VOID = 0
_OFFSET = 256 * 256 * 256


class PanopticEvaluator:
    """Accumulates (gt, prediction) segment-map pairs; computes PQ/SQ/RQ.

    Maps are int arrays [H, W] of segment ids (0 = void); segment lists are
    dicts ``{"id", "category_id", "iscrowd"?}`` — the panopticapi
    annotation layout, minus the PNG encoding.
    """

    def __init__(self, categories: Optional[Dict[int, dict]] = None):
        self.categories = categories or {}
        self._stats = defaultdict(lambda: {"iou": 0.0, "tp": 0, "fp": 0, "fn": 0})

    def update(
        self,
        gt_map: np.ndarray,
        gt_segments: Sequence[dict],
        pred_map: np.ndarray,
        pred_segments: Sequence[dict],
    ) -> None:
        gt_map = np.asarray(gt_map, np.int64)
        pred_map = np.asarray(pred_map, np.int64)
        gt_info = {s["id"]: s for s in gt_segments}
        pred_info = {s["id"]: s for s in pred_segments}
        gt_area = dict(zip(*np.unique(gt_map, return_counts=True)))
        pred_area = dict(zip(*np.unique(pred_map, return_counts=True)))

        combined = gt_map * _OFFSET + pred_map
        inter: Dict[tuple, int] = {}
        ids, counts = np.unique(combined, return_counts=True)
        for key, c in zip(ids.tolist(), counts.tolist()):
            inter[(key // _OFFSET, key % _OFFSET)] = c

        matched_gt, matched_pred = set(), set()
        for (gid, pid), c in inter.items():
            if gid == VOID or pid == VOID:
                continue
            g, p = gt_info.get(gid), pred_info.get(pid)
            if g is None or p is None or g.get("iscrowd", 0):
                continue
            if g["category_id"] != p["category_id"]:
                continue
            # panopticapi subtracts the pred segment's VOID overlap
            union = (
                gt_area[gid] + pred_area[pid] - c - inter.get((VOID, pid), 0)
            )
            iou = c / union if union > 0 else 0.0
            if iou > 0.5:
                cat = g["category_id"]
                self._stats[cat]["iou"] += iou
                self._stats[cat]["tp"] += 1
                matched_gt.add(gid)
                matched_pred.add(pid)

        crowd_by_cat = {
            g["category_id"]: gid
            for gid, g in gt_info.items()
            if g.get("iscrowd", 0)
        }
        for gid, g in gt_info.items():
            if gid == VOID or g.get("iscrowd", 0) or gid in matched_gt:
                continue
            self._stats[g["category_id"]]["fn"] += 1
        for pid, p in pred_info.items():
            if pid == VOID or pid in matched_pred:
                continue
            # forgive predictions mostly covered by VOID + same-class crowd
            void_cover = inter.get((VOID, pid), 0)
            crowd_gid = crowd_by_cat.get(p["category_id"])
            if crowd_gid is not None:
                void_cover += inter.get((crowd_gid, pid), 0)
            if pred_area.get(pid, 0) and void_cover / pred_area[pid] > 0.5:
                continue
            self._stats[p["category_id"]]["fp"] += 1

    def summarize(self) -> Dict[str, float]:
        per_cat: Dict[int, Dict[str, float]] = {}
        for cat, s in self._stats.items():
            tp, fp, fn = s["tp"], s["fp"], s["fn"]
            denom = tp + 0.5 * fp + 0.5 * fn
            if denom == 0:
                continue
            pq = s["iou"] / denom
            sq = s["iou"] / tp if tp else 0.0
            rq = tp / denom
            per_cat[cat] = {"pq": pq, "sq": sq, "rq": rq}
        n = len(per_cat)
        out = {
            "PQ": sum(v["pq"] for v in per_cat.values()) / n if n else float("nan"),
            "SQ": sum(v["sq"] for v in per_cat.values()) / n if n else float("nan"),
            "RQ": sum(v["rq"] for v in per_cat.values()) / n if n else float("nan"),
            "n_categories": n,
        }
        if self.categories:
            for kind, key in (("things", "PQ_th"), ("stuff", "PQ_st")):
                rows = [
                    v["pq"]
                    for c, v in per_cat.items()
                    if bool(self.categories.get(c, {}).get("isthing", 1))
                    == (kind == "things")
                ]
                out[key] = sum(rows) / len(rows) if rows else float("nan")
        return out


def panoptic_map_from_instances(
    masks: np.ndarray,  # [N, H, W] bool or float logits
    labels: np.ndarray,  # [N]
    scores: np.ndarray,  # [N]
    score_threshold: float = 0.5,
    overlap_threshold: float = 0.5,
) -> tuple:
    """Merge instance masks into a panoptic segment map — the reference's
    PostProcessPanoptic merge step (models/richsem/segmentation.py), minus
    the PNG encoding: paint masks in descending score order, dropping
    instances whose remaining visible area is under ``overlap_threshold``
    of their full mask.

    → (segment_map [H, W] int32, segments list of {"id", "category_id"}).
    """
    n, h, w = masks.shape
    seg = np.zeros((h, w), np.int32)
    segments: List[dict] = []
    order = np.argsort(-np.asarray(scores))
    next_id = 1
    for i in order:
        if scores[i] < score_threshold:
            continue
        # float masks are LOGITS: p=0.5 is logit 0 (thresholding logits at
        # 0.5 would demand p≈0.62 and shrink every segment)
        m = masks[i] > 0.0 if masks.dtype != bool else masks[i]
        area = int(m.sum())
        if area == 0:
            continue
        visible = m & (seg == 0)
        if visible.sum() / area < overlap_threshold:
            continue
        seg[visible] = next_id
        segments.append({"id": next_id, "category_id": int(labels[i])})
        next_id += 1
    return seg, segments
