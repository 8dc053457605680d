"""Detection AP evaluation (COCO + LVIS protocols), pure numpy (a copy of
``richsem_tpu/data/evaluation/detection_eval.py``).

The reference wraps pycocotools (datasets/coco_eval.py) and the lvis api
(datasets/lvis_eval.py:47-237); neither package exists in this image, so
the full evaluation protocol is implemented here:

* greedy IoU matching per (image, category) at thresholds 0.5:0.05:0.95,
  score-descending, each det matched to the best still-unmatched GT
  (pycocotools ``evaluateImg`` semantics, incl. crowd-as-ignore);
* 101-point interpolated precision, AP averaged over categories present in
  the GT (COCOeval ``accumulate``/``summarize``);
* area ranges all/small/medium/large; maxDets 300 (LVIS protocol applies it
  per image across categories — our PostProcess already emits exactly 300);
* LVIS extras (lvis_eval semantics): a detection of category ``c`` on an
  image where ``c`` has no GT and is not in the image's
  ``neg_category_ids`` is *ignored* (federated annotation); unmatched dets
  of categories in ``not_exhaustive_category_ids`` are ignored; metrics add
  AP_r / AP_c / AP_f by the LVIS category ``frequency`` field.

Metric vector parity: COCO order [AP, AP50, AP75, APs, APm, APl, AR@1,
AR@10, AR@100, ARs, ARm, ARl]; LVIS order [AP, AP50, AP75, APs, APm, APl,
APr, APc, APf] (datasets/lvis_eval.py:58-61).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _box_iou_xyxy(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """IoU [len(a), len(b)]; crowd GTs use intersection/det_area (IoA)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    union = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-12)


class _ImgCatEval:
    __slots__ = ("dt_scores", "dt_matched", "dt_ignored", "dt_area", "n_gt")

    def __init__(self, dt_scores, dt_matched, dt_ignored, dt_area, n_gt):
        self.dt_scores = dt_scores
        self.dt_matched = dt_matched  # [T, D] bool
        self.dt_ignored = dt_ignored  # [T, D] bool
        self.dt_area = dt_area
        self.n_gt = n_gt  # non-ignored gt count (per area range: see accumulate)


class DetectionEvaluator:
    """Accumulates per-image predictions; computes AP at summarize time.

    ``gt``: per image_id → list of dicts {bbox xyxy, category_id, area,
    iscrowd}; LVIS image info (neg/not-exhaustive ids) passed alongside.
    """

    def __init__(
        self,
        mode: str = "coco",  # 'coco' | 'lvis'
        max_dets: int = 300,
        cat_frequencies: Optional[Dict[int, str]] = None,  # LVIS 'r'/'c'/'f'
    ):
        assert mode in ("coco", "lvis")
        self.mode = mode
        self.max_dets = max_dets
        self.cat_frequencies = cat_frequencies or {}
        self._gts: Dict[int, List[dict]] = {}
        self._img_info: Dict[int, dict] = {}
        self._dts: Dict[int, dict] = {}
        self.stats: Optional[Dict[str, float]] = None
        self._pairs_cache: Optional[Dict[int, List[int]]] = None

    # -------------------------------------------------------------- feed
    def add_gt(self, image_id: int, anns: List[dict], img_info: Optional[dict] = None):
        self._gts[image_id] = anns
        self._img_info[image_id] = img_info or {}

    def update(self, predictions: Dict[int, dict]):
        """predictions: image_id → {scores [K], labels [K], boxes [K,4] xyxy}."""
        self._pairs_cache = None
        for img_id, p in predictions.items():
            self._dts[img_id] = {
                "scores": np.asarray(p["scores"], np.float64),
                "labels": np.asarray(p["labels"], np.int64),
                "boxes": np.asarray(p["boxes"], np.float64).reshape(-1, 4),
            }

    # -------------------------------------------------------- evaluation
    def _evaluate_img_cat(self, img_id: int, cat: int, area_rng) -> Optional[_ImgCatEval]:
        gts = [g for g in self._gts.get(img_id, []) if g["category_id"] == cat]
        dt = self._dts.get(img_id)
        if dt is None:
            # image evaluated but no predictions recorded: gts still count
            dt = {
                "scores": np.zeros((0,), np.float64),
                "labels": np.zeros((0,), np.int64),
                "boxes": np.zeros((0, 4), np.float64),
            }
        sel = dt["labels"] == cat
        scores = dt["scores"][sel]
        boxes = dt["boxes"][sel]
        # keep detections with positive score (NMS-suppressed get −1)
        pos = scores > -1e-9
        scores, boxes = scores[pos], boxes[pos]
        order = np.argsort(-scores, kind="mergesort")
        scores, boxes = scores[order], boxes[order]
        # pycocotools evaluateImg truncates to maxDets per image-category
        # BEFORE matching (maxDets=100 COCO / 300 LVIS); AR@k then re-caps
        # the matched lists post-hoc in _accumulate (accumulate semantics)
        scores, boxes = scores[: self.max_dets], boxes[: self.max_dets]

        info = self._img_info.get(img_id, {})
        if self.mode == "lvis":
            neg = set(info.get("neg_category_ids", []))
            not_exh = set(info.get("not_exhaustive_category_ids", []))
            if len(gts) == 0 and cat not in neg:
                # federated: category unverified on this image → ignore dets
                if len(scores) == 0:
                    return None
                t = len(IOU_THRS)
                return _ImgCatEval(
                    scores,
                    np.zeros((t, len(scores)), bool),
                    np.ones((t, len(scores)), bool),
                    (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
                    0,
                )
            ignore_unmatched = cat in not_exh
        else:
            ignore_unmatched = False
        if len(gts) == 0 and len(scores) == 0:
            return None

        g_boxes = np.asarray([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        g_crowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)
        g_area = np.asarray([g.get("area", 0.0) for g in gts], np.float64)
        lo, hi = area_rng
        g_ignore = g_crowd | (g_area < lo) | (g_area > hi)
        # sort gts: non-ignored first (pycocotools order)
        g_order = np.argsort(g_ignore, kind="mergesort")
        g_boxes, g_crowd, g_ignore = g_boxes[g_order], g_crowd[g_order], g_ignore[g_order]

        iou = _box_iou_xyxy(boxes, g_boxes, g_crowd)
        t_n = len(IOU_THRS)
        d_n = len(scores)
        g_n = len(g_boxes)
        dt_m = np.full((t_n, d_n), -1, np.int64)
        gt_m = np.full((t_n, g_n), -1, np.int64)
        for ti, thr in enumerate(IOU_THRS):
            for di in range(d_n):
                best_iou = min(thr, 1 - 1e-10)
                best_g = -1
                for gi in range(g_n):
                    if gt_m[ti, gi] >= 0 and not g_crowd[gi]:
                        continue
                    # stop at ignored gts once a non-ignored match exists
                    if best_g >= 0 and not g_ignore[best_g] and g_ignore[gi]:
                        break
                    if iou[di, gi] < best_iou:
                        continue
                    best_iou = iou[di, gi]
                    best_g = gi
                if best_g >= 0:
                    dt_m[ti, di] = best_g
                    gt_m[ti, best_g] = di
        d_area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        out_of_rng = (d_area < lo) | (d_area > hi)
        matched = dt_m >= 0
        matched_ignored = np.zeros_like(matched)
        has = dt_m >= 0
        safe = np.clip(dt_m, 0, max(g_n - 1, 0))
        if g_n:
            matched_ignored = has & g_ignore[safe]
        dt_ignored = matched_ignored | (~matched & out_of_rng[None, :])
        if ignore_unmatched:
            dt_ignored = dt_ignored | ~matched
        n_gt = int((~g_ignore).sum())
        return _ImgCatEval(scores, matched & ~matched_ignored, dt_ignored, d_area, n_gt)

    def _accumulate(self, cat_ids: Sequence[int], area_name: str,
                    max_dets: Optional[int] = None):
        """→ per-category AP [C, T] and AR [C, T] for one area range,
        optionally capping detections per image-category (COCO AR@k)."""
        area_rng = AREA_RNG[area_name]
        t_n = len(IOU_THRS)
        ap = np.full((len(cat_ids), t_n), np.nan)
        ar = np.full((len(cat_ids), t_n), np.nan)
        pairs = self._relevant_images()
        for ci, cat in enumerate(cat_ids):
            evals = [
                e
                for img_id in pairs.get(cat, ())
                if (e := self._evaluate_img_cat(img_id, cat, area_rng)) is not None
            ]
            if not evals:
                continue
            n_gt = sum(e.n_gt for e in evals)
            if n_gt == 0:
                continue
            if max_dets is not None:
                # keep top-k dets per image-category (already score-sorted)
                def cap(e):
                    return (e.dt_scores[:max_dets], e.dt_matched[:, :max_dets],
                            e.dt_ignored[:, :max_dets])
                capped = [cap(e) for e in evals]
                scores = np.concatenate([c[0] for c in capped])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate([c[1] for c in capped], axis=1)[:, order]
                ignored = np.concatenate([c[2] for c in capped], axis=1)[:, order]
            else:
                scores = np.concatenate([e.dt_scores for e in evals])
                order = np.argsort(-scores, kind="mergesort")
                matched = np.concatenate([e.dt_matched for e in evals], axis=1)[:, order]
                ignored = np.concatenate([e.dt_ignored for e in evals], axis=1)[:, order]
            for ti in range(t_n):
                keep = ~ignored[ti]
                tp = np.cumsum(matched[ti][keep])
                fp = np.cumsum(~matched[ti][keep])
                if len(tp) == 0:
                    ap[ci, ti] = 0.0
                    ar[ci, ti] = 0.0
                    continue
                rec = tp / n_gt
                prec = tp / np.maximum(tp + fp, 1e-12)
                # monotone-decreasing interpolation
                prec = np.maximum.accumulate(prec[::-1])[::-1]
                idx = np.searchsorted(rec, REC_THRS, side="left")
                p101 = np.zeros(len(REC_THRS))
                ok = idx < len(prec)
                p101[ok] = prec[idx[ok]]
                ap[ci, ti] = p101.mean()
                ar[ci, ti] = rec[-1]
        return ap, ar

    def _relevant_images(self) -> Dict[int, List[int]]:
        """cat → image ids that can affect its AP.

        Images with GT of the category always matter. Images with only
        detections matter when those dets can be false positives: always in
        COCO mode; only when the category is in ``neg_category_ids`` under
        the LVIS federated protocol (all-ignored pairs contribute nothing).
        """
        if getattr(self, "_pairs_cache", None) is not None:
            return self._pairs_cache
        pairs: Dict[int, set] = defaultdict(set)
        for img_id, anns in self._gts.items():
            for g in anns:
                pairs[g["category_id"]].add(img_id)
        for img_id, dt in self._dts.items():
            cats = set(np.unique(dt["labels"]).tolist())
            if self.mode == "coco":
                for c in cats:
                    pairs[c].add(img_id)
            else:
                neg = set(self._img_info.get(img_id, {}).get("neg_category_ids", []))
                for c in cats & neg:
                    pairs[c].add(img_id)
        self._pairs_cache = {c: sorted(v) for c, v in pairs.items()}
        return self._pairs_cache

    # -------------------------------------------------------- summarize
    def summarize(self) -> Dict[str, float]:
        cat_ids = sorted(
            {g["category_id"] for anns in self._gts.values() for g in anns}
        )
        ap_all, ar_all = self._accumulate(cat_ids, "all")
        stats: Dict[str, float] = {}

        def mean(x):
            x = x[~np.isnan(x)]
            return float(x.mean()) if len(x) else float("nan")

        stats["AP"] = mean(ap_all)
        stats["AP50"] = mean(ap_all[:, 0])
        stats["AP75"] = mean(ap_all[:, 5])
        for area in ("small", "medium", "large"):
            ap_a, _ = self._accumulate(cat_ids, area)
            stats[f"AP{area[0]}"] = mean(ap_a)
        if self.mode == "lvis":
            freq = self.cat_frequencies
            for band, key in (("r", "APr"), ("c", "APc"), ("f", "APf")):
                rows = [i for i, c in enumerate(cat_ids) if freq.get(c) == band]
                stats[key] = mean(ap_all[rows]) if rows else float("nan")
        else:
            # COCO AR@k (recall at capped detections per image-category)
            for k in (1, 10, 100):
                _, ar_k = self._accumulate(cat_ids, "all", max_dets=k)
                stats[f"AR@{k}"] = mean(ar_k)
        self.stats = stats
        return stats

    def metric_vector(self) -> List[float]:
        """Reference-ordered stats list (lvis_eval.py:58-61 / coco order)."""
        s = self.stats or self.summarize()
        if self.mode == "lvis":
            keys = ["AP", "AP50", "AP75", "APs", "APm", "APl", "APr", "APc", "APf"]
        else:
            keys = ["AP", "AP50", "AP75", "APs", "APm", "APl",
                    "AR@1", "AR@10", "AR@100"]
        return [s[k] for k in keys]


class CocoEvaluator(DetectionEvaluator):
    """COCO protocol with gt fed from a CocoIndex (coco_eval.py parity)."""

    def __init__(self, index, max_dets: int = 100):
        super().__init__(mode="coco", max_dets=max_dets)
        self._feed_index(index)

    def _feed_index(self, index):
        for img_id in index.get_img_ids():
            anns = []
            for a in index.load_anns_for_img(img_id):
                x, y, w, h = a["bbox"]
                anns.append(
                    {
                        "bbox": [x, y, x + w, y + h],
                        "category_id": a["category_id"],
                        "area": a.get("area", w * h),
                        "iscrowd": a.get("iscrowd", 0),
                    }
                )
            self.add_gt(img_id, anns, index.load_img(img_id))


class LvisEvaluator(DetectionEvaluator):
    """LVIS protocol (lvis_eval.py parity): federated ignores + AP_r/c/f."""

    def __init__(self, index, max_dets: int = 300):
        freq = {
            cid: c.get("frequency", "f")[0] for cid, c in index.cats.items()
        }
        super().__init__(mode="lvis", max_dets=max_dets, cat_frequencies=freq)
        for img_id in index.get_img_ids():
            anns = []
            for a in index.load_anns_for_img(img_id):
                x, y, w, h = a["bbox"]
                anns.append(
                    {
                        "bbox": [x, y, x + w, y + h],
                        "category_id": a["category_id"],
                        "area": a.get("area", w * h),
                        "iscrowd": 0,
                    }
                )
            self.add_gt(img_id, anns, index.load_img(img_id))
