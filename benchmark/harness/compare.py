"""The numbers that decide ``correct``, each held to its limit.

Eval (the served detections of the sampled images): ``sorted_score_gap``,
the worst image's median gap between the program's top-K scores and the
reference's, both sorted. A sorted list of scores moves continuously where
near-equal entries swap places, as the random weights make them do at the
two top-K selections, so bfloat16's rounding reads an order of magnitude
below float8's. ``entry_gap``: every served detection (score, label, box) is
explained by the reference's query that fits it best among the decoder's
outputs over the candidate proposals (a superset of the 900 that rounding
selects): the larger of the score's gap at that label and the widest box
coordinate's gap (normalised cx, cy, w, h), both in logits. The worst
detection of the worst image is the number, so one wrong label, box or
score shows.

Train (the first steps through the window's own call): ``loss_gap``, the
widest relative gap of a step's loss; ``grad_gap_median``, the median leaf's
gap between the norms of the program's first gradient (as the optimizer got
it, worked out from its first moment) and the reference's;
``enc_grad_gap``, the same gap's 90th percentile over the encoder layers'
leaves, whose gradients the sampler's and the encoder tail's backward
kernels give; ``update_gap``, the worst leaf's gap between the norms of the
parameters' change over the steps. (The worst leaf's first-gradient gap,
``grad_gap``, is printed and not limited: ``PERF.md``.)
A leaf's gap is measured against the larger of its reference norm and the
median leaf's; leaves whose reference gradient is under ``QUIET`` of the
median leaf's are left out of ``update_gap`` (they move by round-off alone).
"""

from __future__ import annotations

from typing import Dict, List

import torch

WORST = 1e30  # the reading of a number that is missing or not finite
QUIET = 1e-3  # of the median leaf's gradient norm


ENCODER = "encoder_layer"  # the encoder layers' leaves start so


def logit(x: torch.Tensor) -> torch.Tensor:
    """The inverse of the sigmoid, its argument clamped into (1e-6, 1 - 1e-6)."""
    x = x.clamp(1e-6, 1 - 1e-6)
    return torch.log(x) - torch.log1p(-x)


def xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    return torch.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2,
                        b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


def entry_gaps(p: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor], hw) -> torch.Tensor:
    """Each served detection's gap to the reference's query that fits it best:
    min over the candidate queries of max(the score's gap at the detection's
    label, the widest gap of a box coordinate), both in logits, where the
    sigmoids of the score head and of the box head leave rounding's noise
    alike at every size (``cand_boxes``: normalised cx, cy, w, h; the served
    boxes, in pixels of the original image ``hw``, are scaled back)."""
    labels = p["labels"].long()
    cand = logit(r["cand_scores"].double())[:, labels].t()  # [K, Qc]
    score = (logit(p["scores"].double())[:, None] - cand).abs()
    h, w = hw.double().unbind(-1)
    mine = logit(xyxy_to_cxcywh(p["boxes"].double() / torch.stack([w, h, w, h])))
    box = (mine[:, None] - logit(r["cand_boxes"].double())[None]).abs().amax(-1)
    gap = torch.maximum(score, box).amin(1)
    if not (torch.isfinite(p["scores"]).all() and torch.isfinite(p["boxes"]).all()):
        return torch.full_like(gap, WORST)
    return gap


def eval_numbers(prog: List[Dict[str, torch.Tensor]], ref: List[Dict[str, torch.Tensor]],
                 orig_sizes: List[torch.Tensor]) -> Dict[str, float]:
    """``prog``: per image, ``scores [K]`` (sorted, as served), ``labels [K]``,
    ``boxes [K, 4]``; ``ref``: per image, ``scores [K]`` and the candidate
    queries' ``cand_scores [Qc, C]`` and ``cand_boxes [Qc, 4]``;
    ``orig_sizes`` (h, w). ``ref`` without candidates gives no ``entry_gap``."""
    out = {"sorted_score_gap": 0.0}
    for p, r, hw in zip(prog, ref, orig_sizes):
        k = p["scores"].shape[0]
        ps = torch.sort(p["scores"].double(), descending=True).values
        rs = torch.sort(r["scores"].double(), descending=True).values[:k]
        gap = float(torch.quantile((ps - rs).abs().nan_to_num(1.0), 0.5))
        out["sorted_score_gap"] = max(out["sorted_score_gap"], gap)
        if "cand_scores" in r:
            out["entry_gap"] = max(out.get("entry_gap", 0.0),
                                   float(entry_gaps(p, r, hw).nan_to_num(WORST).max()))
    return out


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep=None) -> torch.Tensor:
    """Each leaf's |norm(prog) - norm(ref)| over max(norm(ref), the median leaf's)."""
    names = [n for n in ref if keep is None or keep(n)]
    rn = torch.tensor([float(ref[n].double().norm()) for n in names], dtype=torch.float64)
    pn = torch.tensor([float(prog[n].double().norm()) for n in names], dtype=torch.float64)
    return (pn - rn).abs() / torch.clamp(rn, min=max(float(rn.median()), 1e-30))


def train_numbers(prog_losses: List[float], ref_losses: List[float],
                  prog_grad: Dict[str, torch.Tensor], ref_grad: Dict[str, torch.Tensor],
                  prog_delta: Dict[str, torch.Tensor], ref_delta: Dict[str, torch.Tensor]
                  ) -> Dict[str, float]:
    """The three numbers of a training cell (see the module docstring)."""
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog_losses, ref_losses))
    if any(p != p for p in prog_losses):  # a NaN loss
        loss_gap = float("inf")
    gnorm = {n: float(g.double().norm()) for n, g in ref_grad.items()}
    med = float(torch.tensor(list(gnorm.values()), dtype=torch.float64).median())
    moving = {n for n, v in gnorm.items() if v >= QUIET * med}
    grad = _leaf_gaps(prog_grad, ref_grad)
    enc = grad[[i for i, n in enumerate(ref_grad) if n.startswith(ENCODER)]]
    return {"loss_gap": loss_gap,
            "grad_gap_median": float(grad.median()),
            "enc_grad_gap": float(torch.quantile(enc, 0.9)) if enc.numel() else WORST,
            "grad_gap": float(grad.max()),
            "update_gap": float(_leaf_gaps(prog_delta, ref_delta,
                                           keep=lambda n: n in moving).max())}


def worst_leaves(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], n: int = 5):
    """The ``n`` leaves of the widest gap (``_leaf_gaps``) -> [(name, gap)]."""
    gaps = _leaf_gaps(prog, ref)
    top = torch.topk(gaps, min(n, gaps.numel()))
    names = list(ref)
    return [(names[i], float(v)) for v, i in zip(top.values, top.indices)]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """-> {name: {value, limit}} for every limited number; a number that is
    missing or not finite reads ``WORST``."""
    out = {}
    for name, limit in limits.items():
        v = float(numbers.get(name, WORST))
        out[name] = {"value": v if v == v and abs(v) < WORST else WORST, "limit": limit}
    return out


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
