"""Greedy NMS in the port (``ops/nms.py``, K7 on the card), held against the
JAX package's ``nms_mask`` and ``postprocess``.

* The plain version (what the wrapper runs on CPU tensors) against JAX's
  ``vmap(nms_mask)``: keep masks exactly equal, on random boxes, on tied
  scores (a stable order: the lower index first) and on pairs whose IoU is
  exactly the threshold (kept: the rule is ``iou > threshold``).
* K7's work split emulated in numpy (``csrc/nms.cu``): the rank of each score
  (``#{s_j > s_i} + #{j < i, s_j == s_i}``) by 32-score ballot steps, the
  IoU of the sorted boxes with every operation rounded to float32 on its own
  (numpy's float32 arithmetic contracts nothing), the 32-bit words of each
  row's later boxes above the threshold for the words of the upper triangle
  only, the sweep over 32-box blocks (in-block resolution, then the kept
  rows' words removed from the later words) and the scatter back: bit for
  bit the plain version, at N = 1, 31, 32, 33, 64, 300, 1,000 and 1,024 (its
  limit), on a suppression chain across a word boundary and on boxes that
  all overlap; JAX's ``nms_mask`` on the tied and chain cases.
* ``postprocess`` with NMS against JAX's: scores (the dropped ones -1),
  labels and boxes; and variant A's eval step (``tests/test_torch_variants.py``)
  against JAX's ``make_eval_step``.
* The wrapper's refusals on a meta tensor that reports a CUDA device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.postprocess import postprocess as jax_postprocess
from richsem_tpu.ops.nms import nms_mask as jax_nms_mask
from richsem_tpu.train.engine import make_eval_step as jax_make_eval_step
from richsem_tpu_torch.models.postprocess import postprocess
from richsem_tpu_torch.ops import nms
from richsem_tpu_torch.train.engine import make_eval_step
from tests.test_torch_flagship_train import _with_teacher_keys
from tests.test_torch_train_step import _batches
from tests.test_torch_variants import OUT_TOL, VARIANT_A, _pair

torch.set_num_threads(2)


def _boxes(rng, b, n, scale=100.0):
    xy = rng.uniform(0, scale, (b, n, 2))
    wh = rng.uniform(1, scale / 3, (b, n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _tied_case():
    """Tied scores, and pairs at IoU exactly 0.5 and just above."""
    boxes = np.asarray([[[0, 0, 10, 10], [0, 0, 10, 20], [0, 0, 10, 10], [5, 0, 15, 10],
                         [0, 0, 10, 10.5], [40, 40, 50, 50], [40, 40, 50, 50]]], np.float32)
    scores = np.asarray([[0.5, 0.9, 0.5, 0.5, 0.9, 0.3, 0.3]], np.float32)
    return boxes, scores


def _jax_keep(boxes, scores, thr):
    return np.asarray(jax.jit(jax.vmap(jax_nms_mask, in_axes=(0, 0, None)), static_argnums=2)(
        jnp.asarray(boxes), jnp.asarray(scores), thr))


@pytest.mark.parametrize("case,thr", [("random", 0.5), ("random", 0.7), ("tied", 0.5),
                                      ("tied", 1 / 3)])
def test_plain_matches_jax(case, thr):
    if case == "tied":
        boxes, scores = _tied_case()
    else:
        rng = np.random.default_rng(0)
        boxes, scores = _boxes(rng, 3, 60), rng.uniform(size=(3, 60)).astype(np.float32)
        boxes[:, 30:] = boxes[:, :30] + rng.uniform(-2, 2, (3, 30, 4)).astype(np.float32)
        scores[:, 10:20] = scores[:, :10]  # ties
    ref = _jax_keep(boxes, scores, thr)
    out = nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), thr).numpy()
    np.testing.assert_array_equal(out, ref)
    assert ref.any() and not ref.all()


def _iou_f32(a: np.ndarray, aa, b: np.ndarray, ab):
    """``box_iou``'s parts in numpy float32, each operation rounded on its own:
    -> (intersection, denominator, quotient)."""
    f = np.float32
    w = np.maximum(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), f(0))
    h = np.maximum(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), f(0))
    inter = w * h
    d = ((aa + ab) - inter) + f(1e-8)
    with np.errstate(divide="ignore", invalid="ignore"):
        q = inter / d
    assert q.dtype == f
    return inter, d, q


def _iou_above(inter, d, q, thr: float) -> np.ndarray:
    """``nms.cu:iou_above``: the division's verdict decided by thr * d times
    (1 -+ 2^-20) where the intersection lies outside, by the quotient
    elsewhere (and always for a threshold outside [2^-98, FLT_MAX])."""
    f = np.float32
    thr = f(thr)
    if not (f(2.0 ** -98) <= thr <= np.finfo(f).max):
        return q > thr
    with np.errstate(over="ignore", invalid="ignore"):
        p = thr * d
        above = inter > p * f(1 + 2.0 ** -20)
        below = inter < p * f(1 - 2.0 ** -20)
    return np.where(above, True, np.where(below, False, q > thr))


def _k7_emulated(boxes: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms.cu's steps for one image, in numpy float32: the ranks (a warp
    takes four rows, lane l counts the scores l, l + 32, ... before each, a
    warp sum adds the lanes), the (row, word) IoU words of the upper triangle
    by ``iou_above`` (every other word of the bit matrix left as garbage,
    which the sweep must never read), the sweep over 32-box blocks
    (resolution inside the block, then the kept rows' words removed from the
    later lanes) and the scatter."""
    f, full = np.float32, 0xFFFFFFFF
    n = len(scores)
    words = (n + 31) // 32
    scores = scores.astype(f)
    # (1) rank = #{s_j > s_i} + #{j < i, s_j == s_i}: 32 lanes' counts, summed
    order = np.full(n, -1, np.int64)
    j = np.arange(n)
    lane_of = j % 32
    for i in range(n):
        before = (scores > scores[i]) | ((scores == scores[i]) & (j < i))
        rank = int(np.bincount(lane_of, weights=before, minlength=32).sum())
        assert order[rank] == -1
        order[rank] = i
    sb = boxes[order].astype(f)
    area = (np.maximum(sb[:, 2] - sb[:, 0], f(0)) * np.maximum(sb[:, 3] - sb[:, 1], f(0)))
    # (2) the words w >= i // 32 of row i, lane k holding box 32 w + k
    bits = np.random.default_rng(n).integers(0, 1 << 32, (n, words), dtype=np.uint64)
    lane = np.arange(32)
    for i in range(n):
        for w in range(i >> 5, words):
            jj = 32 * w + lane
            ok = (jj > i) & (jj < n)
            hit = np.zeros(32, bool)
            hit[ok] = _iou_above(*_iou_f32(sb[i], area[i], sb[jj[ok]], area[jj[ok]]), thr)
            bits[i, w] = int((hit.astype(np.uint64) << lane.astype(np.uint64)).sum())
    # (3) the sweep, lane v holding word v of the keep mask
    kept = [0] * 32
    for v in range(words):
        left = n - 32 * v
        kept[v] = full if left >= 32 else (1 << left) - 1
    for w in range(words):
        diag = [int(bits[32 * w + k, w]) if 32 * w + k < n else 0 for k in range(32)]
        cand = kept[w]
        for k in range(32):
            if (cand >> k) & 1:
                cand &= ~diag[k] & full
        kept[w] = cand
        for v in range(w + 1, words):
            removed = 0
            for k in range(32):
                if (cand >> k) & 1:
                    removed |= int(bits[32 * w + k, v])
            kept[v] &= ~removed & full
    # (4) the scatter back to the original order
    keep = np.zeros(n, bool)
    keep[order] = [(kept[r >> 5] >> (r & 31)) & 1 for r in range(n)]
    return keep


def _chain_case():
    """70 boxes whose scores fall with the index, in a shuffled order; those
    ranked 29-35 each overlap the next at IoU 2/3 and the one after at 3/7,
    the rest overlap nothing (``chip_smoke.py:k7_chain``)."""
    r = np.arange(70)
    x, y, size = (r % 10) * 100.0, (r // 10) * 100.0, np.full(70, 20.0)
    chain = (r >= 29) & (r <= 35)
    x[chain], y[chain], size[chain] = (r[chain] - 29) * 2.0, 2000.0, 10.0
    boxes = np.stack([x, y, x + size, y + size], -1).astype(np.float32)
    scores = (1 - r / 128).astype(np.float32)
    perm = np.random.default_rng(5).permutation(70)
    return boxes[perm][None], scores[perm][None]


def _all_overlapping_case():
    """100 boxes, each within half a unit of one 40 x 40 box: every IoU is
    above 0.9, so only the best-scored box stays."""
    rng = np.random.default_rng(7)
    boxes = (np.asarray([10, 10, 50, 50], np.float32)
             + rng.uniform(0, 0.5, (1, 100, 4))).astype(np.float32)
    return boxes, rng.uniform(size=(1, 100)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, 300, 1000, 1024])
def test_k7_split_emulated_matches_plain(n):
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, 1, n, scale=40.0)
    scores = np.round(rng.uniform(size=(1, n)), 2).astype(np.float32)  # many ties
    plain = nms.nms_mask_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    np.testing.assert_array_equal(_k7_emulated(boxes[0], scores[0], 0.5), plain[0])
    assert nms.smem_bytes(n) <= 232_448


def test_k7_emulated_on_the_tied_case():
    boxes, scores = _tied_case()
    for thr in (0.5, 1 / 3):
        np.testing.assert_array_equal(_k7_emulated(boxes[0], scores[0], thr),
                                      _jax_keep(boxes, scores, thr)[0])


@pytest.mark.parametrize("case", ["chain", "all_overlapping"])
def test_k7_emulated_on_constructed_cases(case):
    """The word-boundary chain (29 removes 30, 30 is gone so 31 stays and
    removes 32 in the next word, ...) and the all-overlapping case (one box
    stays): the emulation equals the plain version, and on the chain JAX's
    ``nms_mask`` too."""
    boxes, scores = _chain_case() if case == "chain" else _all_overlapping_case()
    plain = nms.nms_mask_plain(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    got = _k7_emulated(boxes[0], scores[0], 0.5)
    np.testing.assert_array_equal(got, plain[0])
    ranked = got[np.argsort(-scores[0], kind="stable")]
    if case == "chain":
        np.testing.assert_array_equal(got, _jax_keep(boxes, scores, 0.5)[0])
        assert ranked[29:36].tolist() == [True, False] * 3 + [True]
        assert ranked.sum() == 70 - 3
    else:
        assert ranked.tolist() == [True] + [False] * 99


@pytest.mark.parametrize("thr", [0.5, 0.7, 1 / 3, 0.1, 1e-20, 1e-35])
def test_k7_division_free_test_equals_the_quotients(thr):
    """``iou_above`` against ``iou > thr`` of the rounded quotient, exactly:
    random pairs, pairs whose quotient sits within a few ulps of the
    threshold (a box cut to that share of the other's width), disjoint
    pairs and degenerate boxes (zero and NaN widths); 1e-35 lies below
    2^-98, where every pair takes the division."""
    f = np.float32
    rng = np.random.default_rng(int(thr * 1e6) % 1000)
    a = _boxes(rng, 1, 4000, scale=60.0)[0]
    b = _boxes(rng, 1, 4000, scale=60.0)[0]
    near = a.copy()
    near[:, 2] = a[:, 0] + (a[:, 2] - a[:, 0]) * f(thr) * rng.uniform(0.999999, 1.000001, 4000)
    pairs = [(a, b), (a, near), (a, a + f(500)), (a, np.where(rng.uniform(size=(4000, 4)) < 0.05,
                                                              f(np.nan), b).astype(f))]
    pairs.append((a, np.concatenate([b[:, :2], b[:, :2]], 1)))  # zero-area boxes
    for x, y in pairs:
        ax = np.maximum(x[:, 2] - x[:, 0], f(0)) * np.maximum(x[:, 3] - x[:, 1], f(0))
        ay = np.maximum(y[:, 2] - y[:, 0], f(0)) * np.maximum(y[:, 3] - y[:, 1], f(0))
        inter, d, q = _iou_f32(x, ax, y, ay)
        np.testing.assert_array_equal(_iou_above(inter, d, q, thr), q > f(thr))
    inter, d, q = _iou_f32(a, np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0),
                           near, np.maximum(near[:, 2] - near[:, 0], 0)
                           * np.maximum(near[:, 3] - near[:, 1], 0))
    if thr >= 0.1:  # some quotients do straddle the threshold (below, no box can be so thin)
        assert np.abs(q / f(thr) - 1).min() < 1e-5


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrapper's
    kernel path without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_wrapper_refuses_before_launching(monkeypatch):
    """More than 1,024 boxes, a dtype other than f32 or a shape mismatch raise
    before any build or launch; a good call goes on to the launch."""
    def no_launch(*args):
        raise AssertionError("kernel launch reached")

    monkeypatch.setattr(nms, "_nms_cuda", no_launch)

    def on_card(*shape, dtype=torch.float32):
        return torch.empty(*shape, dtype=dtype, device="meta").as_subclass(_OnCard)

    with pytest.raises(ValueError, match="1024 boxes"):
        nms.nms_mask(on_card(2, 1025, 4), on_card(2, 1025), 0.5)
    with pytest.raises(TypeError, match="float32"):
        nms.nms_mask(on_card(2, 300, 4, dtype=torch.bfloat16), on_card(2, 300), 0.5)
    with pytest.raises(ValueError, match=r"boxes \[B, N, 4\]"):
        nms.nms_mask(on_card(2, 300, 4), on_card(2, 299), 0.5)
    with pytest.raises(AssertionError, match="kernel launch reached"):
        nms.nms_mask(on_card(2, 300, 4), on_card(2, 300), 0.5)
    assert nms.nms_mask.launches == 0


def test_postprocess_with_nms_matches_jax():
    rng = np.random.default_rng(3)
    b, nq, c = 2, 30, 5
    logits = rng.normal(size=(b, nq, c)).astype(np.float32)
    cxcy = rng.uniform(0.3, 0.7, (b, nq, 2))
    boxes = np.concatenate([cxcy, rng.uniform(0.1, 0.3, (b, nq, 2))], -1).astype(np.float32)
    sizes = np.asarray([[480, 640], [600, 400]], np.float32)
    ref = jax_postprocess(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(sizes),
                          num_select=40, nms_iou_threshold=0.5)
    out = postprocess(torch.from_numpy(logits), torch.from_numpy(boxes),
                      torch.from_numpy(sizes), num_select=40, nms_iou_threshold=0.5)
    assert (np.asarray(ref["scores"]) == -1).any()
    np.testing.assert_array_equal(out["scores"].numpy() == -1, np.asarray(ref["scores"]) == -1)
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(ref["labels"]))
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-5)


def test_variant_a_eval_step_matches_jax():
    """Variant A's eval step (the teacher's map into the content queries, NMS
    at 0.5) against JAX's: scores (the dropped ones -1) and boxes to 1e-3,
    labels and the dropped set exactly; without the teacher it refuses."""
    s = _pair(**VARIANT_A)
    batch = _with_teacher_keys(_batches())[1]
    inputs = ("images", "pad_mask", "orig_size")
    jax_step = jax_make_eval_step(s["jax_model"], s["jcfg"], clip_model=s["jax_clip"])
    ref = jax_step(s["params"], {k: jnp.asarray(batch[k]) for k in inputs},
                   jnp.asarray(s["text"]), s["clip_params"])
    with pytest.raises(ValueError, match="clip_model"):
        make_eval_step(s["model"], s["cfg"])
    step = make_eval_step(s["model"], s["cfg"], s["clip"])
    out = step({k: torch.from_numpy(batch[k]) for k in inputs}, torch.from_numpy(s["text"]))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert (ref["scores"] == -1).any()
    np.testing.assert_array_equal(out["scores"].numpy() == -1, ref["scores"] == -1)
    np.testing.assert_array_equal(out["labels"].numpy(), ref["labels"])
    for k in ("scores", "boxes"):
        np.testing.assert_allclose(out[k].numpy(), ref[k], rtol=OUT_TOL, atol=OUT_TOL, err_msg=k)
