"""Greedy NMS in the port (``ops/nms.py``, K7 on the card), held against the
JAX package's ``nms_mask`` and ``postprocess``.

* The plain version (what the wrapper runs on CPU tensors) against JAX's
  ``vmap(nms_mask)``: keep masks exactly equal, on random boxes, on tied
  scores (a stable order: the lower index first) and on pairs whose IoU is
  exactly the threshold (kept: the rule is ``iou > threshold``).
* K7's work split emulated in numpy (``csrc/nms.cu``): the rank of each score
  (``#{s_j > s_i} + #{j < i, s_j == s_i}``), the IoU of the sorted boxes with
  every operation rounded to float32 on its own (numpy's float32 arithmetic
  contracts nothing), the rows' 32-bit words of the later boxes above the
  threshold, the warp's sweep with lane ``w`` holding word ``w``, and the
  scatter back: bit for bit the plain version, at N = 1, 31, 33, 300 and
  1,024 (its limit).
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


def _k7_emulated(boxes: np.ndarray, scores: np.ndarray, thr: float) -> np.ndarray:
    """csrc/nms.cu's steps for one image, in numpy float32."""
    f = np.float32
    n = len(scores)
    words = (n + 31) // 32
    idx = np.arange(n)
    rank = ((scores[None, :] > scores[:, None])
            | ((scores[None, :] == scores[:, None]) & (idx[None, :] < idx[:, None]))).sum(1)
    order = np.empty(n, np.int64)
    order[rank] = idx  # every rank once
    sb = boxes[order].astype(f)
    area = (np.maximum(sb[:, 2] - sb[:, 0], f(0)) * np.maximum(sb[:, 3] - sb[:, 1], f(0)))
    w = np.maximum(np.minimum(sb[:, None, 2], sb[None, :, 2])
                   - np.maximum(sb[:, None, 0], sb[None, :, 0]), f(0))
    h = np.maximum(np.minimum(sb[:, None, 3], sb[None, :, 3])
                   - np.maximum(sb[:, None, 1], sb[None, :, 1]), f(0))
    inter = w * h
    iou = inter / (((area[:, None] + area[None, :]) - inter) + f(1e-8))
    assert iou.dtype == f
    above = (iou > f(thr)) & (idx[None, :] > idx[:, None])
    bits = np.zeros((n, words), np.uint64)
    for k in range(32):
        j = np.arange(words) * 32 + k
        ok = j < n
        bits[:, ok] |= above[:, j[ok]].astype(np.uint64) << np.uint64(k)
    lanes = np.zeros(32, np.uint64)
    for lane in range(words):
        left = n - lane * 32
        lanes[lane] = (1 << 32) - 1 if left >= 32 else (1 << left) - 1
    for i in range(n):
        if (int(lanes[i >> 5]) >> (i & 31)) & 1:
            lanes[:words] &= ~bits[i] & np.uint64(0xFFFFFFFF)
    keep = np.zeros(n, bool)
    keep[order] = [(int(lanes[r >> 5]) >> (r & 31)) & 1 for r in range(n)]
    return keep


@pytest.mark.parametrize("n", [1, 31, 33, 300, 1024])
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
