"""The port's teacher targets held against ``richsem_tpu/models/clip_align.py``.

The tiny CLIP of ``tests/test_torch_clip.py`` (seeded weights in every leaf),
two images of different valid sizes and GT slots whose valid ones are not a
prefix: the box targets without compaction and with it (``max_boxes`` below
the valid count, so the stable partition decides which slots get a target),
the single and multi-label weak labels, and the class text bank built with
``HashTokenizer``, in f32; and the compacted box targets of a bf16 teacher, as
the flagship runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.clip import tokenizer as jax_tok
from richsem_tpu.models.clip_align import build_text_embedding as jax_text_bank
from richsem_tpu.models.clip_align import clip_pseudo_labels as jax_pl
from richsem_tpu.models.clip_align import clip_pseudo_labels_multi as jax_pl_multi
from richsem_tpu.models.clip_align import clip_teacher_box_targets as jax_targets
from richsem_tpu_torch.models import clip_align as port
from richsem_tpu_torch.models.clip import tokenizer as port_tok
from tests.test_torch_clip import tiny_pair

torch.set_num_threads(2)

G, C = 6, 5


@pytest.fixture(scope="module")
def case():
    jax_model, params, model = tiny_pair(seed=3)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (2, G, 2)),
                            rng.uniform(0.05, 0.7, (2, G, 2))], -1).astype(np.float32)
    boxes[0, 2, 2] = 0.0  # a degenerate (zero-width) box
    valid = np.asarray([[True, False, True, True, False, True],
                        [False, False, True, False, True, False]])
    sizes = np.asarray([[64, 96], [48, 80]], np.float32)
    text = rng.normal(size=(C, 16)).astype(np.float32)
    return dict(jax_model=jax_model, params=params, model=model, images=images, boxes=boxes,
                valid=valid, sizes=sizes, text=text)


@pytest.mark.parametrize("max_boxes", [None, 2, 100], ids=["all", "compacted", "k_ge_g"])
def test_box_targets_match_jax(case, max_boxes):
    p = case["params"]
    ref = jax_targets(case["jax_model"], p, jnp.asarray(case["images"]),
                      jnp.asarray(case["boxes"]), jnp.asarray(case["sizes"]),
                      jnp.asarray(case["text"]), p["params"]["logit_scale"],
                      valid=jnp.asarray(case["valid"]), max_boxes=max_boxes)
    model = case["model"]
    out = port.clip_teacher_box_targets(
        model, torch.from_numpy(case["images"]), torch.from_numpy(case["boxes"]),
        torch.from_numpy(case["sizes"]), torch.from_numpy(case["text"]), model.logit_scale,
        valid=torch.from_numpy(case["valid"]), max_boxes=max_boxes)
    for name, a, b in zip(("clip_embed", "clip_logits", "clip_valid"), out, ref):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    want_valid = case["valid"].copy()
    if max_boxes == 2:
        want_valid[0, 3:] = False  # image 0: its first two valid slots only
    np.testing.assert_array_equal(out[2].numpy(), want_valid)
    assert (out[1][~out[2]] == 0).all()


def test_box_targets_of_a_bf16_teacher_match_jax(case):
    """The flagship's teacher computes in bf16: its embeddings stay bf16 and
    meet the f32 text bank in f32, as JAX promotes them; compacted."""
    jax_model, p, model = tiny_pair(seed=3, dtype=torch.bfloat16)
    args = [case[k] for k in ("images", "boxes", "sizes", "text")]
    ref = jax_targets(jax_model, p, *map(jnp.asarray, args), p["params"]["logit_scale"],
                      valid=jnp.asarray(case["valid"]), max_boxes=2)
    out = port.clip_teacher_box_targets(model, *map(torch.from_numpy, args), model.logit_scale,
                                        valid=torch.from_numpy(case["valid"]), max_boxes=2)
    assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.float32
    assert ref[0].dtype == jnp.bfloat16 and ref[1].dtype == jnp.float32
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    # bf16 convolutions and pool projections summed in another order: one or
    # two bf16 steps (2^-8) of the unit embeddings, times 1/0.07 in the logits
    np.testing.assert_allclose(out[0].float().numpy(), np.asarray(ref[0], np.float32),
                               rtol=0, atol=1e-2)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=0, atol=0.1)


def test_box_targets_reuse_the_spatial_map(case):
    model = case["model"]
    args = (model, torch.from_numpy(case["images"]), torch.from_numpy(case["boxes"]),
            torch.from_numpy(case["sizes"]), torch.from_numpy(case["text"]), model.logit_scale)
    spatial = port.clip_spatial_features(model, args[1])
    a = port.clip_teacher_box_targets(*args, spatial=spatial)
    b = port.clip_teacher_box_targets(*args)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert bool(a[2].all())


def test_pseudo_labels_match_jax():
    rng = np.random.default_rng(8)
    logits = (rng.normal(size=(2, G, 7)) * 3).astype(np.float32)
    logits[1, 4] = 0.0  # a flat row: ties everywhere
    boxes = rng.uniform(size=(2, G, 4)).astype(np.float32)
    valid = rng.uniform(size=(2, G)) < 0.7
    for th in (0.05, 0.3):
        labels, keep = port.clip_pseudo_labels(torch.from_numpy(logits),
                                               torch.from_numpy(valid), th)
        rl, rk = jax_pl(jnp.asarray(logits), jnp.asarray(valid), th)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(rl))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(rk))
        out = port.clip_pseudo_labels_multi(torch.from_numpy(logits), torch.from_numpy(boxes),
                                            torch.from_numpy(valid), th, expand_topk=3)
        ref = jax_pl_multi(jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(valid), th,
                           expand_topk=3)
        for name, a, b in zip(("labels", "boxes", "keep", "slot"), out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{name} @ {th}")


def test_text_bank_matches_jax():
    # the hash ids lie in [1000, vocab - 2): a vocabulary that holds them (JAX
    # would clamp an id past the table; the port raises)
    jax_model, params, model = tiny_pair(seed=4, vocab_size=1200, context_length=12)
    cats = {1: {"name": "cat"}, 3: {"name": "sea_lion"}, 4: {"name": "traffic light"}}
    ref = jax_text_bank(jax_model, jax.tree.map(jnp.asarray, params), cats, jax_tok.HashTokenizer(1200),
                        context_length=12, batch_size=4)
    out = port.build_text_embedding(model, cats, port_tok.HashTokenizer(1200),
                                    context_length=12, batch_size=4)
    assert out.shape == (5, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert len(port.load_prompt_templates()) == 81
