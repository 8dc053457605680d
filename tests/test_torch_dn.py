"""The port's contrastive-denoising queries (``prepare_cdn``, budget branch)
held against the JAX package, given the same four random draws.

The JAX version draws from ``jax.random`` inside; the test takes the same
draws with the same keys (``dn.py:88-101``) and hands them to the port.
Labels, masks and metadata must agree exactly; boxes to f32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from richsem_tpu.models.criterion import expand_dn_targets as jax_expand
from richsem_tpu.models.dn import prepare_cdn as jax_prepare_cdn
from richsem_tpu_torch.models.criterion import expand_dn_targets
from richsem_tpu_torch.models.dn import cdn_draws, cdn_pad, prepare_cdn

C = 37


def _targets(seed, counts, g_slots):
    rng = np.random.default_rng(seed)
    b = len(counts)
    labels = rng.integers(0, C, (b, g_slots)).astype(np.int32)
    cxcy = rng.uniform(0.1, 0.9, (b, g_slots, 2))
    wh = rng.uniform(0.02, 0.6, (b, g_slots, 2))
    boxes = np.concatenate([cxcy, wh], -1).astype(np.float32)
    valid = np.arange(g_slots)[None, :] < np.asarray(counts)[:, None]
    return labels, boxes, valid


def _jax_draws(rng, b, pad):
    """The draws of JAX prepare_cdn, taken with its own keys."""
    k_flip, k_new, k_sign, k_part = jax.random.split(rng, 4)
    return {
        "flip": np.asarray(jax.random.uniform(k_flip, (b, pad))),
        "new_label": np.asarray(jax.random.randint(k_new, (b, pad), 0, C)),
        "sign": np.asarray(jax.random.randint(k_sign, (b, pad, 4), 0, 2)
                           .astype(jnp.float32) * 2 - 1),
        "part": np.asarray(jax.random.uniform(k_part, (b, pad, 4))),
    }


@pytest.mark.parametrize("counts,g_slots,dn_number", [
    ((3, 7), 10, 100),  # 14 groups of 2 * 7 slots
    ((0, 5, 2), 8, 100),  # an image without boxes
    ((9, 9), 12, 5),  # dn_number < max count: one group, part of it in use
    ((0, 0), 4, 20),  # no boxes at all: m clamps to 1
])
def test_prepare_cdn_matches_jax(counts, g_slots, dn_number):
    labels, boxes, valid = _targets(len(counts) + g_slots, counts, g_slots)
    b, nq = len(counts), 11
    rng = jax.random.PRNGKey(dn_number + g_slots)
    ref = jax_prepare_cdn(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid), rng,
                          dn_number=dn_number, label_noise_ratio=0.5, box_noise_scale=1.0,
                          num_classes=C, num_queries=nq)
    draws = {k: torch.from_numpy(np.array(v)) for k, v in
             _jax_draws(rng, b, 2 * dn_number).items()}
    out = prepare_cdn(torch.from_numpy(labels).long(), torch.from_numpy(boxes),
                      torch.from_numpy(valid), draws, torch.tensor(max(counts)),
                      dn_number=dn_number,
                      label_noise_ratio=0.5, box_noise_scale=1.0, num_queries=nq)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))
    assert set(out[3]) == set(ref[3])
    for key in ref[3]:
        np.testing.assert_array_equal(out[3][key].numpy(), np.asarray(ref[3][key]), key)

    exp = expand_dn_targets(torch.from_numpy(labels).long(), torch.from_numpy(boxes),
                            torch.from_numpy(valid), out[3])
    exp_ref = jax_expand(jnp.asarray(labels), jnp.asarray(boxes), jnp.asarray(valid),
                         ref[3], 2 * dn_number)
    for key in ("pos_slots", "pos_labels", "pos_boxes", "pos_valid"):
        np.testing.assert_array_equal(exp[key].numpy(), np.asarray(exp_ref[key]), key)


def test_cdn_draws_shapes_and_ranges():
    g = torch.Generator().manual_seed(0)
    d = cdn_draws(3, 50, C, g, device="cpu")
    assert d["flip"].shape == (3, 100) and d["new_label"].shape == (3, 100)
    assert d["sign"].shape == (3, 100, 4) and d["part"].shape == (3, 100, 4)
    assert set(d["sign"].unique().tolist()) <= {-1.0, 1.0}
    assert 0 <= int(d["new_label"].min()) and int(d["new_label"].max()) < C
    assert float(d["part"].min()) >= 0.0 and float(d["part"].max()) < 1.0


@pytest.mark.parametrize("kw", [{"group_mode": True}, {"check_pos_dn": True}])
def test_unported_branches_raise(kw):
    """The two branches that raised here are ported (held against JAX in
    tests/test_torch_variants.py): they run on draws sized by ``cdn_pad``, the
    group-count branch with ``2 * dn_number`` groups in a pad of
    ``4 * dn_number * G`` slots."""
    labels, boxes, valid = _targets(0, (2,), 4)
    group = kw.get("group_mode", False)
    pad = cdn_pad(10, 4, group)
    draws = cdn_draws(1, 10, C, torch.Generator().manual_seed(0), device="cpu", pad=pad)
    out = prepare_cdn(torch.from_numpy(labels).long(), torch.from_numpy(boxes),
                      torch.from_numpy(valid), draws, torch.tensor(2), dn_number=10, **kw)
    assert out[0].shape == (1, pad) == ((1, 160) if group else (1, 20))
    assert int(out[3]["num_groups"]) == (20 if group else 5)
