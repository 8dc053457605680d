"""The port's checkpoints (``richsem_tpu_torch/utils/checkpoint.py``).

* Save/restore is bitwise: the step, every parameter and frozen buffer, the
  AdamW moments and count (the schedule's position) and the EMA.
* ``max_to_keep`` and ``latest_step``; the epoch a checkpoint completes.
* ``BestMetricHolder`` gives the JAX holder's sequence.
* ``guard_converted_checkpoint`` makes the JAX guard's decisions on the cases
  of ``tests/test_ckpt_guard.py``.
* ``load_pretrained_params`` copies a flax tree's matching leaves through the
  converter, skipping ignored names and shape mismatches.
"""

import numpy as np
import pytest
import torch

import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.utils.checkpoint import BestMetricHolder as JaxBest
from richsem_tpu.utils.checkpoint import guard_converted_checkpoint as jax_guard
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.main import _resume_epoch
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.checkpoint import (BestMetricHolder, CheckpointManager,
                                                guard_converted_checkpoint,
                                                load_pretrained_params, state_to_dict)
from tests.test_torch_main import _drop_checkpoints  # noqa: F401  (autouse: ~400 MB a checkpoint)

torch.set_num_threads(2)

TINY = dict(hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=128,
            num_queries=20, num_classes=13, dn_labelbook_size=13, fed_num_sample_cats=4,
            compute_dtype="float32", use_ema=True)


def _cfg():
    cfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
    cfg.update(TINY)
    return cfg


def _state(cfg, seed=0):
    model, _, _ = build_model("richsem", cfg, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=4), use_ema=True)


def _batch():
    g = torch.Generator().manual_seed(1)
    return {"images": torch.rand((2, 96, 128, 3), generator=g) * 2 - 1,
            "pad_mask": torch.zeros(2, 96, 128, dtype=torch.bool),
            "labels": torch.tensor([[1, 2, 3], [4, 5, 0]]),
            "boxes": torch.tensor([[[0.5, 0.5, 0.2, 0.3]] * 3] * 2),
            "valid": torch.tensor([[True, True, True], [True, True, False]])}


def _flat(d, prefix=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _same(a, b):
    fa, fb = dict(_flat(a)), dict(_flat(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        if torch.is_tensor(fa[k]):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


def test_save_restore_bitwise(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    step = make_train_step(state.model, cfg, seed=0, device="cpu")
    for _ in range(2):
        step(state, _batch())
    assert state.optimizer.count == 2 and float(state.optimizer.mu[0].abs().sum()) > 0
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state, metrics={"AP": 0.25}, epoch=0)
    fresh = _state(cfg, seed=5)  # other weights, zero moments
    assert not torch.equal(next(fresh.model.parameters()), next(state.model.parameters()))
    restored = mgr.restore(fresh)
    assert restored is fresh and mgr.restored == {"step": 2, "epoch": 0, "metrics": {"AP": 0.25}}
    _same(state_to_dict(state), state_to_dict(fresh))
    # the restored state trains on as the saved one does
    m1, m2 = step(state, _batch()), make_train_step(fresh.model, cfg, seed=0, device="cpu")(
        fresh, _batch())
    assert torch.equal(m1["loss"], m2["loss"])
    _same(state_to_dict(state), state_to_dict(fresh))


def test_max_to_keep_and_latest_step(tmp_path):
    cfg = _cfg()
    state = _state(cfg)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=3)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state)
    for s in (4, 8, 12, 16, 20):
        state.step = s
        mgr.save(s, state, epoch=s // 4 - 1)
    assert mgr.all_steps() == [12, 16, 20] and mgr.latest_step() == 20
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["12.pt", "16.pt", "20.pt"]
    mgr.save(20, state, epoch=4, metrics={"AP": 0.5})  # the same step again: replaced
    assert mgr.all_steps() == [12, 16, 20]
    state.step = 0
    mgr.restore(state, step=16)
    assert state.step == 16 and mgr.restored["epoch"] == 3


def test_resume_needs_the_epoch(tmp_path):
    """A resumed run continues after the epoch its checkpoint records; a
    checkpoint without one is refused, not resumed at ``step // steps_per_epoch``
    (F8)."""
    state = _state(_cfg())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state.step = 15
    mgr.save(15, state, epoch=1)
    mgr.restore(state)
    assert _resume_epoch(mgr) == 2
    path = tmp_path / "ckpt" / "15.pt"
    payload = torch.load(path, weights_only=True)
    del payload["epoch"]
    torch.save(payload, path)
    mgr.restore(state)
    with pytest.raises(ValueError, match="no epoch"):
        _resume_epoch(mgr)


def test_best_metric_holder_sequence():
    seq = [(0.1, 0, False), (0.05, 1, False), (0.2, 2, False), (0.3, 2, True),
           (0.25, 3, True), (float("nan"), 4, False), (0.2, 5, False), (0.4, 6, True)]
    for use_ema in (False, True):
        a, b = JaxBest(use_ema), BestMetricHolder(use_ema)
        assert [a.update(*x) for x in seq] == [b.update(*x) for x in seq]
        assert a.summary() == b.summary()


TAGGED = {"params": {}, "meta": {"source": "reference_torch_checkpoint",
                                 "unbounded_offsets": True}}
GUARD_CASES = [
    (dict(eval=True), TAGGED), (dict(test=True), TAGGED), ({}, TAGGED),
    (dict(allow_clamp_on_converted=True), TAGGED),
    (dict(msda_impl="gather", msda_clamp_offsets=False), TAGGED),
    (dict(msda_impl="gather", msda_clamp_offsets=True), TAGGED),
    (dict(msda_impl="sep", msda_clamp_offsets=True), TAGGED),
    (dict(eval=True), {"params": {}}), ({}, [1, 2]),
]


@pytest.mark.parametrize("over,pretrained", GUARD_CASES)
def test_guard_decisions_equal(over, pretrained):
    outcomes = []
    for cls, guard in ((JaxConfig, jax_guard), (Config, guard_converted_checkpoint)):
        cfg = cls.from_dict(dict(dict(msda_impl="pallas2", msda_clamp_offsets=True, eval=False,
                                      test=False), **over))
        try:
            guard(cfg, pretrained)
            outcomes.append(("ok", cfg.msda_impl, cfg.msda_clamp_offsets))
        except ValueError as e:
            outcomes.append(("refused", str(e)))
    assert outcomes[0] == outcomes[1]


def test_load_pretrained_params(capsys):
    cfg = _cfg()
    state = _state(cfg)
    model = state.model
    rng = np.random.default_rng(0)
    kernel = rng.normal(size=(64, 128)).astype(np.float32)  # flax [in, out]
    tree = {"params": {
        "level_embed": rng.normal(size=(4, 64)).astype(np.float32),
        "encoder_layer0": {"ffn": {"linear1": {"kernel": kernel,
                                               "bias": np.ones(128, np.float32)}}},
        "tgt_embed": rng.normal(size=(21, 64)).astype(np.float32),  # shape mismatch
        "cls_bias": np.full(13, 3.0, np.float32),  # ignored by keyword
    }, "meta": {"unbounded_offsets": False}}
    before = model.state_dict()["tgt_embed"].clone()
    loaded = load_pretrained_params(model, tree, ["cls_"])
    assert loaded == 3
    sd = model.state_dict()
    assert torch.equal(sd["encoder_layer0.ffn.linear1.weight"], torch.from_numpy(kernel.T))
    assert torch.equal(sd["level_embed"], torch.from_numpy(tree["params"]["level_embed"]))
    assert torch.equal(sd["tgt_embed"], before)
    assert not torch.equal(sd["cls_bias"], torch.full((13,), 3.0))
    assert "shape-mismatch skipped (1)" in capsys.readouterr().out
