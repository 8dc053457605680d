"""A run with the timed path broken underneath comes out not correct, held to
the cells' own limits: the harness's look for a card skipped, the rest of a
run driven on the CPU at tiny widths in float32 (where the sound program
reads as the reference), once for each fault a cell can have. No cell spans
chips, so none can leave out an exchange between them."""

import time

import pytest
import torch

from benchmark.harness import core, eval_cell, train_cell
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import _f32


def _limits(workload):
    return core.load_json(f"benchmark/limits/{workload}.json")


def _half_batch(host, batch):
    """Half of the batch left out: the rows of its second half never written."""
    keep = host["scores"].shape[0] // 2
    return {k: torch.cat([v[:keep], torch.zeros_like(v[keep:])]) for k, v in host.items()}


def _score_altered(host, batch):
    """Every answer's score altered where it is produced (by 0.01)."""
    return dict(host, scores=host["scores"] - 0.01)


def _label_shifted(host, batch):
    """Every answer's label moved to the next class where it is produced."""
    return dict(host, labels=host["labels"] + 1)


def _hw_swapped(host, batch):
    """The boxes scaled to the original size with its height and width swapped."""
    h, w = batch["orig_size"].float().cpu().unbind(-1)
    fix = torch.stack([h / w, w / h, h / w, w / h], -1)[:, None]
    return dict(host, boxes=host["boxes"] * fix)


# swinl-eval compares the scores alone (PERF.md): labels and boxes in r50-eval
@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in ("r50-eval", "swinl-eval") for f in (None, _half_batch, _score_altered)
] + [("r50-eval", _label_shifted), ("r50-eval", _hw_swapped)])
def test_eval_faults(workload, fault, monkeypatch):
    run = _f32(tiny.run(workload, seed=11, batch=4, check_images=4), monkeypatch)
    out = eval_cell.run(run, time.perf_counter(), fault=fault)
    assert out["checks"].keys() == _limits(workload).keys()
    assert out["correct"] is (fault is None)


def _unchanged(step):
    """A step that returns the state unchanged."""
    def call(state, batch, text=None, draws=None):
        keep = [t.detach().clone() for t in state.optimizer.leaves()]
        mom = [t.clone() for t in state.optimizer.mu + state.optimizer.nu]
        out = step(state, batch, text, draws)
        with torch.no_grad():
            for t, k in zip(state.optimizer.leaves() + state.optimizer.mu + state.optimizer.nu,
                            keep + mom):
                t.copy_(k)
        return out
    call.eager = step.eager
    return call


def _half_of_batch(step):
    """Half of the batch left out, the loss's mean taken over the rest."""
    loss_fn = step.loss_fn

    def half(batch, draws, text_embed=None, **kw):
        b = batch["images"].shape[0] // 2
        cut = {k: (v[:b] if torch.is_tensor(v) and v.dim() and v.shape[0] == 2 * b else v)
               for k, v in batch.items()}
        d = dict(draws, dn={k: v[:b] for k, v in draws["dn"].items()})
        return loss_fn(cut, d, text_embed, **kw)
    step.loss_fn = half
    return step


def _loss_altered(step):
    """The loss altered where it is produced (by a half)."""
    loss_fn = step.loss_fn

    def altered(*a, **kw):
        total, terms = loss_fn(*a, **kw)
        return total * 1.5, terms
    step.loss_fn = altered
    return step


class _GradScaled(torch.autograd.Function):
    """The identity forward; the backward scales the gradient by ``k``."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.k = k
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.k, None


def _kernel_grad_halved(module: str, name: str, arg: int):
    """A fault of a backward kernel: the gradient that reaches argument
    ``arg`` of the entry ``module.name`` halved."""
    def fault(step):
        import importlib

        mod = importlib.import_module(module)
        entry = getattr(mod, name)

        def halved(*args):
            args = list(args)
            args[arg] = _GradScaled.apply(args[arg], 0.5)
            return entry(*args)

        def call(state, batch, text=None, draws=None):
            setattr(mod, name, halved)
            try:
                return step(state, batch, text, draws)
            finally:
                setattr(mod, name, entry)
        call.eager = step.eager
        return call
    return fault


# K1-bwd's d_value, and K2-bwd's gradient to the layer's input, halved
_dvalue_halved = _kernel_grad_halved("richsem_tpu_torch.models.layers", "ms_deform_attn", 0)
_tail_dinput_halved = _kernel_grad_halved("richsem_tpu_torch.models.dino", "encoder_tail", 0)


@pytest.mark.parametrize("fault", [None, _unchanged, _half_of_batch, _loss_altered,
                                   _dvalue_halved, _tail_dinput_halved])
def test_train_faults(fault, monkeypatch):
    run = _f32(tiny.run("r50-train", seed=13), monkeypatch)
    out = train_cell.run(run, time.perf_counter(), fault=fault)
    assert out["checks"].keys() == _limits("r50-train").keys()
    assert out["correct"] is (fault is None), out["numbers"]
