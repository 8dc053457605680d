"""What each rank runs in the data-parallel tests (``tests/test_torch_ddp_*.py``).

The tests start their ranks with ``richsem_tpu_torch/parallel/dist.py:spawn``
(the spawn method, gloo on the CPU, a free localhost port); a rank imports
this module, which imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from richsem_tpu_torch.parallel import dist as pdist


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_arrays(state) -> dict:
    """Parameters, EMA and AdamW's moments of a TrainState as numpy arrays."""
    opt = state.optimizer
    names = [n for n, _ in opt.trainable]
    return {"params": {n: p.detach().numpy().copy() for n, p in state.model.named_parameters()},
            "ema": {n: t.numpy().copy() for n, t in (state.ema or {}).items()},
            "mu": {n: t.numpy().copy() for n, t in zip(names, opt.mu)},
            "nu": {n: t.numpy().copy() for n, t in zip(names, opt.nu)}}


def state_digest(state) -> str:
    opt = state.optimizer
    return digest([*state.model.parameters(), *state.model.buffers(),
                   *(state.ema or {}).values(), *opt.mu, *opt.nu])


def rank_batch(batch: dict, d, cfg) -> dict:
    """This rank's rows of a global numpy batch, with the global statistics,
    as CPU tensors."""
    from richsem_tpu_torch.train.main import place_batch

    n = len(batch["images"]) // d.world
    mine = {k: v[d.rank * n:(d.rank + 1) * n] for k, v in batch.items()}
    mine.update(pdist.step_stats(d, mine, cfg))
    return place_batch(mine, "cpu")


def rank_draws(draws: dict, d, n: int) -> dict:
    """This rank's rows of the global batch's CDN draws; the federated-loss
    uniforms are the same on every rank."""
    rows = slice(d.rank * n, (d.rank + 1) * n)
    return {"dn": {k: torch.from_numpy(np.asarray(v)[rows]) for k, v in draws["dn"].items()},
            "fed_uniforms": torch.from_numpy(np.asarray(draws["fed_uniforms"]))}


def train_steps(cfg_items: dict, weights: dict, batches: list, jax_draws: list,
                threads: int = 1) -> dict:
    """The tiny DINO of ``tests/test_torch_train_step.py`` from ``weights``,
    two trajectories over ``batches`` (global numpy batches): with
    ``jax_draws`` (the rank's rows of JAX's draws) and with the step's own
    generator. -> per trajectory the metrics of every step and the digest of
    the final state; rank 0 adds the final states' arrays."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    torch.set_num_threads(threads)
    d = pdist.init_distributed("cpu")
    cfg = Config(dict(cfg_items))
    out = {}
    for name in ("jax", "own"):
        model, _, _ = build_model("richsem", cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
        state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2),
                                   use_ema=True)
        step = make_train_step(model, cfg, device="cpu", dist=d)
        metrics = []
        for i, gb in enumerate(batches):
            n = len(gb["images"]) // d.world
            draws = rank_draws(jax_draws[i], d, n) if name == "jax" else None
            m = step(state, rank_batch(gb, d, cfg), draws=draws)
            metrics.append({k: v.numpy().copy() for k, v in m.items()})
        out[name] = {"metrics": metrics, "digest": state_digest(state),
                     "reduce_bytes": step.reduce_bytes,
                     "state": state_arrays(state) if d.lead else None}
    return out


def variant_step(cfg_items: dict, weights: dict, clip_items: dict, clip_weights: dict,
                 batch: dict, jax_draws: dict, text: np.ndarray, threads: int = 1) -> dict:
    """One step of the semantic variant (``tests/test_torch_ddp_variants.py``)
    or of the weak labels (``tests/test_torch_weak_labels_ddp.py``): the
    detector from ``weights``, the tiny CLIP teacher from ``clip_items`` and
    ``clip_weights``, this rank's rows of ``batch`` and of JAX's draws. -> the
    step's metrics, the state's digest, the union collectives, the
    class_error count collectives, and the statistics the step's statistics
    collective returned (one entry a call)."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    torch.set_num_threads(threads)
    d = pdist.init_distributed("cpu")
    cfg = Config(dict(cfg_items))
    seen = []
    reduce = type(pdist.reduce_stats_).__call__

    def record(self, stats, dd, num_classes):
        out = reduce(self, stats, dd, num_classes)
        seen.append({k: v.numpy().copy() for k, v in out.items()})
        return out

    type(pdist.reduce_stats_).__call__ = record  # this rank's process only
    model, _, _ = build_model("richsem", cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    teacher = CLIP(CLIPConfig(**clip_items), device="cpu")
    teacher.load_state_dict({k: torch.from_numpy(v) for k, v in clip_weights.items()})
    teacher.eval().requires_grad_(False)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    step = make_train_step(model, cfg, device="cpu", clip_model=teacher, dist=d)
    n = len(batch["images"]) // d.world
    m = step(state, rank_batch(batch, d, cfg), torch.from_numpy(text),
             draws=rank_draws(jax_draws, d, n))
    return {"metrics": {k: v.numpy().copy() for k, v in m.items()},
            "digest": state_digest(state), "unions": pdist.union_.calls,
            "totals": pdist.total_.calls, "stats": seen}


def collective_count(cfg_items: dict, canvases: list, threads: int = 1) -> dict:
    """Steps on this rank's canvases (``canvases[step][rank]``) with the card's
    path played on the CPU: ``engine._on_card`` True, the warm-up run in
    place, and a capture that returns a stand-in graph whose replay runs the
    captured body (as ``tests/test_torch_train_graph.py`` plays it). -> for
    each step whether it warmed up or replayed and how many gradient
    collectives it issued, and the final state's digest."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.train import engine
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer

    class StandIn:
        def __init__(self, body, out):
            self.body, self.out = body, out

        def replay(self):
            self.out.update(self.body())

    def capture(self, key, what, body):
        out = {}
        return StandIn(body, out), out, {}

    engine._on_card = lambda batch: True
    engine._side_stream_run = lambda fn: fn()
    engine.TrainStep._capture_into = capture
    torch.set_num_threads(threads)
    d = pdist.init_distributed("cpu")
    cfg = Config(dict(cfg_items))
    model, _, _ = build_model("richsem", cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    step = make_train_step(model, cfg, device="cpu", dist=d)
    rng = np.random.default_rng(d.rank)
    log = []
    for per_rank in canvases:
        h, w = per_rank[d.rank]
        valid = np.arange(4)[None] < 3
        batch = {"images": rng.uniform(-1, 1, (1, h, w, 3)).astype(np.float32),
                 "pad_mask": np.zeros((1, h, w), bool),
                 "labels": rng.integers(1, cfg.num_classes, (1, 4)).astype(np.int32),
                 "boxes": np.concatenate([rng.uniform(0.3, 0.7, (1, 4, 2)),
                                          rng.uniform(0.1, 0.3, (1, 4, 2))], -1
                                         ).astype(np.float32),
                 "valid": valid}
        batch.update(pdist.step_stats(d, batch, cfg))
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
        t["labels"] = t["labels"].long()
        known = len(step.graphs)
        before = pdist.average_.launches
        step(state, t)
        log.append({"warm_up": len(step.graphs) > known,
                    "collectives": pdist.average_.launches - before})
    return {"steps": log, "digest": state_digest(state)}


def recorded_evals(evaluator_cls) -> list:
    """Record what each evaluator is given: ``evaluator_cls.update`` wrapped so
    that every instance's predictions (image id -> scores, labels, boxes)
    land in a dict of its own, appended to the returned list at its first
    update."""
    evals = []
    real = evaluator_cls.update

    def update(self, predictions):
        if not hasattr(self, "_recorded"):
            self._recorded = {}
            evals.append(self._recorded)
        self._recorded.update({int(k): tuple(np.asarray(p[f]).copy()
                                             for f in ("scores", "labels", "boxes"))
                               for k, p in predictions.items()})
        return real(self, predictions)

    evaluator_cls.update = update
    return evals


def same_predictions(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        all(np.array_equal(x, y) for x, y in zip(a[k], b[k])) for k in a)


def trainer_runs(cfg_path: str, out_root: str, nan_rank: int, nan_at: int,
                 threads: int = 1) -> dict:
    """``train_loop`` as a rank: two epochs straight (``out_root/a``), one epoch
    and an auto-resumed second (``out_root/b``; rank 1 resumes in an empty
    directory, so that only rank 0 restores), a single-process evaluate of
    the straight run's parameters over the whole val set (rank 0), and a run
    whose loss rank ``nan_rank`` turns non-finite at its step ``nan_at``
    (``out_root/c``). -> what each run did on this rank."""
    from richsem_tpu_torch.data.evaluation import LvisEvaluator
    from richsem_tpu_torch.train import main

    torch.set_num_threads(threads)
    evals = recorded_evals(LvisEvaluator)
    saves = []
    real_save = main.CheckpointManager.save

    def counted_save(self, step, *a, **kw):
        saves.append(step)
        return real_save(self, step, *a, **kw)

    main.CheckpointManager.save = counted_save

    def cfg(out, *extra):
        args = ["-c", cfg_path, "--output_dir", out, "--device", "cpu", *extra]
        return main.load_config(main.get_args_parser().parse_args(args))

    res = {}
    straight = main.train_loop(cfg(os.path.join(out_root, "a"), "--options", "epochs=2"))
    d = straight["dist"]
    res["rank"], res["world"], res["backend"] = d.rank, d.world, d.backend
    loader = main.build_loaders(cfg(""), d.rank, d.world)[0]
    res["canvases"] = [[b["images"].shape[1:3] for b in loader.epoch(e)] for e in range(2)]
    res["straight"] = {"step": straight["state"].step, "digest": state_digest(straight["state"]),
                       "epochs": straight["epochs"], "saves": list(saves)}
    # per epoch its eval and the EMA's: the last epoch's eval, gathered on rank 0
    res["evaluated"] = len(evals)
    gathered = evals[-2] if evals else None
    if d.lead:
        c = cfg("")
        _, val_loader, _, val_ds = main.build_loaders(c)
        res["single_eval"] = main.evaluate(c, straight["state"].model, val_loader, val_ds,
                                           device="cpu")
        res["images"] = sorted(evals[-1])
        res["same_predictions"] = same_predictions(gathered, evals[-1])
    del straight
    first = main.train_loop(cfg(os.path.join(out_root, "b"), "--options", "epochs=1"))
    res["first_step"] = first["state"].step
    del first
    # rank 1 sees no checkpoint: it takes rank 0's state, step and epoch
    resumed = main.train_loop(cfg(os.path.join(out_root, "b" if d.lead else "b_unseen"),
                                  "--options", "epochs=2"))
    res["resumed"] = {"step": resumed["state"].step, "digest": state_digest(resumed["state"]),
                      "restored": len(resumed["ckpt_restore_s"]),
                      "epochs": [e["epoch"] for e in resumed["epochs"]]}
    res["saves"] = list(saves)
    del resumed

    real = main.make_train_step
    calls = []

    def make(*a, **kw):
        step = real(*a, **kw)
        loss_fn = step.loss_fn

        def poisoned(batch, draws, text_embed=None):
            total, losses = loss_fn(batch, draws, text_embed)
            calls.append(len(calls))
            if d.rank == nan_rank and len(calls) == nan_at + 1:
                total = total * float("nan")
            return total, losses

        step.loss_fn = poisoned
        return step

    main.make_train_step = make
    try:
        main.train_loop(cfg(os.path.join(out_root, "c"), "--options", "epochs=1"))
        res["nan"] = {"raised": False, "calls": len(calls)}
    except FloatingPointError:
        res["nan"] = {"raised": True, "calls": len(calls)}
    finally:
        main.make_train_step = real
    return res
