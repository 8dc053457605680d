"""A training cell: steps of the port's train step, one in flight.

Set-up builds the detector, the bf16 teacher, AdamW and the train state with
the benchmark's weights, places the mix's pool of batches and of the steps'
random draws (CDN noise, the federated loss's uniforms) on the card, and
takes the first ``steps_checked`` steps through ``TrainStep.__call__`` (the
first warms up and captures the step's one graph, the others replay it),
keeping each step's loss, the first moment after the first step and the
parameters after the last. The window then drives the steps as
``train/main.py:train_loop`` does: the call (a graph replay), then a host
read of the previous step's ``finite``. After the window: the peak memory,
the traced run's measurements, the program freed, then the plain
reference's first steps from the same weights, batches and draws.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict, List

import torch

from benchmark.harness import compare, core, entries, profiling, program, roofline, traffic, weights
from benchmark.reference import detector
from benchmark.reference import train as ref_train

PROFILED_STEPS = 5
STEPS_PER_EPOCH = 1000  # the schedule's epoch, past any run's steps: the lr stays at its base


def make_draws(cfg, batch: int, seed: int, n: int, device) -> List[Dict[str, Any]]:
    """``n`` steps' random draws, from ``seed``: CDN's ``flip``, ``new_label``,
    ``sign``, ``part`` over its ``2 dn_number`` slots and the federated loss's
    ``fed_uniforms [16, C]``."""
    g = torch.Generator(device=device).manual_seed(weights.seed_of(seed, 5))
    pad, c = 2 * cfg.dn_number, cfg.num_classes
    out = []
    for _ in range(n):
        kw = dict(generator=g, device=device)
        out.append({"dn": {"flip": torch.rand((batch, pad), **kw),
                           "new_label": torch.randint(0, c, (batch, pad), **kw),
                           "sign": torch.randint(0, 2, (batch, pad, 4), **kw).float() * 2 - 1,
                           "part": torch.rand((batch, pad, 4), **kw)},
                    "fed_uniforms": torch.rand((16, c), **kw)})
    return out


def run(r: core.Run, t_start: float, fault=None) -> Dict[str, Any]:
    """One run of a training cell -> the runner's results (see ``benchmark/run.py``).
    ``fault`` (tests only) wraps the train step the run drives."""
    from richsem_tpu_torch.ops.lap import device_rounds
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.optim import build_optimizer, frozen_leaves

    dev = torch.device(r.device)
    on_card = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    prog = program.build(r.conf, r.seed, dev, with_teacher=True)
    cfg, model = prog.cfg, prog.model
    specs, tspecs = program.leaf_specs(model), program.teacher_specs(prog.teacher)
    state = create_train_state(model, build_optimizer(model, cfg, STEPS_PER_EPOCH),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=r.seed, device=dev, clip_model=prog.teacher)
    if fault is not None:
        step = fault(step)
    parts["model, teacher and weights"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = traffic.pool(r.mix, weights.seed_of(r.seed, 1), dev)
    draws = make_draws(cfg, r.mix["batch"], r.seed, len(batches), dev)
    parts["batches and draws"] = time.perf_counter() - t
    bs, n_check = r.mix["batch"], r.mix["steps_checked"]
    opt = state.optimizer

    losses, first_grad = [], None
    for i in range(n_check):  # the first steps: capture, then replays
        t = time.perf_counter()
        losses.append(float(step(state, batches[i], prog.text, draws[i])["loss"]))
        if i == 0:
            first_grad = {n: (m / (1 - opt.b1)).to("cpu", copy=True)
                          for (n, _), m in zip(opt.trainable, opt.mu)}
            parts["first step: eager step and capture"] = time.perf_counter() - t
    t = time.perf_counter()
    after = {n: p.detach().to("cpu", copy=True) for n, p in opt.trainable}
    if on_card:
        torch.cuda.synchronize(dev)
    parts["state copied out"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    rounds = device_rounds(dev) if on_card else None
    if rounds is not None:
        rounds.zero_()
    calls, failed, n, prev = [], 0, 0, None
    t0 = time.perf_counter()
    while True:
        i = (n_check + n) % len(batches)
        t = time.perf_counter()
        out = step(state, batches[i], prog.text, draws[i])
        calls.append((time.perf_counter() - t) * 1e3)
        if prev is not None:
            failed += int(not bool(prev["finite"]))
        prev, n = out, n + 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    failed += int(not bool(prev["finite"]))
    if on_card:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    r.window = {"calls": calls, "steps": n, "images": n * bs, "seconds": window_s}
    r.peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0
    r.matcher_rounds = float(rounds) / n if rounds is not None else None

    if r.trace:
        def drive(k):
            def go():
                last = None
                for j in range(k):
                    o = step(state, batches[j % len(batches)], prog.text, draws[j % len(batches)])
                    if last is not None:
                        bool(last["finite"])
                    last = o
                bool(last["finite"])
            return go

        def backbone_profile():
            img = batches[0]["images"].to(model.cfg.compute_dtype)
            bufs = [b for _, b in frozen_leaves(model.backbone)]
            g = torch.Generator(device=dev).manual_seed(weights.seed_of(r.seed, 6))

            def fwd_bwd():
                for b in bufs:
                    b.requires_grad_(True)
                try:
                    feats = model.backbone(img)
                    cot = [torch.randn(f.shape, generator=g, device=dev, dtype=f.dtype) for f in feats]
                    torch.autograd.backward(feats, cot)
                finally:
                    for b in bufs:
                        b.requires_grad_(False)
                        b.grad = None
                    model.zero_grad(set_to_none=True)
            return profiling.profile(fwd_bwd)

        def teacher_profile():
            from richsem_tpu_torch.models.clip_align import (clip_spatial_features,
                                                             clip_teacher_box_targets)
            b = batches[0]

            def targets():
                sp = clip_spatial_features(prog.teacher, b["images"])
                clip_teacher_box_targets(prog.teacher, b["images"], b["boxes"], b["size"].float(),
                                         prog.text, prog.teacher.logit_scale, valid=b["valid"],
                                         max_boxes=cfg.distill_max_boxes, spatial=sp)
            return profiling.profile(targets)

        def entry_calls():
            calls_: Dict[str, list] = {}
            with entries.recording(calls_):
                step.eager(state, batches[0], prog.text, draws[0])
            return calls_

        def adamw_share():
            if r.hook("entry_calls") is None:  # the eager step leaves its gradients
                return None
            n_all = sum(t.numel() for t in opt.leaves())
            n_train = sum(p.numel() for _, p in opt.trainable)
            bound = roofline.adamw_bound(n_all, n_train)
            prof = program.guarded_profile(lambda: [opt.update() for _ in range(entries.REPEATS)])
            return None if prof is None else 100.0 * bound / (prof.device_ms() / entries.REPEATS)

        def flops_per_call():
            return reference_flops(r.conf, specs, tspecs, r.mix)

        r.hooks.update(profile_window=lambda: program.guarded_profile(drive(PROFILED_STEPS)),
                       backbone_profile=backbone_profile, teacher_profile=teacher_profile,
                       entry_calls=entry_calls, adamw_share=adamw_share,
                       flops_per_call=flops_per_call)
    per_layer = core.per_layer(r) if r.trace else {}
    window_prof = r.hook("profile_window") if r.trace else None

    text = prog.text
    del step, state, opt, model, prog, r.hooks
    r.hooks, r._cache = {}, {}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check(r, specs, tspecs, batches[:n_check], draws[:n_check], text, losses,
                    first_grad, after)
    checks = compare.judge(numbers, core.load_json(f"benchmark/limits/{r.workload['name']}.json"))
    return {
        "setup_s": setup_s,
        "e2e": {"train_img_per_s": n * bs / window_s},
        "per_layer": per_layer, "window_profile": window_prof,
        "attempted": n, "failed": failed,
        "checks": checks, "correct": compare.passed(checks) and failed == 0,
        "numbers": numbers, "specs": specs, "tspecs": tspecs, "text": text,
        "setup_parts": parts,
    }


def reference_steps(r: core.Run, specs, tspecs, batches, draws, text, control=None):
    """The plain reference's first steps from the run's weights -> its losses,
    first clipped gradient and change of every trainable leaf, and the
    starting leaves."""
    P = program.detector_leaves(specs, r.seed, r.device)
    start = {n: t.clone() for n, t in P.items()}
    T = program.teacher_leaves(tspecs, r.seed, r.device)
    with detector.exact(), (control or contextlib.nullcontext)():
        ref = ref_train.steps(P, T, batches, draws, text, r.conf["config"])
    return ref, start


def check(r: core.Run, specs, tspecs, batches, draws, text, losses, first_grad, after
          ) -> Dict[str, float]:
    """The compared numbers of a run: the program's first steps against the
    plain reference's from the same weights, batches and draws."""
    ref, start = reference_steps(r, specs, tspecs, batches, draws, text)
    dev = r.device
    prog_grad = {n: first_grad[n].to(dev) for n in ref["grad"] if n in first_grad}
    prog_delta = {n: after[n].to(dev) - start[n] for n in ref["delta"] if n in after}
    if len(prog_grad) != len(ref["grad"]) or len(prog_delta) != len(ref["delta"]):
        return {}  # every limited number then reads as missing
    numbers = compare.train_numbers(losses, ref["losses"], prog_grad, ref["grad"], prog_delta,
                                    ref["delta"])
    numbers["worst_leaves"] = compare.worst_leaves(prog_grad, ref["grad"], 8)  # for calibrate.py
    return numbers


def control_numbers(r: core.Run, out: Dict[str, Any], control) -> Dict[str, float]:
    """The compared numbers of the control (the reference under ``control``,
    a lower precision) in the program's place, on the run's first steps."""
    dev = torch.device(r.device)
    batches = traffic.pool(r.mix, weights.seed_of(r.seed, 1), dev)[:r.mix["steps_checked"]]
    cfg = program.port_config(r.conf)
    draws = make_draws(cfg, r.mix["batch"], r.seed, len(batches), dev)
    ctl, start = reference_steps(r, out["specs"], out["tspecs"], batches, draws, out["text"],
                                 control)
    ref, _ = reference_steps(r, out["specs"], out["tspecs"], batches, draws, out["text"])
    return compare.train_numbers(ctl["losses"], ref["losses"], ctl["grad"], ref["grad"],
                                 ctl["delta"], ref["delta"])


def reference_flops(conf, specs, tspecs, mix) -> float:
    """FLOPs of one training step of the plain reference (the loss and the
    gradient of every leaf; the teacher's forward), counted on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    cfg = conf["config"]
    P = {n: torch.empty(s, device=meta, requires_grad=True) for n, s in specs}
    T = {n: torch.empty(s, device=meta) for n, s in tspecs}
    b, (h, w), g = mix["batch"], mix["canvas"], mix["gt"]["slots"]
    pad, c = 2 * cfg["dn_number"], cfg["num_classes"]
    batch = {"images": torch.empty(b, h, w, 3, device=meta),
             "pad_mask": torch.zeros(b, h, w, dtype=torch.bool, device=meta),
             "labels": torch.zeros(b, g, dtype=torch.long, device=meta),
             "boxes": torch.empty(b, g, 4, device=meta),
             "valid": torch.zeros(b, g, dtype=torch.bool, device=meta),
             "size": torch.empty(b, 2, device=meta)}
    draws = {"dn": {"flip": torch.empty(b, pad, device=meta),
                    "new_label": torch.zeros(b, pad, dtype=torch.long, device=meta),
                    "sign": torch.empty(b, pad, 4, device=meta),
                    "part": torch.empty(b, pad, 4, device=meta)},
             "fed_uniforms": torch.empty(16, c, device=meta)}

    def assign(cost, valid):  # the matching's own work is no product
        return torch.zeros(valid.shape, dtype=torch.long, device=meta)

    cd = conf["text_bank"]
    with FlopCounterMode(display=False) as fc:
        total, _ = ref_train.loss(P, T, batch, draws, torch.empty(*cd, device=meta), cfg, assign)
        torch.autograd.grad(total, list(P.values()), allow_unused=True)
    return float(fc.get_total_flops())


def fault_numbers(r: core.Run, out: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """The compared numbers of the faults a training cell can have, planted in
    the reference put in the program's place, on the run's first steps: half
    of the batch left out (the loss's mean over the rest), the loss altered
    where it is produced (by a half), and the state returned unchanged."""
    dev = torch.device(r.device)
    batches = traffic.pool(r.mix, weights.seed_of(r.seed, 1), dev)[:r.mix["steps_checked"]]
    cfg = program.port_config(r.conf)
    draws = make_draws(cfg, r.mix["batch"], r.seed, len(batches), dev)
    ref, start = reference_steps(r, out["specs"], out["tspecs"], batches, draws, out["text"])
    half = r.mix["batch"] // 2
    cut = [{k: v[:half] for k, v in b.items()} for b in batches]
    cut_draws = [dict(d, dn={k: v[:half] for k, v in d["dn"].items()}) for d in draws]
    part, _ = reference_steps(r, out["specs"], out["tspecs"], cut, cut_draws, out["text"])
    zero = {n: torch.zeros_like(v) for n, v in ref["delta"].items()}
    return {
        "half_batch": compare.train_numbers(part["losses"], ref["losses"], part["grad"],
                                            ref["grad"], part["delta"], ref["delta"]),
        "loss_altered": compare.train_numbers([1.5 * x for x in ref["losses"]], ref["losses"],
                                              ref["grad"], ref["grad"], ref["delta"], ref["delta"]),
        "unchanged": compare.train_numbers(ref["losses"], ref["losses"], zero, ref["grad"], zero,
                                           ref["delta"]),
    }
