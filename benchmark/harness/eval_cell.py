"""A serving cell: batches through the port's eval step, closed loop.

Set-up builds the detector with the benchmark's weights, places the mix's
pool of batches on the card, and warms up and captures the cell's one graph
shape (``train/engine.py:EvalStep``). The window then serves the pool's
batches in turn, one at a time, each through ``EvalStep.__call__`` with its
``scores``, ``labels`` and ``boxes`` copied to the host, as
``train/main.py:evaluate`` reads them. A batch's latency runs from the call
to its outputs on the host. After the window: the peak memory, the traced
run's measurements, the program freed, then the check of a sample of the
served images against the plain reference.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Any, Dict

import numpy as np
import torch

from benchmark.harness import compare, core, entries, profiling, program, traffic, weights
from benchmark.reference import detector

OUT_KEYS = ("scores", "labels", "boxes")
WARM_REPLAYS = 3
PROFILED_BATCHES = 10
# the reference decodes this many times num_queries proposals to explain each
# served detection: rounding moved the program's 900 to reference ranks up to ~1,260
CANDIDATES = 2


def run(r: core.Run, t_start: float, fault=None) -> Dict[str, Any]:
    """One run of an eval cell -> the runner's results (see ``benchmark/run.py``).
    ``fault`` (tests only) replaces each served batch's host outputs."""
    from richsem_tpu_torch.train.engine import eval_forward, make_eval_step

    dev = torch.device(r.device)
    on_card = dev.type == "cuda"
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    prog = program.build(r.conf, r.seed, dev)
    specs = program.leaf_specs(prog.model)
    step = make_eval_step(prog.model, prog.cfg)
    parts["model and weights"] = time.perf_counter() - t
    t = time.perf_counter()
    batches = traffic.pool(r.mix, weights.seed_of(r.seed, 1), dev)
    parts["batches"] = time.perf_counter() - t
    bs = r.mix["batch"]

    def serve(i: int):
        out = step(batches[i], prog.text)
        t_ret = time.perf_counter()
        host = {k: out[k].cpu() for k in OUT_KEYS}
        return host, t_ret

    t = time.perf_counter()
    serve(0)  # the warm-up and the capture
    parts["warm-up and capture"] = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(WARM_REPLAYS):
        serve(0)
    if on_card:
        torch.cuda.synchronize(dev)
    parts["replays"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    lat, calls, served, failed, n = [], [], {}, 0, 0
    t0 = time.perf_counter()
    while True:
        i = n % len(batches)
        t = time.perf_counter()
        host, t_ret = serve(i)
        if fault is not None:
            host = fault(host, batches[i])
        t_end = time.perf_counter()
        lat.append((t_end - t) * 1e3)
        calls.append((t_ret - t) * 1e3)
        failed += int((~torch.isfinite(host["scores"]).all(1)).sum())
        served.setdefault(i, host)
        n += 1
        if t_end - t0 >= r.seconds:
            break
    window_s = time.perf_counter() - t0
    r.window = {"calls": calls, "steps": n, "images": n * bs, "seconds": window_s}
    r.peak_bytes = torch.cuda.max_memory_allocated(dev) if on_card else 0

    if r.trace:
        def profile_window():
            k = [0]

            def go():
                for _ in range(PROFILED_BATCHES):
                    serve(k[0] % len(batches))
                    k[0] += 1
            return program.guarded_profile(go)

        def backbone_profile():
            with torch.inference_mode():
                img = batches[0]["images"].to(prog.model.cfg.compute_dtype)
                return profiling.profile(lambda: prog.model.backbone(img))

        def entry_calls():
            calls_: Dict[str, list] = {}
            with entries.recording(calls_), torch.inference_mode():
                eval_forward(prog.model, prog.cfg, batches[0], prog.text)
            return calls_

        def flops_per_call():
            return reference_flops(r.conf, specs, r.mix)

        r.hooks.update(profile_window=profile_window, backbone_profile=backbone_profile,
                       entry_calls=entry_calls, flops_per_call=flops_per_call)
    per_layer = core.per_layer(r) if r.trace else {}
    window_prof = r.hook("profile_window") if r.trace else None

    del step, prog.model, r.hooks
    r.hooks, r._cache = {}, {}
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check(r, specs, batches, served, prog.text)
    limits = core.load_json(f"benchmark/limits/{r.workload['name']}.json")
    checks = compare.judge(numbers, limits)
    return {
        "setup_s": setup_s,
        "e2e": {"eval_img_per_s": n * bs / window_s,
                "eval_batch_ms_p95": core.quantile(lat, 95)},
        "per_layer": per_layer,
        "window_profile": window_prof,
        "attempted": n * bs, "failed": failed,
        "checks": checks, "correct": compare.passed(checks) and failed == 0,
        "numbers": numbers, "specs": specs, "text": prog.text, "setup_parts": parts,
    }


def sample(r: core.Run, served: Dict[int, Any]):
    """The images the check compares: ``check_images`` of those served in the
    window, drawn from the seed -> [(batch, image)]."""
    rng = np.random.default_rng([r.seed, 3])
    pairs = [(i, k) for i in sorted(served) for k in range(r.mix["batch"])]
    pick = rng.choice(len(pairs), size=min(r.mix["check_images"], len(pairs)), replace=False)
    return [pairs[j] for j in sorted(pick)]


def reference_outputs(conf, P, batch, k: int, text, control=None, explain: bool = False):
    """The plain reference's eval outputs of image ``k`` of ``batch``: its
    top-K ``scores``, ``labels`` and ``boxes``, and with ``explain`` (never
    under ``control``, a context that computes it in a lower precision) the
    candidate queries' class scores and normalised cx, cy, w, h boxes
    (``cand_scores``, ``cand_boxes``): the decoder over the ``CANDIDATES``
    times ``num_queries`` best proposals."""
    cfg = conf["config"]
    cands = CANDIDATES * cfg["num_queries"] if explain and not control else 0
    with detector.exact(), torch.no_grad(), (control or contextlib.nullcontext)():
        out = detector.detector(P, cfg, batch["images"][k:k + 1], batch["pad_mask"][k:k + 1], text,
                                candidates=cands)
        logits, boxes = out["pred_logits"][-1], out["pred_boxes"][-1]
        top = detector.postprocess(logits, boxes, batch["orig_size"][k:k + 1], cfg["num_select"])
    res = {key: top[key][0].cpu() for key in OUT_KEYS}
    if cands:
        res.update(cand_scores=torch.sigmoid(out["cand_logits"][0]).cpu(),
                   cand_boxes=out["cand_boxes"][0].cpu())
    return res


def check(r: core.Run, specs, batches, served, text, control=None) -> Dict[str, float]:
    """The compared numbers of a run: the program's served outputs of the
    sampled images against the plain reference's (or, with ``control``,
    the reference's in a lower precision in the program's place).
    ``entry_gap`` is worked out where the cell's limits compare it."""
    P = program.detector_leaves(specs, r.seed, r.device)
    explain = "entry_gap" in core.load_json(f"benchmark/limits/{r.workload['name']}.json")
    prog_out, ref_out, sizes = [], [], []
    for i, k in sample(r, served):
        ref = reference_outputs(r.conf, P, batches[i], k, text, explain=explain)
        if control is None:
            mine = {key: served[i][key][k] for key in OUT_KEYS}
        else:
            mine = reference_outputs(r.conf, P, batches[i], k, text, control)
        prog_out.append(mine)
        ref_out.append(ref)
        sizes.append(batches[i]["orig_size"][k].cpu())
    return compare.eval_numbers(prog_out, ref_out, sizes)


def reference_flops(conf, specs, mix) -> float:
    """FLOPs of one batch of the mix through the plain reference's forward,
    counted on the meta device by ``torch.utils.flop_counter``."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = torch.device("meta")
    P = {n: torch.empty(s, device=meta) for n, s in specs}
    b, (h, w) = mix["batch"], mix["canvas"]
    batch = {"images": torch.empty(b, h, w, 3, device=meta),
             "pad_mask": torch.zeros(b, h, w, dtype=torch.bool, device=meta),
             "orig_size": torch.empty(b, 2, device=meta)}
    c, d = conf["text_bank"]
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        detector.eval_forward(P, conf["config"], batch, torch.empty(c, d, device=meta))
    return float(fc.get_total_flops())


def control_numbers(r: core.Run, out: Dict[str, Any], control) -> Dict[str, float]:
    """The compared numbers of the control (``control``, a context under which
    the reference computes in a lower precision) in the program's place, on
    the run's sampled images (``out``: the run's results)."""
    batches = traffic.pool(r.mix, weights.seed_of(r.seed, 1), r.device)
    served = {i: None for i in range(len(batches))}
    return check(r, out["specs"], batches, served, out["text"], control)
