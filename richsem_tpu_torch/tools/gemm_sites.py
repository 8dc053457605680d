"""Where the f32 CUDA-core GEMMs of the flagship's steps come from (ROADMAP F-P10).

    python -m richsem_tpu_torch.tools.gemm_sites            # on the card
    python -m richsem_tpu_torch.tools.gemm_sites --variant  # the semantic variant too

Profiles, with ``torch.profiler`` (``record_shapes``, ``with_stack``), one
eager train step of the flagship (``bench.py``'s config and batch: bf16, bs2 on
896 x 1344, the random bf16 RN50 teacher and the 1204 x 1024 text bank; after
one warm-up step) and one eager eval batch (``tools/bench_eval.py``'s), and
maps every f32 GEMM kernel on the CUDA cores (``sgemm`` or ``ffma`` in a GEMM
kernel's name, as ``chip_smoke.py:f32_gemms`` counts them) to the operation
that launched it, its input shapes and the first frames of ``richsem_tpu_torch``
on its Python stack. A backward kernel is mapped through its autograd node's
sequence number to the forward operation that recorded it. The steps are eager:
a CUDA graph's replay carries no stacks, and it runs the same kernels.

Prints one line per site (launches, device ms, operation, shapes, stack) and
the totals, the train step's and the eval batch's.
"""

from __future__ import annotations

import argparse
import collections
from typing import Callable, Dict, List, Optional, Tuple

import torch

PKG = "richsem_tpu_torch"


def is_f32_gemm(name: str) -> bool:
    return "gemm" in name.lower() and ("sgemm" in name or "ffma" in name)


def _chain(e) -> List:
    """``e`` and the events that enclose it, innermost first (the Python frames
    are events of their own when the profile records stacks)."""
    out = []
    while e is not None:
        out.append(e)
        e = e.cpu_parent
    return out


def _frames(chain, depth: int = 3) -> Tuple[str, ...]:
    """The first ``depth`` frames of the package on an event's chain (or on its
    recorded stack), each cut at the package's root."""
    names = [n for e in chain for n in (list(e.stack or ()) + [e.name])]
    out = []
    for fr in names:
        if PKG in fr and ".py(" in fr and "/tools/gemm_sites.py" not in fr:
            out.append(fr[fr.index(PKG):])
        if len(out) == depth:
            break
    return tuple(out)


def _backward_node(chain):
    """The autograd node an event runs under (``evaluate_function``), or None."""
    for e in chain:
        if e.name.startswith("autograd::engine::evaluate_function"):
            return e
    return None


def sites(events) -> Dict[tuple, List[float]]:
    """-> {(operation, shapes, frames, pass): [launches, device ms]} of the f32
    CUDA-core GEMM kernels among ``events`` (a profile's ``events()``)."""
    by_seq: Dict[int, Tuple[str, tuple]] = {}
    for e in events:
        if getattr(e, "sequence_nr", -1) >= 0 and e.name.startswith("aten::"):
            chain = _chain(e)
            if _backward_node(chain) is None:
                by_seq.setdefault(e.sequence_nr, (e.name, _frames(chain)))
    out: Dict[tuple, List[float]] = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        kernels = [k for k in getattr(e, "kernels", ()) if is_f32_gemm(k.name)]
        if not kernels:
            continue
        shapes = tuple(tuple(s) for s in (e.input_shapes or ()) if s)
        chain = _chain(e)
        node = _backward_node(chain)
        if node is None:
            frames, where = _frames(chain), "forward"
        else:  # the forward operation that recorded the node
            fwd, frames = by_seq.get(node.sequence_nr, ("?", ()))
            where = f"{node.name.split(': ')[-1]} (backward of {fwd})"
        rec = out[(e.name, shapes, frames, where)]
        rec[0] += len(kernels)
        rec[1] += sum(k.duration for k in kernels) / 1e3
    return out


def profile_sites(fn: Callable[[], object]) -> Dict[tuple, List[float]]:
    from torch.profiler import ProfilerActivity, profile

    kw = {}
    try:  # ops carry their Python stacks only in the profiler's verbose mode
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(verbose=True)
    except (AttributeError, TypeError):
        pass
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True, with_stack=True, **kw) as prof:
        fn()
        torch.cuda.synchronize()
    return sites(prof.events())


def report(what: str, found: Dict[tuple, List[float]]) -> Tuple[int, float]:
    n = sum(v[0] for v in found.values())
    ms = sum(v[1] for v in found.values())
    print(f"{what}: {n} f32 CUDA-core GEMM launches, {ms:.3f} ms, {len(found)} sites", flush=True)
    for (op, shapes, frames, where), (k, t) in sorted(found.items(), key=lambda kv: -kv[1][1]):
        print(f"  x{k:<4d} {t:8.3f} ms  {op} {where} {list(shapes)}", flush=True)
        for fr in frames:
            print(f"        {fr}", flush=True)
    return n, ms


def train_sites(overrides: Optional[dict] = None) -> Tuple[int, float]:
    from richsem_tpu_torch.bench import bench_config, build_train, draw_batch, text_dim, to_device

    dev = torch.device("cuda")
    cfg, bs, n_valid = bench_config(env={}, overrides=overrides)
    batch, text = draw_batch(bs, n_valid, cfg.num_classes, text_dim(cfg))
    batch, text = to_device(batch, dev), torch.from_numpy(text).to(dev)
    state, step, _ = build_train(cfg, dev)
    step.eager(state, batch, text)  # warm-up: cuBLAS, cuDNN, the kernels' builds
    torch.cuda.synchronize()
    return report("train step" + (f" {overrides}" if overrides else ""),
                  profile_sites(lambda: step.eager(state, batch, text)))


def eval_sites(overrides: Optional[dict] = None, teacher=None) -> Tuple[int, float]:
    from richsem_tpu_torch.bench import text_dim, to_device
    from richsem_tpu_torch.tools.bench_eval import build_eval, draw_batch, draw_text, eval_config
    from richsem_tpu_torch.train.engine import eval_forward

    dev = torch.device("cuda")
    cfg = eval_config(overrides)
    model, _ = build_eval(cfg, dev)
    batch = to_device(draw_batch(2), dev)
    text = torch.from_numpy(draw_text(cfg.num_classes, text_dim(cfg))).to(dev)

    def run():
        with torch.inference_mode():
            eval_forward(model, cfg, batch, text, clip_model=teacher)

    run()
    torch.cuda.synchronize()
    return report("eval batch" + (f" {overrides}" if overrides else ""), profile_sites(run))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variant", action="store_true",
                   help="also the semantic variant's heads (share_vl_proj, distill_aux_layers, "
                        "two_stage_cls, enc_cls_agn, use_clip_visual_query, OptMatcher)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sites profiles the card: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    train_sites()
    eval_sites()
    if args.variant:
        from richsem_tpu_torch.bench import bench_config
        from richsem_tpu_torch.models.build import build_clip_teacher

        over = dict(VARIANT_A)
        train_sites(over)
        cfg, _, _ = bench_config(env={}, overrides=over)
        teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(2))
        eval_sites(over, teacher)


# the semantic variant (chip_smoke.py phase 21)
VARIANT_A = dict(matcher_type="OptMatcher", two_stage_cls=True, distill_aux_layers=True,
                 use_clip_visual_query=True, share_vl_proj=True, enc_cls_agn=True,
                 check_pos_dn=True, nms_iou_threshold=0.7)


if __name__ == "__main__":
    main()
