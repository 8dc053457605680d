"""One data-parallel train step of the semantic branch across N processes
(counterpart of ``__graft_entry__.py:dryrun_multichip``).

A small flagship (``configs/richsem/richsem_4scale_lvis.py`` at its widths,
which the card's kernels take: hidden 256, 8 heads, FFN 2048; with 2+2
layers, 20 queries and 12 classes, f32 on the CPU and bf16 on the card): the
CLIP-text classifier, visual
distillation against a tiny random CLIP-RN teacher, CDN, the federated loss
and EMA, one step on each rank's image of a global batch of N images drawn
from a seed, through ``parallel/dist.py``: the host statistics, the rank's
rows of the draws and the gradient all-reduce. ``use_clip_visual_query`` is
on, as in JAX's dry run, and so are the teacher's weak labels
(``use_imagenet_pusedo_labels``): the first image of the global batch is an
extra one, whose labels and boxes the teacher rewrites on its rank, and the
step's statistics are those of the rewritten global batch
(``parallel/dist.py:reduce_stats_``, one more collective in the step). Each
rank reports its loss and a digest of its parameters, which must be finite
and equal on every rank.

On the CPU the ranks join over gloo; on the card over NCCL, one process a
card::

  python -m richsem_tpu_torch.tools.dryrun_ddp --device cpu --nproc 2
  python -m richsem_tpu_torch.tools.dryrun_ddp            # every card
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))), "configs", "richsem", "richsem_4scale_lvis.py")
TINY = dict(hidden_dim=256, nheads=8, enc_layers=2, dec_layers=2, dim_feedforward=2048,
            num_queries=20, num_classes=12, dn_labelbook_size=12, fed_num_sample_cats=4,
            clip_embed_dim=16, distill_max_boxes=4, use_ema=True, use_clip_visual_query=True,
            clip_spatial_dim=256, use_imagenet_pusedo_labels=True)
CANVAS, G = (64, 96), 6


def global_batch(n: int, num_classes: int, seed: int = 0) -> dict:
    """N images of one canvas drawn with numpy, 1..G valid boxes each."""
    rng = np.random.default_rng(seed)
    h, w = CANVAS
    counts = rng.integers(1, G + 1, n)
    boxes = np.concatenate([rng.uniform(0.3, 0.7, (n, G, 2)), rng.uniform(0.1, 0.4, (n, G, 2))],
                           -1)
    return {"images": rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32),
            "pad_mask": np.zeros((n, h, w), bool),
            "labels": rng.integers(1, num_classes, (n, G)).astype(np.int32),
            "boxes": boxes.astype(np.float32),
            "valid": np.arange(G)[None] < counts[:, None],
            "size": np.asarray([CANVAS] * n, np.float32),
            "is_extra": np.arange(n) == 0}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rank_step(device: str = "cuda", threads: int = 1) -> dict:
    """This rank's part: the group, the tiny flagship and its teacher, one step
    on the rank's image -> {rank, world, backend, loss, finite, digest,
    replicas_equal}."""
    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig
    from richsem_tpu_torch.parallel import dist as pdist
    from richsem_tpu_torch.train.engine import create_train_state, make_train_step
    from richsem_tpu_torch.train.main import place_batch
    from richsem_tpu_torch.train.optim import build_optimizer

    torch.set_num_threads(threads)
    d = pdist.init_distributed(device)
    dev = d.device(device)
    cfg = Config.fromfile(CONFIG)
    cfg.update(TINY, compute_dtype="bfloat16" if dev.type == "cuda" else "float32")
    teacher = CLIP(dataclasses.replace(
        CLIPConfig.rn50(), embed_dim=16, vision_layers=(1, 1, 1, 1), vision_width=8,
        vision_heads=4, image_resolution=64, vocab_size=64, transformer_width=16,
        transformer_heads=2, transformer_layers=1, context_length=8,
        dtype=torch.bfloat16 if dev.type == "cuda" else None), device=dev)
    teacher.init_weights(torch.Generator(device=dev).manual_seed(3))
    teacher.eval().requires_grad_(False)
    model, _, _ = build_model("richsem", cfg, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0))
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=10),
                               use_ema=True)
    pdist.broadcast_(d, [*model.parameters(), *model.buffers(), *state.ema.values()])
    step = make_train_step(model, cfg, seed=0, device=dev, clip_model=teacher, dist=d)
    full = global_batch(d.world, cfg.num_classes)
    mine = {k: v[d.rank:d.rank + 1] for k, v in full.items()}
    mine.update(pdist.step_stats(d, mine, cfg))
    batch = place_batch(mine, dev)
    batch["fed_weight"] = torch.from_numpy(
        np.random.default_rng(1).uniform(1.0, 4.0, cfg.num_classes).astype(np.float32)).to(dev)
    text = torch.from_numpy(
        np.random.default_rng(2).normal(size=(cfg.num_classes, 16)).astype(np.float32)).to(dev)
    metrics = step(state, batch, text)
    digest = _digest([*model.parameters(), *state.ema.values(), *state.optimizer.mu,
                      *state.optimizer.nu])
    digests = pdist.gather_to_lead(d, digest)
    equal = pdist.broadcast_object(d, None if digests is None else len(set(digests)) == 1)
    return {"rank": d.rank, "world": d.world, "backend": d.backend,
            "loss": float(metrics["loss"]), "finite": bool(metrics["finite"]),
            "loss_distill": float(metrics["loss_distill"]), "digest": digest,
            "replicas_equal": bool(equal), "stats_gathers": pdist.reduce_stats_.launches}


def dryrun(nproc: int, device: str = "cuda", timeout: float = 600.0) -> list:
    """``nproc`` ranks of :func:`rank_step` -> their reports; raises unless every
    rank's loss is finite and the replicas are equal."""
    from richsem_tpu_torch.parallel.dist import spawn

    reports = spawn(rank_step, nproc, (device,), timeout=timeout)
    if not all(r["finite"] and r["replicas_equal"] for r in reports):
        raise RuntimeError(f"the data-parallel dry run failed: {reports}")
    return reports


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", help="cuda (default; NCCL) or cpu (gloo)")
    p.add_argument("--nproc", type=int, default=None,
                   help="ranks (default: every card, or 2 on the CPU)")
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to run the ranks on the CPU")
    n = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 2)
    for r in dryrun(n, args.device, args.timeout):
        print(json.dumps(r))
    print(f"dryrun_ddp({n}, {args.device}): ok (semantic branch: language + distill + fed + "
          "EMA + use_clip_visual_query + weak labels)")


if __name__ == "__main__":
    main()
