"""Seeded weights, made on the device in one large draw.

Every leaf the benchmark feeds (the detector's parameters and frozen buffers,
the teacher's visual tower) comes from one ``torch.randn`` over all of them,
drawn by a ``torch.Generator`` on the device seeded with the run's seed, then
cut into leaves in the order of their names and scaled by :func:`scale`. The
same seed gives the same leaves, which both the program and the plain
reference read, by name.

The decoder's content queries (``tgt_embed``) are one drawn row repeated.
The two-stage selection hands query ``r`` to the proposal of rank ``r``, and
between bfloat16 and float32 near-equal proposal scores trade ranks (over 95%
of the 900 at random weights): with distinct rows each served detection would
come from a query that the reference never forms. With equal rows a
proposal's query is the same whatever its rank, so the reference can explain
every served detection (``harness/compare.py``). The rows still train apart.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

# the scalar CLIP temperature, log(1 / 0.07), as CLIP initialises it
LOGIT_SCALE = math.log(1 / 0.07)


def scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """-> (mean, std) of a leaf: weights of 2 or more dimensions N(0, 1/fan_in);
    a norm's or frozen batch-norm's scale 1 + N(0, 0.1^2) and running variance
    1 + |N(0, 0.1^2)| (taken as the absolute value by :func:`make`); biases,
    shifts and running means N(0, 0.1^2); the deformable sampler's offset bias
    N(0, 2^2) pixels; Swin's relative position bias N(0, 0.02^2)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.endswith("logit_scale"):
        return LOGIT_SCALE, 0.0
    if name.endswith("sampling_offsets.bias"):
        return 0.0, 2.0
    if name.endswith("rel_pos_bias"):
        return 0.0, 0.02
    if leaf == "running_var":
        return 1.0, 0.1
    if len(shape) >= 2:
        fan_in = math.prod(shape[1:])
        if name.endswith(("level_embed", "tgt_embed", "positional_embedding")):
            fan_in = shape[-1]
        return 0.0, 1.0 / math.sqrt(fan_in)
    if leaf == "weight":  # norms and frozen batch-norms
        return 1.0, 0.1
    return 0.0, 0.1


def make(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """``specs`` (name, shape) -> {name: float32 tensor on ``device``} from
    ``seed``: one draw, cut in name order."""
    specs = sorted((n, tuple(s)) for n, s in specs)
    total = sum(math.prod(s) for _, s in specs)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    out, o = {}, 0
    for name, shape in specs:
        n = math.prod(shape)
        mean, std = scale(name, shape)
        t = flat[o:o + n].view(shape)
        if name.endswith("running_var"):
            t = t.abs()
        if name.endswith("tgt_embed"):
            t = t[:1].expand(shape)
        out[name] = t * std + mean
        o += n
    return out


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one of the run's streams (weights, traffic,
    text bank, draws, the check's sample), within 63 bits for any run seed."""
    return (seed * 1_000_003 + stream * 7_919) % (2 ** 63 - 1)
