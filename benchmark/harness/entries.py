"""The hand-written kernels' public entries, recorded in one eager step of the
program and profiled again on the step's own data, for the roofline shares.

A share is the sum of the bounds (``roofline.py``) of a family's calls over
the device time of every operation that its public entry launches for those
calls, whatever kernels implement it: K1 through
``ops/ms_deform_attn.py:ms_deform_attn`` and ``ms_deform_attn_backward``, K2
through ``ops/fused_ffn.py:encoder_tail`` and ``encoder_tail_backward``, K5
and K6 through ``ops/adamw.py:global_norm_clip`` and ``adamw_update`` (as
``train/optim.py:AdamW.update`` calls them).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import torch

from benchmark.harness import roofline

REPEATS = 3  # each recorded call profiled this many times, the device time averaged
# what the recording must hold for each kernel launch the wrappers count
COUNTED = {"K1": ("msda", False), "K1-bwd": ("msda", True),
           "K2": ("tail", False), "K2-bwd": ("tail", True)}


class UnrecordedCalls(RuntimeError):
    """The kernels ran more often than the recording saw their entries called."""


def unrecorded(calls: Dict[str, List[Any]], launched: Dict[str, int]) -> Dict[str, tuple]:
    """Kernel -> (launches, recorded calls) where a wrapper counted more
    launches than ``calls`` recorded: the program reached the kernel by a path
    the recording does not see, and its share would be missing or too high."""
    out = {}
    for kernel, (kind, grad) in COUNTED.items():
        seen = sum(1 for c in calls.get(kind, []) if not grad or "grad" in c)
        if launched.get(kernel, 0) > seen:
            out[kernel] = (launched[kernel], seen)
    return out


@contextlib.contextmanager
def recording(calls: Dict[str, List[Any]]):
    """While open, the detector's calls of the sampler and of the encoder tail
    are recorded into ``calls["msda"]`` and ``calls["tail"]``, with the
    gradient each output receives where a backward runs (``grad`` entries).
    On closing it raises :class:`UnrecordedCalls` where K1, K1-bwd, K2 or
    K2-bwd launched more often than their recorded calls account for."""
    import richsem_tpu_torch.models.dino as dino
    import richsem_tpu_torch.models.layers as layers

    from benchmark.harness import program

    counters = {k: c for k, c in program.launch_counters().items() if k in COUNTED}
    before = {k: c.launches for k, c in counters.items()}

    msda0, tail0 = layers.ms_deform_attn, dino.encoder_tail

    def keep(kind, args, out):
        rec = {"args": [a.detach() if torch.is_tensor(a) else a for a in args], "out": out.detach()}
        calls.setdefault(kind, []).append(rec)
        if out.requires_grad:
            out.register_hook(lambda g: rec.__setitem__("grad", g.detach()))

    def msda(*args):
        out = msda0(*args)
        keep("msda", args, out)
        return out

    def tail(*args):
        out = tail0(*args)
        keep("tail", args, out)
        return out

    layers.ms_deform_attn, dino.encoder_tail = msda, tail
    try:
        yield calls
    finally:
        layers.ms_deform_attn, dino.encoder_tail = msda0, tail0
    missed = unrecorded(calls, {k: c.launches - before[k] for k, c in counters.items()})
    if missed:
        raise UnrecordedCalls("launches the recording did not see (kernel: launches, recorded): "
                              + ", ".join(f"{k}: {v}" for k, v in missed.items()))


def _device_ms(fn: Callable[[], Any]) -> Optional[float]:
    """Device ms of one ``fn()``: every operation of ``REPEATS`` calls, from a
    profile whose kernel counts match the wrappers' launches (a profile that
    lost operations would read a share too high)."""
    from benchmark.harness import program

    prof = program.guarded_profile(lambda: [fn() for _ in range(REPEATS)])
    return None if prof is None else prof.device_ms() / REPEATS


def msda_fwd_share(calls) -> Optional[float]:
    from richsem_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    recs = calls.get("msda", [])
    if not recs:
        return None
    bound = sum(roofline.msda_fwd_bound(r["args"][0], r["args"][2], r["args"][3], r["out"])
                for r in recs)
    with torch.no_grad():
        ms = _device_ms(lambda: [ms_deform_attn(*r["args"]) for r in recs])
    return None if not ms else 100.0 * bound / ms


def msda_bwd_share(calls) -> Optional[float]:
    from richsem_tpu_torch.ops.ms_deform_attn import ms_deform_attn_backward

    recs = [r for r in calls.get("msda", []) if "grad" in r]
    if not recs:
        return None
    with torch.no_grad():
        outs = [ms_deform_attn_backward(*r["args"], r["grad"]) for r in recs]
        bound = sum(roofline.msda_bwd_bound(r["args"][0], r["args"][2], r["args"][3], r["grad"], o)
                    for r, o in zip(recs, outs))
        del outs
        ms = _device_ms(lambda: [ms_deform_attn_backward(*r["args"], r["grad"]) for r in recs])
    return None if not ms else 100.0 * bound / ms


def _tail_dims(rec):
    src, w1 = rec["args"][0], rec["args"][2]
    return src.shape[0], src.shape[1], w1.shape[0]


def tail_fwd_share(calls) -> Optional[float]:
    from richsem_tpu_torch.ops.fused_ffn import encoder_tail

    recs = calls.get("tail", [])
    if not recs:
        return None
    bound = sum(roofline.encoder_tail_fwd_bound(*_tail_dims(r), r["args"][0], r["args"][1],
                                                r["out"]) for r in recs)
    with torch.no_grad():
        ms = _device_ms(lambda: [encoder_tail(*r["args"]) for r in recs])
    return None if not ms else 100.0 * bound / ms


def tail_bwd_share(calls) -> Optional[float]:
    from richsem_tpu_torch.ops.fused_ffn import encoder_tail_backward

    recs = [r for r in calls.get("tail", []) if "grad" in r]
    if not recs:
        return None
    bound = sum(roofline.encoder_tail_bwd_bound(*_tail_dims(r), r["args"][0], r["args"][1],
                                                r["grad"]) for r in recs)
    with torch.no_grad():
        ms = _device_ms(lambda: [encoder_tail_backward(*r["args"], r["grad"]) for r in recs])
    return None if not ms else 100.0 * bound / ms
