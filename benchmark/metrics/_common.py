"""What the per-layer readers share. Each reader returns None where its cell
has nothing to read (another kind of cell, or a profile that recorded no
device time), and the metric is then left out of the result line."""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark.harness import entries, roofline


def host_ms(run, kind: str) -> Optional[float]:
    """Mean host ms of the step's call in the window, from entry to return."""
    if run.kind != kind or not run.window.get("calls"):
        return None
    return statistics.fmean(run.window["calls"])


def mfu(run, kind: str) -> Optional[float]:
    """% of the bf16 dense peak: the window's calls x the reference-counted
    FLOPs of one call, over the window's seconds."""
    if run.kind != kind:
        return None
    flops = run.hook("flops_per_call")
    if not flops:
        return None
    rate = flops * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / roofline.BF16_FLOPS


def busy_ms(run, kind: str, hook: str) -> Optional[float]:
    if run.kind != kind:
        return None
    prof = run.hook(hook)
    return None if prof is None else prof.busy_ms


def idle_share(run, kind: str) -> Optional[float]:
    if run.kind != kind:
        return None
    prof = run.hook("profile_window")
    return None if prof is None else 100.0 * prof.idle_share


def peak_gb(run, kind: str) -> Optional[float]:
    if run.kind != kind or not run.peak_bytes:
        return None
    return run.peak_bytes / 1e9


def share(run, kind: str, fn) -> Optional[float]:
    if run.kind != kind:
        return None
    calls = run.hook("entry_calls")
    return None if not calls else fn(calls)


SHARES = {"msda_fwd": entries.msda_fwd_share, "msda_bwd": entries.msda_bwd_share,
          "encoder_tail_fwd": entries.tail_fwd_share,
          "encoder_tail_bwd": entries.tail_bwd_share}
