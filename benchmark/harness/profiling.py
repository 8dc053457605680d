"""What the card did during a profiled stretch of work.

A frozen copy of the port's reader (``richsem_tpu_torch/utils/profiling.py``:
``profile_call`` and ``DeviceProfile``, and ``richsem_tpu_torch/bench.py``:
``guarded_profile``'s launch guard), so that a change to the program cannot
move the yardstick: the window opens with 16 short spin kernels, which a
profile may partly miss and which are left out of every sum; the host times
the call to a synchronise. Added here: the busy time as the union of the
device operations' intervals on the trace's timeline (a sum of their times
where the trace has no timeline), and the idle gaps named by what the host
was doing in them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

LEAD_SPINS = 16
RETAKES = 3
WINDOW = "benchmark.window"  # the host annotation around the profiled work
NAMED_GAPS = 200  # the longest idle gaps named by the host's operation


@dataclasses.dataclass
class Profile:
    wall_ms: float
    ops: List[Tuple[str, int, float]]  # (name, count, device ms), spins left out
    busy_ms: float
    gaps: List[Tuple[str, float]]  # (what the host did, idle ms), summed by name

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_ms / self.wall_ms)

    def count(self, kernel: str) -> int:
        return sum(n for k, n, _ in self.ops if kernel in k)

    def device_ms(self) -> float:
        """The sum of every operation's device time."""
        return sum(ms for _, _, ms in self.ops)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.ops, key=lambda o: -o[2])[:top]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:top]
        return {"device_ops": [[k, ms / 1e3] for k, _, ms in ops],
                "idle_gaps": [[k, ms / 1e3] for k, ms in gaps]}


def _is_device(e) -> bool:
    return str(getattr(e, "device_type", "")).endswith("CUDA")


def _union_and_gaps(events, t0_us: float, t1_us: float, skip):
    """-> (busy ms of the device intervals within [t0, t1], [(host op, idle ms)]);
    device events named in ``skip`` (annotations, spins) are left out."""
    dev = sorted((e.time_range.start, e.time_range.end) for e in events
                 if _is_device(e) and e.name not in skip and "spin_kernel" not in e.name
                 and e.time_range.end > t0_us and e.time_range.start < t1_us)
    busy, raw, cur = 0.0, [], t0_us
    merged = []
    for s, e in dev:
        s, e = max(s, t0_us), min(e, t1_us)
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for s, e in merged:
        busy += e - s
        if s > cur:
            raw.append((cur, s))
        cur = max(cur, e)
    if t1_us > cur:
        raw.append((cur, t1_us))
    # the longest gaps, named by the host's operation at their middle
    host = [e for e in events if not _is_device(e) and e.name != WINDOW]
    gaps = defaultdict(float)
    for s, e in sorted(raw, key=lambda g: g[0] - g[1])[:NAMED_GAPS]:
        gaps[_host_at(host, (s + e) / 2)] += (e - s) / 1e3
    return busy / 1e3, list(gaps.items())


def _host_at(host, t: float) -> str:
    """The innermost host operation running at time ``t`` (us)."""
    best = None
    for e in host:
        if e.time_range.start <= t <= e.time_range.end:
            if best is None or (e.time_range.end - e.time_range.start
                                < best.time_range.end - best.time_range.start):
                best = e
    return best.name if best is not None else "python"


def profile(fn: Callable[[], object]) -> Optional[Profile]:
    """Profile ``fn()`` on the card (``torch.profiler`` with CUPTI) and
    synchronise at its end. -> its :class:`Profile`, or None where the profile
    recorded no device time (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    if not torch.cuda.is_available():
        return None  # no card: not measured
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = list(prof.events())
    # a host annotation shows on the device's timeline too, under its own name
    skip = {e.name for e in events if not _is_device(e)} | {WINDOW}
    device = [e for e in prof.key_averages() if _is_device(e) and e.self_device_time_total > 0]
    ops = [(e.key, e.count, e.self_device_time_total / 1e3) for e in device
           if "spin_kernel" not in e.key and e.key not in skip]
    if not ops:
        return None
    marks = [e for e in events if e.name == WINDOW and not _is_device(e)]
    busy, gaps = sum(ms for _, _, ms in ops), []
    if marks:
        w = marks[0].time_range
        union, gaps = _union_and_gaps(events, w.start, w.end, skip)
        if union > 0:
            busy, wall_ms = union, (w.end - w.start) / 1e3
    return Profile(wall_ms, ops, busy, gaps)


def guarded(fn: Callable[[], object], kernels: Dict[str, str], counters: Dict[str, object],
            retakes: int = RETAKES) -> Profile:
    """:func:`profile` of ``fn`` whose count of each named kernel
    (``kernels``: counter name -> the ``__global__`` function a profile
    shows once a launch) equals the launches its wrapper counted meanwhile
    (``counters``); taken again up to ``retakes`` times when a profile lost
    operations, then raises."""
    for _ in range(retakes + 1):
        before = {k: counters[k].launches for k in kernels}
        prof = profile(fn)
        launched = {k: counters[k].launches - before[k] for k in kernels}
        if prof is not None and all(prof.count(kernels[k]) == n for k, n in launched.items()):
            return prof
    raise RuntimeError(f"the profile's kernel counts differ from the launches {launched} "
                       f"after {retakes} retakes")
