"""Profiling: manual timers, trace capture, and a reader of one profiled call
(counterpart of ``richsem_tpu/utils/profiling.py``).

``TimeCounter`` and ``AverageMeter`` are the JAX package's timers (the
reference's ``util/time_counter.py``); ``trace(dir)`` wraps ``torch.profiler``
where the JAX package wraps ``jax.profiler``, and ``annotate`` names a region
with ``torch.profiler.record_function``.

:func:`profile_call` profiles one call on the card and reads what the card
did: its busy time, its operations, the idle share of the call's wall time,
and the count and device time of each hand-written kernel by name
(:data:`HAND_WRITTEN`). The benches and ``chip_smoke.py`` read profiles
through it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional, Tuple


class TimeCounter:
    """Accumulating named wall-clock timers (context-manager style)."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }

    def __str__(self) -> str:
        return "  ".join(f"{k}: {v*1000:.1f}ms" for k, v in self.summary().items())


class AverageMeter:
    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1) -> None:
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace into ``log_dir``, for TensorBoard or
    Perfetto (no-op if falsy)."""
    if not log_dir:
        yield
        return
    from torch.profiler import profile, tensorboard_trace_handler

    with profile(activities=_activities(), on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region in the trace (``record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield


# The __global__ functions of richsem_tpu_torch/csrc, as a profile names them
# (K2-bwd is three of them, K5 two; the probes' after the model's).
HAND_WRITTEN = ("msda_fwd_kernel", "msda_bwd_kernel", "encoder_tail_fwd_kernel",
                "row_pass_kernel", "dw_gemm_kernel", "colsum_kernel", "msda_sep_fwd_kernel",
                "msda_sep_bwd_kernel", "auction_kernel", "sumsq_kernel", "sumsq_finish_kernel",
                "adamw_kernel", "nms_kernel", "vpu_f32_kernel", "vpu_bf16_kernel",
                "mxu_kernel", "mxu_reduce_kernel", "grid_kernel", "repeat_f32_kernel",
                "repeat_bf16_kernel", "cell_kernel", "cell_reduce_kernel", "tile_kernel",
                "chain_kernel", "fma_kernel")


@dataclasses.dataclass
class DeviceProfile:
    """What the card did during one profiled call: ``ops`` holds, for each kind
    of device operation, its name, how many ran and their device ms."""

    wall_ms: float
    ops: List[Tuple[str, int, float]]
    lead_missed: int = 0  # lead-in spins the profile did not record (profile_call)

    @property
    def busy_ms(self) -> float:
        return sum(ms for _, _, ms in self.ops)

    @property
    def n_ops(self) -> int:
        return sum(n for _, n, _ in self.ops)

    @property
    def idle_share(self) -> float:
        """1 - busy / wall: the share of the call's wall time the card was idle."""
        return max(0.0, 1.0 - self.busy_ms / self.wall_ms)

    def kernels(self) -> Dict[str, Tuple[int, float]]:
        """Each hand-written kernel that ran: name -> (launches, device ms)."""
        out: Dict[str, Tuple[int, float]] = {}
        for key, n, ms in self.ops:
            for k in HAND_WRITTEN:
                if f"::{k}" in key:
                    c, t = out.get(k, (0, 0.0))
                    out[k] = (c + n, t + ms)
        return out

    def matching(self, sub: str) -> Optional[Tuple[int, float]]:
        """(count, device ms) of the operations whose names hold ``sub``; None
        if none ran."""
        hits = [(n, ms) for key, n, ms in self.ops if sub in key]
        if not hits:
            return None
        return sum(n for n, _ in hits), sum(ms for _, ms in hits)

    def summary(self, top: int = 12) -> List[str]:
        """The lines ``chip_smoke.py`` prints: busy, idle share, operations, the
        busiest ``top`` kinds, then every hand-written kernel."""
        lines = [f"  profile: device busy {self.busy_ms:.2f} ms of a {self.wall_ms:.2f} ms call "
                 f"(idle share {self.idle_share:.3f}), {self.n_ops} device operations; "
                 "top kernels:"]
        if self.lead_missed:
            lines[0] = lines[0].replace(
                "; top", f", {self.lead_missed} of the {LEAD_SPINS} lead-in spins unrecorded; top")
        for key, n, ms in sorted(self.ops, key=lambda o: -o[2])[:top]:
            lines.append(f"    {ms:9.3f} ms  x{n:<4d} {key[:90]}")
        mine = self.kernels()
        if mine:
            lines.append("    hand-written: " + "; ".join(
                f"{k} {ms:.3f} ms x{n}" for k, (n, ms) in mine.items()))
        return lines


LEAD_SPINS = 16  # short spin kernels that open a profile's window


def profile_call(fn: Callable[[], object]) -> Optional[DeviceProfile]:
    """Profile one call of ``fn`` on the card (``torch.profiler``, CUPTI) and
    synchronise at its end. -> its :class:`DeviceProfile`, or None when the
    profile recorded no device time (not measured). The window opens with
    ``LEAD_SPINS`` short ``torch.cuda._sleep`` kernels (``spin_kernel``), left
    out of every sum: a profile can miss the first few device operations after
    it starts (four of them in some processes); ``lead_missed`` counts the
    spins it missed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_SPINS):
            torch.cuda._sleep(1000)
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    ops = [(e.key, e.count, e.self_device_time_total / 1e3) for e in device
           if "spin_kernel" not in e.key]
    spins = sum(e.count for e in device if "spin_kernel" in e.key)
    return DeviceProfile(wall_ms, ops, LEAD_SPINS - spins) if ops else None
