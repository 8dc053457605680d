"""The port's profiling module (``richsem_tpu_torch/utils/profiling.py``) and
the benches' launch guard, on the CPU.

* ``TimeCounter`` and ``AverageMeter`` against ``richsem_tpu.utils.profiling``,
  with ``time.perf_counter`` patched on both sides to the same clock.
* ``trace`` writes a ``torch.profiler`` trace into its directory (a no-op
  without one); ``annotate`` names a region in it.
* The reader of a profiled call (``DeviceProfile``): busy ms, operations, idle
  share, the hand-written kernels by name (every instantiation summed, K3's
  names not taken for K1's), ``matching`` and the printed summary.
* ``richsem_tpu_torch/bench.py:guarded_profile`` on a stubbed
  ``profile_call``: it accepts a profile whose kernel counts equal the
  wrappers' launches in that call, takes the profile again when they differ
  (or nothing was recorded) and reports the retakes, and raises after three
  retakes that still differ.
"""

import itertools
import os

import pytest

import richsem_tpu.utils.profiling as jax_profiling
from richsem_tpu_torch import bench
from richsem_tpu_torch.utils import profiling
from richsem_tpu_torch.utils.profiling import DeviceProfile


def _clock(monkeypatch, module):
    ticks = itertools.count()
    monkeypatch.setattr(module.time, "perf_counter", lambda: 0.25 * next(ticks))


def test_timers_match_jax(monkeypatch):
    out = []
    for module in (jax_profiling, profiling):
        _clock(monkeypatch, module)
        tc, meter = module.TimeCounter(), module.AverageMeter()
        for name in ("load", "step", "load", "step", "step"):
            with tc(name):
                pass
        with pytest.raises(ValueError):
            with tc("fails"):
                raise ValueError
        for v, n in ((1.5, 2), (3.0, 1), (0.5, 4)):
            meter.update(v, n)
        out.append((dict(tc.totals), dict(tc.counts), tc.summary(), str(tc), meter.sum,
                    meter.count, meter.avg, module.AverageMeter().avg))
    assert out[0] == out[1]
    assert out[1][1] == {"load": 2, "step": 3, "fails": 1}


def test_trace_and_annotate_write_a_trace(tmp_path):
    import torch

    with profiling.trace(None):  # no directory: nothing is captured
        pass
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("bench_region"):
            torch.ones(8).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    assert "bench_region" in open(os.path.join(tmp_path, files[0])).read()


OPS = [("void (anonymous namespace)::msda_fwd_kernel<__nv_bfloat16>(...)", 10, 1.5),
       ("void (anonymous namespace)::msda_fwd_kernel<float>(...)", 2, 0.5),
       ("void (anonymous namespace)::msda_sep_fwd_kernel<__nv_bfloat16>(...)", 6, 0.3),
       ("void (anonymous namespace)::row_pass_kernel(...)", 6, 6.0),
       ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_ffma_kernel", 13, 4.5),
       ("void at::native::elementwise_kernel<...>", 100, 2.2)]


def test_device_profile_reads_busy_idle_and_kernels():
    prof = DeviceProfile(wall_ms=60.0, ops=OPS)
    assert prof.busy_ms == pytest.approx(15.0)
    assert prof.n_ops == 137
    assert prof.idle_share == pytest.approx(0.75)
    assert DeviceProfile(wall_ms=10.0, ops=OPS).idle_share == 0.0  # busy past the wall
    assert prof.kernels() == {"msda_fwd_kernel": (12, 2.0), "msda_sep_fwd_kernel": (6, 0.3),
                              "row_pass_kernel": (6, 6.0)}
    assert prof.matching("ffma") == (13, 4.5)
    assert prof.matching("no_such_kernel") is None
    lines = prof.summary(top=2)
    assert lines[0].startswith("  profile: device busy 15.00 ms of a 60.00 ms call "
                               "(idle share 0.750), 137 device operations")
    assert "row_pass_kernel" in lines[1] and "ffma" in lines[2] and len(lines) == 4
    assert lines[3].startswith("    hand-written: msda_fwd_kernel 2.000 ms x12")


def _fake_step(launch):
    """A 'step' that launches K1 twice and K2 once through the wrappers' counters."""
    counters = bench.launch_counters()

    def step():
        counters["K1"].launches += launch[0]
        counters["K2"].launches += launch[1]
    return step


def _profiles(monkeypatch, counts):
    """profile_call stubbed to run the call and return profiles whose K1 and K2
    counts are ``counts`` in turn (None: nothing recorded)."""
    seq = iter(counts)
    calls = []
    for wrapper in bench.launch_counters().values():  # restored after the test
        monkeypatch.setattr(wrapper, "launches", wrapper.launches)

    def fake(fn):
        fn()
        calls.append(1)
        c = next(seq)
        if c is None:
            return None
        return DeviceProfile(10.0, [("void ns::msda_fwd_kernel<float>(...)", c[0], 1.0),
                                    ("void ns::encoder_tail_fwd_kernel<0>(...)", c[1], 1.0)])
    monkeypatch.setattr(profiling, "profile_call", fake)
    return calls


def test_launch_guard_accepts_matching_counts(monkeypatch):
    calls = _profiles(monkeypatch, [(2, 1)])
    prof, retakes = bench.guarded_profile(_fake_step((2, 1)), log=lambda s: None)
    assert retakes == 0 and len(calls) == 1 and prof.n_ops == 3


def test_launch_guard_retakes_a_profile_that_lost_operations(monkeypatch):
    calls = _profiles(monkeypatch, [(1, 1), None, (2, 1)])
    logged = []
    prof, retakes = bench.guarded_profile(_fake_step((2, 1)), log=logged.append)
    assert retakes == 2 and len(calls) == 3 and len(logged) == 2
    assert "attempt 1 of 4" in logged[0]


def test_launch_guard_fails_after_three_retakes(monkeypatch):
    calls = _profiles(monkeypatch, [(2, 0)] * 5)
    with pytest.raises(bench.LaunchGuardError, match="after 3 retakes"):
        bench.guarded_profile(_fake_step((2, 1)), log=lambda s: None)
    assert len(calls) == 4
