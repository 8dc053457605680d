"""The recording of the kernels' public entries accounts for every launch the
wrappers count: a kernel reached by a path the recording does not see fails
the run, instead of leaving its roofline share out of the result line."""

import pytest

from benchmark.harness import entries, program


def test_unrecorded_names_each_kernel_short_of_its_launches():
    calls = {"msda": [{}, {"grad": 1}], "tail": [{"grad": 1}]}
    assert entries.unrecorded(calls, {"K1": 2, "K1-bwd": 1, "K2": 1, "K2-bwd": 1}) == {}
    assert entries.unrecorded(calls, {"K1": 3, "K1-bwd": 2, "K2": 1, "K2-bwd": 0}) == {
        "K1": (3, 2), "K1-bwd": (2, 1)}
    assert entries.unrecorded({}, {"K2": 6}) == {"K2": (6, 0)}


@pytest.mark.parametrize("kernel", sorted(entries.COUNTED))
def test_recording_raises_on_a_launch_it_did_not_see(kernel):
    counter = program.launch_counters()[kernel]
    start = counter.launches
    try:
        with pytest.raises(entries.UnrecordedCalls, match=kernel):
            with entries.recording({}):
                counter.launches += 1
    finally:
        counter.launches = start
