"""``host_ms.train``: mean host ms of the step's call in the window, entry to return, no synchronise inside."""

from benchmark.metrics import _common


def read(run):
    return _common.host_ms(run, "train")
