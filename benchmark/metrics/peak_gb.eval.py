"""``peak_gb.eval``: the card's peak allocated GB over set-up and the window."""

from benchmark.metrics import _common


def read(run):
    return _common.peak_gb(run, "eval")
