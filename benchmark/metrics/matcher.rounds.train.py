"""``matcher.rounds.train``: auction rounds a step over the window, from K4's device counter."""

from benchmark.metrics import _common


def read(run):
    return run.matcher_rounds if run.kind == "train" else None
