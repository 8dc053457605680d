"""``idle_share.train``: % of a profiled stretch of consecutive window calls in which the card ran nothing."""

from benchmark.metrics import _common


def read(run):
    return _common.idle_share(run, "train")
