"""``backbone.busy_ms.eval``: device busy ms of one profiled eager call of the backbone on a window batch."""

from benchmark.metrics import _common


def read(run):
    return _common.busy_ms(run, "eval", "backbone_profile")
