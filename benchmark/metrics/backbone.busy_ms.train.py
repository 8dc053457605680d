"""``backbone.busy_ms.train``: device busy ms of one profiled eager call of the backbone on a window batch, forward and backward with a seeded cotangent."""

from benchmark.metrics import _common


def read(run):
    return _common.busy_ms(run, "train", "backbone_profile")
