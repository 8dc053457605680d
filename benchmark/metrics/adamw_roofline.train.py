"""``adamw_roofline.train``: K5's and K6's bound over the device time of the optimizer's update, %."""

from benchmark.metrics import _common


def read(run):
    return run.hook("adamw_share") if run.kind == "train" else None
