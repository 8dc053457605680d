"""``msda_fwd_roofline.eval``: K1's calls' bounds over the device time of their public entry, %."""

from benchmark.metrics import _common


def read(run):
    return _common.share(run, "eval", _common.SHARES["msda_fwd"])
