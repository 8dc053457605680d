"""``encoder_tail_bwd_roofline.train``: K2-bwd's calls' bounds over the device time of their public entry, %."""

from benchmark.metrics import _common


def read(run):
    return _common.share(run, "train", _common.SHARES["encoder_tail_bwd"])
