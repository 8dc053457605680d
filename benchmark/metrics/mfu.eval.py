"""``mfu.eval``: the whole step's share of the card's bf16 dense peak, from the reference's FLOP count."""

from benchmark.metrics import _common


def read(run):
    return _common.mfu(run, "eval")
