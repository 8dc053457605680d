"""``teacher.busy_ms.train``: device busy ms of the distillation targets for one window batch, profiled alone."""

from benchmark.metrics import _common


def read(run):
    return _common.busy_ms(run, "train", "teacher_profile")
