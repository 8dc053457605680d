"""The data-parallel dry run of the semantic branch
(``richsem_tpu_torch/tools/dryrun_ddp.py``, counterpart of
``__graft_entry__.py:dryrun_multichip``) with two gloo ranks on the CPU: the
CLIP-text classifier, visual distillation against a tiny teacher, CDN, the
federated loss and EMA, one step on each rank's image. Both ranks report the
same finite loss (the global one), a positive distillation term, and equal
parameters, EMA and moments."""

import torch

from richsem_tpu_torch.tools import dryrun_ddp

torch.set_num_threads(2)


def test_dryrun_ddp_two_ranks():
    r0, r1 = dryrun_ddp.dryrun(2, "cpu", timeout=240)
    assert (r0["rank"], r1["rank"], r0["world"], r0["backend"]) == (0, 1, 2, "gloo")
    assert r0["finite"] and r0["loss"] == r1["loss"] and r0["loss_distill"] > 0
    assert r0["replicas_equal"] and r0["digest"] == r1["digest"]
