"""The data-parallel dry run of the semantic branch
(``richsem_tpu_torch/tools/dryrun_ddp.py``, counterpart of
``__graft_entry__.py:dryrun_multichip``) with two gloo ranks on the CPU: the
CLIP-text classifier, visual distillation against a tiny teacher, CDN, the
federated loss, EMA, the visual queries and the teacher's weak labels on rank
0's image, one step on each rank's image. Both ranks report the same finite
loss (the global one), a positive distillation term, equal parameters, EMA
and moments, and one statistics collective each."""

import torch

from richsem_tpu_torch.tools import dryrun_ddp

torch.set_num_threads(2)


def test_dryrun_ddp_two_ranks():
    r0, r1 = dryrun_ddp.dryrun(2, "cpu", timeout=240)
    assert (r0["rank"], r1["rank"], r0["world"], r0["backend"]) == (0, 1, 2, "gloo")
    assert r0["finite"] and r0["loss"] == r1["loss"] and r0["loss_distill"] > 0
    assert r0["replicas_equal"] and r0["digest"] == r1["digest"]
    assert r0["stats_gathers"] == r1["stats_gathers"] == 1
