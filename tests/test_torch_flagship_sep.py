"""Single flagship train steps with the separable decoder sampler and the
teacher's weak labels, held against the JAX package's ``make_train_step``.

The tiny recipe of ``tests/test_torch_flagship_train.py`` with
``dec_msda_impl="sep_pallas"`` (on the CPU the JAX model runs the sampler's
XLA form, which computes the same function in f32; the port runs the plain
version of K3) and ``use_imagenet_pusedo_labels``: one step on a batch with no
extra image, and one whose first image is an extra one, whose GT slots the
teacher rewrites to its weak labels. Both to 1e-5, as step 0 of the
trajectory.
"""

import numpy as np
import pytest

from richsem_tpu_torch.ops import ms_deform_attn_sep
from tests.test_torch_flagship_train import _batches, _check, _runs, _setup, _with_teacher_keys


@pytest.fixture(scope="module")
def setup():
    return _setup(dec_msda_impl="sep_pallas", use_imagenet_pusedo_labels=True)


@pytest.mark.parametrize("extra", [False, True], ids=["sep_pallas", "extra"])
def test_sep_pallas_and_weak_labels_track_jax(setup, extra):
    batch = _with_teacher_keys(_batches()[:1])[0]
    if extra:
        batch["is_extra"] = np.asarray([True, False])
    launches = ms_deform_attn_sep.ms_deform_attn_sep.launches
    ((ref, out),) = _runs(setup, [batch])
    _check(ref, out, 1e-5, "extra" if extra else "sep_pallas")
    assert ms_deform_attn_sep.ms_deform_attn_sep.launches == launches  # CPU: plain version
