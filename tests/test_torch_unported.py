"""What the port refuses as JAX refuses it: a backbone name the variant
tables do not hold raises JAX's errors, and ``two_stage_cls`` is kept only
beside the distillation branch, as in JAX.

The semantic-branch knobs, the gelu tail and NMS are ported
(``tests/test_torch_variants.py``, ``tests/test_torch_nms.py``), and so are
the CLIP ViT tower (``tests/test_torch_clip_vit.py``) and the teacher's weak
labels under data parallelism (``tests/test_torch_weak_labels_ddp.py``).
"""

import pytest

from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models.dino import DINO, DINOConfig

FLAGSHIP = "configs/richsem/richsem_4scale_lvis.py"


def _flagship(**overrides):
    cfg = Config.fromfile(FLAGSHIP)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


@pytest.mark.parametrize("distill", [False, True])
def test_two_stage_cls_gating_matches_jax(distill):
    """from_config keeps two_stage_cls only beside the distillation branch, as
    the JAX DINOConfig does; the shipped recipe has it off."""
    overrides = dict(two_stage_cls=True, use_visual_distill=distill)
    out = DINOConfig.from_config(_flagship(**overrides))
    jax_cfg = JaxConfig.fromfile(FLAGSHIP)
    for k, v in overrides.items():
        setattr(jax_cfg, k, v)
    assert out.two_stage_cls == JaxDINOConfig.from_config(jax_cfg).two_stage_cls == distill
    assert DINOConfig.from_config(Config.fromfile(FLAGSHIP)).two_stage_cls is False


@pytest.mark.parametrize("name,error", [
    ("swin_X_224_1k", KeyError), ("convnext_huge", KeyError), ("focalnet_M_384_22k", KeyError),
    ("vit_base", NotImplementedError)])
def test_unknown_backbone_raises_as_jax(name, error):
    """A name of a ported family that its variant table lacks raises the
    table's ``KeyError``; any other name ``NotImplementedError``, in both
    packages."""
    import jax
    import jax.numpy as jnp

    from richsem_tpu.models.dino import DINO as JaxDINO

    with pytest.raises(error):
        DINO(DINOConfig(backbone=name), device="cpu")
    with pytest.raises(error):
        JaxDINO(JaxDINOConfig(backbone=name)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), bool))
