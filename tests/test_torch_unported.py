"""The port refuses what it has not ported, and names the ROADMAP item that
holds it: the CLIP teacher's ViT tower (queue 1, item 11) and the teacher's
weak labels under data parallelism (item 11). A backbone name the variant
tables do not hold raises JAX's errors.

``two_stage_cls`` is kept only beside the distillation branch, as in JAX; the
semantic-branch knobs, the gelu tail and NMS are ported
(``tests/test_torch_variants.py``, ``tests/test_torch_nms.py``).
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


def _clip_vit_teacher():
    from richsem_tpu_torch.models.build import build_clip_teacher

    build_clip_teacher(_flagship(clip_model="ViT-B/32"), device="cpu")


@pytest.mark.parametrize("what,call", [
    ("backbone", _clip_vit_teacher),
], ids=["backbone"])
def test_unported_messages_name_item_11(what, call):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item 11\)"):
        call()


def test_weak_labels_under_data_parallelism_name_item_11():
    """The teacher's weak labels rewrite extra images' boxes on the card, so
    the host's global statistics cannot hold them: a data-parallel step with
    them refuses, naming the item."""
    from richsem_tpu_torch.train.engine import make_loss_fn

    cfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
    cfg.update(use_imagenet_pusedo_labels=True)
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item 11\)"):
        make_loss_fn(None, cfg, clip_model=object(), world_size=2)
    make_loss_fn(None, cfg, clip_model=object(), world_size=1)


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
