"""The port imports neither JAX, flax nor the JAX package.

In a fresh interpreter where ``import jax``, ``import flax`` and
``import richsem_tpu`` all fail, every module of the port imports, the tiny
model builds on the CPU, serves one batch and takes one training step (CDN,
matching, the federated loss, the clipped AdamW), then one flagship step with
a tiny CLIP teacher (RoIAlign, the distillation losses) and the separable
decoder sampler, and the six kernels' launch counters stay at 0 (CPU tensors
run the plain versions).
"""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "richsem_tpu_torch",
    "richsem_tpu_torch.config.config",
    "richsem_tpu_torch.utils.boxes",
    "richsem_tpu_torch.utils.misc",
    "richsem_tpu_torch.utils.convert",
    "richsem_tpu_torch.ops._build",
    "richsem_tpu_torch.ops.position_encoding",
    "richsem_tpu_torch.ops.ms_deform_attn",
    "richsem_tpu_torch.ops.fused_ffn",
    "richsem_tpu_torch.ops.ms_deform_attn_sep",
    "richsem_tpu_torch.ops.roi_align",
    "richsem_tpu_torch.models.transformer_utils",
    "richsem_tpu_torch.models.layers",
    "richsem_tpu_torch.models.resnet",
    "richsem_tpu_torch.models.dino",
    "richsem_tpu_torch.models.postprocess",
    "richsem_tpu_torch.models.registry",
    "richsem_tpu_torch.models.build",
    "richsem_tpu_torch.models.dn",
    "richsem_tpu_torch.models.matcher",
    "richsem_tpu_torch.models.criterion",
    "richsem_tpu_torch.models.clip",
    "richsem_tpu_torch.models.clip.model",
    "richsem_tpu_torch.models.clip.tokenizer",
    "richsem_tpu_torch.models.clip_align",
    "richsem_tpu_torch.ops.lap",
    "richsem_tpu_torch.train.optim",
    "richsem_tpu_torch.train.engine",
]

SCRIPT = """
import importlib, sys
for name in ("jax", "flax", "richsem_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import torch
torch.set_num_threads(2)
for name in MODULES:
    importlib.import_module(name)
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.ops import fused_ffn, ms_deform_attn
from richsem_tpu_torch.train.engine import make_eval_step

cfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
cfg.update(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
           num_queries=20, num_classes=12, clip_embed_dim=64, num_select=50,
           compute_dtype="float32")
model, _, _ = build_model("richsem", cfg, device="cpu", generator=torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
batch = {"images": torch.rand((2, 128, 192, 3), generator=g) * 2 - 1,
         "pad_mask": torch.zeros(2, 128, 192, dtype=torch.bool),
         "orig_size": torch.tensor([[128, 192], [128, 192]])}
out = make_eval_step(model, cfg)(batch, torch.randn((12, 64), generator=g))
assert out["scores"].shape == (2, 50) and out["boxes"].shape == (2, 50, 4)
assert torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()

from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import build_optimizer

tcfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
tcfg.update(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
            num_queries=20, num_classes=12, dn_labelbook_size=12, fed_num_sample_cats=4,
            compute_dtype="float32")
model, weight_dict, _ = build_model("richsem", tcfg, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
assert weight_dict["loss_ce_dn_0"] == 1.0 and weight_dict["loss_bbox_interm"] == 5.0
state = create_train_state(model, build_optimizer(model, tcfg))
step = make_train_step(model, tcfg, seed=0, device="cpu")
tb = dict(batch, labels=torch.tensor([[1, 2, 3], [4, 5, 0]]),
          boxes=torch.tensor([[[0.5, 0.5, 0.2, 0.3]] * 3] * 2),
          valid=torch.tensor([[True, True, True], [True, True, False]]))
m = step(state, tb)
assert state.step == 1 and bool(m["finite"]) and float(m["grad_norm"]) > 0

import dataclasses
from richsem_tpu_torch.models.clip.model import CLIP, CLIPConfig
from richsem_tpu_torch.ops import ms_deform_attn_sep

fcfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
fcfg.update(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
            num_queries=20, num_classes=12, dn_labelbook_size=12, fed_num_sample_cats=4,
            clip_embed_dim=16, distill_max_boxes=2, dec_msda_impl="sep_pallas",
            compute_dtype="float32")
teacher = CLIP(dataclasses.replace(CLIPConfig.rn50(), embed_dim=16, vision_layers=(1, 1, 1, 1),
                                   vision_width=8, vision_heads=4, image_resolution=64,
                                   vocab_size=64, transformer_width=16, transformer_heads=2,
                                   transformer_layers=1, context_length=8), device="cpu")
teacher.init_weights(torch.Generator().manual_seed(3))
teacher.eval().requires_grad_(False)
model, _, _ = build_model("richsem", fcfg, device="cpu", generator=torch.Generator().manual_seed(0))
state = create_train_state(model, build_optimizer(model, fcfg))
step = make_train_step(model, fcfg, seed=0, device="cpu", clip_model=teacher)
m = step(state, dict(tb, size=torch.tensor([[128, 192], [100, 150]])),
         torch.randn((12, 16), generator=g))
assert bool(m["finite"]) and float(m["loss_distill"]) > 0 and float(m["loss_distill_dn"]) > 0
for name in (ms_deform_attn.ms_deform_attn, ms_deform_attn.ms_deform_attn_backward,
             fused_ffn.encoder_tail, fused_ffn.encoder_tail_backward,
             ms_deform_attn_sep.ms_deform_attn_sep, ms_deform_attn_sep.ms_deform_attn_sep_backward):
    assert name.launches == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "richsem_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""


def test_port_runs_without_jax():
    code = f"MODULES = {MODULES!r}\n" + SCRIPT
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_entry_points_default_to_the_card():
    """Built without a device, the model and the CLIP teacher target CUDA:
    where there is no card they raise instead of building on the CPU. The K3
    wrapper runs its plain version only for CPU tensors: its backward entry,
    which has no plain path, refuses them."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    cfg = Config.fromfile(os.path.join(ROOT, "configs/richsem/dino_4scale_lvis.py"))
    cfg.update(hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=128,
               num_queries=20, num_classes=12)
    fcfg = Config.fromfile(os.path.join(ROOT, "configs/richsem/richsem_4scale_lvis.py"))
    shapes = ((4, 6),)
    args = (torch.zeros(1, 24, 2, 4), shapes, torch.full((1, 3, 2, 1, 2, 2), 0.5),
            torch.full((1, 3, 2, 1, 2), 0.5))
    if torch.cuda.is_available():
        model, _, _ = build_model("richsem", cfg)
        assert next(model.parameters()).device.type == "cuda"
        teacher = build_clip_teacher(fcfg, "bfloat16")
        assert next(teacher.parameters()).device.type == "cuda"
        before = k3.ms_deform_attn_sep.launches
        k3.ms_deform_attn_sep(*(a.cuda() if torch.is_tensor(a) else a for a in args))
        assert k3.ms_deform_attn_sep.launches == before + 1
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            build_model("richsem", cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            build_clip_teacher(fcfg, "bfloat16")
    with pytest.raises(RuntimeError, match="no kernel"):
        k3.ms_deform_attn_sep_backward(*args, torch.zeros(1, 3, 8))


def test_registry_names_the_richsem_builder():
    # imported here, in the test process, only to read the registry
    import richsem_tpu_torch.models.build  # noqa: F401
    from richsem_tpu_torch.models import MODEL_REGISTRY

    assert "richsem" in MODEL_REGISTRY
