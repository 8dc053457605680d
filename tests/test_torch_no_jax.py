"""The port imports neither JAX, flax nor the JAX package.

In a fresh interpreter where ``import jax``, ``import flax`` and
``import richsem_tpu`` all fail, every module of the port's eval slice
imports, the tiny model builds and serves one batch on the CPU, and the
kernels' launch counters stay at 0 (CPU tensors run the plain versions).
"""

import os
import subprocess
import sys

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
    "richsem_tpu_torch.models.transformer_utils",
    "richsem_tpu_torch.models.layers",
    "richsem_tpu_torch.models.resnet",
    "richsem_tpu_torch.models.dino",
    "richsem_tpu_torch.models.postprocess",
    "richsem_tpu_torch.models.registry",
    "richsem_tpu_torch.models.build",
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
model, _ = build_model("richsem", cfg, device="cpu", generator=torch.Generator().manual_seed(0))
g = torch.Generator().manual_seed(1)
batch = {"images": torch.rand((2, 128, 192, 3), generator=g) * 2 - 1,
         "pad_mask": torch.zeros(2, 128, 192, dtype=torch.bool),
         "orig_size": torch.tensor([[128, 192], [128, 192]])}
out = make_eval_step(model, cfg)(batch, torch.randn((12, 64), generator=g))
assert out["scores"].shape == (2, 50) and out["boxes"].shape == (2, 50, 4)
assert torch.isfinite(out["scores"]).all() and torch.isfinite(out["boxes"]).all()
assert ms_deform_attn.ms_deform_attn.launches == 0
assert fused_ffn.encoder_tail.launches == 0
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


def test_registry_names_the_richsem_builder():
    # imported here, in the test process, only to read the registry
    import richsem_tpu_torch.models.build  # noqa: F401
    from richsem_tpu_torch.models import MODEL_REGISTRY

    assert "richsem" in MODEL_REGISTRY
