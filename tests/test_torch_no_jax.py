"""The port imports neither JAX, flax nor the JAX package, nor OpenCV or PIL.

In a fresh interpreter where ``import jax``, ``import flax``,
``import richsem_tpu``, ``import cv2`` and ``import PIL`` all fail, every
module of the port imports, the tiny
model builds on the CPU, serves one batch and takes one training step (CDN,
matching, the federated loss, the clipped AdamW), then one flagship step with
a tiny CLIP teacher (RoIAlign, the distillation losses) and the separable
decoder sampler, then a step and an eval batch of the semantic variant (the
five semantic-branch knobs, OptMatcher, NMS), a step of each mask head with
the batch's masks, and the seven kernels' launch
counters stay at 0 (CPU tensors run the plain versions). In another such interpreter the data path reads PNGs
and JPEGs (the host codec, built with the C compiler) and runs a two-image
loader epoch, the trainer's entry point takes a step on
the CPU, the probes run their plain versions, and the instance masks
(polygons, RLE, their resize and the collate's targets), the panoptic
evaluator and the visualizer's PNG run.
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
    "richsem_tpu_torch.models.swin",
    "richsem_tpu_torch.models.convnext",
    "richsem_tpu_torch.models.focalnet",
    "richsem_tpu_torch.models.dino",
    "richsem_tpu_torch.models.postprocess",
    "richsem_tpu_torch.models.registry",
    "richsem_tpu_torch.models.build",
    "richsem_tpu_torch.models.dn",
    "richsem_tpu_torch.models.matcher",
    "richsem_tpu_torch.models.criterion",
    "richsem_tpu_torch.models.ota_matcher",
    "richsem_tpu_torch.ops.nms",
    "richsem_tpu_torch.tools.gemm_sites",
    "richsem_tpu_torch.models.clip",
    "richsem_tpu_torch.models.clip.model",
    "richsem_tpu_torch.models.clip.tokenizer",
    "richsem_tpu_torch.models.clip_align",
    "richsem_tpu_torch.ops.lap",
    "richsem_tpu_torch.train.optim",
    "richsem_tpu_torch.train.engine",
    "richsem_tpu_torch.train.main",
    "richsem_tpu_torch.data",
    "richsem_tpu_torch.data.image_io",
    "richsem_tpu_torch.data.misc_utils",
    "richsem_tpu_torch.data.sltransforms",
    "richsem_tpu_torch.utils.box_losses",
    "richsem_tpu_torch.data.coco_api",
    "richsem_tpu_torch.data.transforms",
    "richsem_tpu_torch.data.datasets",
    "richsem_tpu_torch.data.samplers",
    "richsem_tpu_torch.data.loader",
    "richsem_tpu_torch.data.synthetic",
    "richsem_tpu_torch.data.evaluation",
    "richsem_tpu_torch.data.evaluation.detection_eval",
    "richsem_tpu_torch.utils.logging",
    "richsem_tpu_torch.utils.checkpoint",
    "richsem_tpu_torch.tools",
    "richsem_tpu_torch.tools._probe",
    "richsem_tpu_torch.tools.bench_cal",
    "richsem_tpu_torch.tools.bench_cell",
    "richsem_tpu_torch.tools.bench_vpu_model",
    "richsem_tpu_torch.utils.profiling",
    "richsem_tpu_torch.bench",
    "richsem_tpu_torch.tools.bench_eval",
    "richsem_tpu_torch.tools.bench_input_pipeline",
    "richsem_tpu_torch.parallel",
    "richsem_tpu_torch.parallel.dist",
    "richsem_tpu_torch.tools.dryrun_ddp",
    "richsem_tpu_torch.models.segmentation",
    "richsem_tpu_torch.models.cond_inst",
    "richsem_tpu_torch.data.evaluation.panoptic_eval",
    "richsem_tpu_torch.utils.glyphs",
    "richsem_tpu_torch.utils.visualizer",
]

BLOCKED = ("jax", "flax", "richsem_tpu", "cv2", "PIL")

SCRIPT = """
import importlib, sys
for name in BLOCKED:
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

from richsem_tpu_torch.ops import nms
vcfg = Config.fromfile("configs/richsem/richsem_4scale_lvis.py")
vcfg.update(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2, dim_feedforward=128,
            num_queries=20, num_classes=12, dn_labelbook_size=12, fed_num_sample_cats=4,
            clip_embed_dim=16, clip_spatial_dim=256, distill_max_boxes=2, num_select=50,
            compute_dtype="float32", two_stage_cls=True, distill_aux_layers=True,
            use_clip_visual_query=True, share_vl_proj=True, enc_cls_agn=True,
            check_pos_dn=True, matcher_type="OptMatcher", nms_iou_threshold=0.5)
model, _, _ = build_model("richsem", vcfg, device="cpu", generator=torch.Generator().manual_seed(0))
state = create_train_state(model, build_optimizer(model, vcfg))
step = make_train_step(model, vcfg, seed=0, device="cpu", clip_model=teacher)
text = torch.randn((12, 16), generator=g)
m = step(state, dict(tb, size=torch.tensor([[128, 192], [100, 150]])), text)
assert bool(m["finite"]) and float(m["loss_distill"]) > 0
out = make_eval_step(model, vcfg, teacher)(batch, text)
assert out["scores"].shape == (2, 50) and (out["scores"] == -1).any()

for head in ("detr", "cond_inst"):  # the masks path: a train step with the batch's masks
    mcfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
    mcfg.update(hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=128,
                num_queries=20, num_classes=12, dn_labelbook_size=12, fed_num_sample_cats=4,
                compute_dtype="float32", masks=True, mask_head_type=head)
    model, weight_dict, _ = build_model("richsem", mcfg, device="cpu",
                                        generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, build_optimizer(model, mcfg))
    masks = torch.rand((2, 3, 16, 24), generator=g) > 0.5
    m = make_train_step(model, mcfg, seed=0, device="cpu")(state, dict(tb, masks=masks))
    assert bool(m["finite"]) and weight_dict["loss_mask"] > 0
for name in (ms_deform_attn.ms_deform_attn, ms_deform_attn.ms_deform_attn_backward,
             fused_ffn.encoder_tail, fused_ffn.encoder_tail_backward,
             ms_deform_attn_sep.ms_deform_attn_sep, ms_deform_attn_sep.ms_deform_attn_sep_backward,
             nms.nms_mask):
    assert name.launches == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "richsem_tpu", "cv2",
                                                        "PIL")
             and sys.modules[m] is not None)
assert not bad, bad
print("OK")
"""

DATA_SCRIPT = """
import importlib, os, shutil, sys, tempfile
for name in BLOCKED:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(2)
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.data.datasets import build_dataset
from richsem_tpu_torch.data.image_io import imread_rgb
from richsem_tpu_torch.data.loader import DataLoader
from richsem_tpu_torch.data.samplers import ShuffleSampler
from richsem_tpu_torch.data.synthetic import write_lvis
from richsem_tpu_torch.tools import bench_cal, bench_cell, bench_vpu_model
from richsem_tpu_torch.train import main

root = tempfile.mkdtemp()
write_lvis(root, n_train=2, n_val=2, hw=((40, 60), (50, 70)), n_cats=5, max_boxes=3,
           filters=(4,))
img = imread_rgb(os.path.join(root, "coco", "train2017", "000000000001.png"))
assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
from richsem_tpu_torch.data.image_io import decode_jpeg, encode_jpeg
jpg = os.path.join(root, "x.jpg")
with open(jpg, "wb") as f:
    f.write(encode_jpeg(img, 90))
out = imread_rgb(jpg)
assert out.shape == img.shape and np.array_equal(out, decode_jpeg(open(jpg, "rb").read()))
assert np.abs(out.astype(int) - img.astype(int)).mean() < 20
cfg = Config.fromfile("configs/richsem/dino_4scale_lvis.py")
cfg.update(data_root=root, dataset_file="lvis", data_aug_scales=[48, 64], data_aug_max_size=96,
           data_aug_scales2_resize=[40], data_aug_scales2_crop=[32, 40],
           train_canvas_buckets=[(128, 128)], eval_canvas=(128, 128), max_gt_per_image=4)
ds = build_dataset("train", cfg)
batches = list(DataLoader(ds, ShuffleSampler(len(ds)), 2, [(128, 128)], 4).epoch(0))
assert len(batches) == 1 and batches[0]["images"].shape == (2, 128, 128, 3)
assert batches[0]["valid"].any()

cfg.update(hidden_dim=64, nheads=4, enc_layers=1, dec_layers=1, dim_feedforward=128,
           num_queries=20, num_classes=6, dn_labelbook_size=6, fed_num_sample_cats=3,
           compute_dtype="float32", num_select=20, epochs=1, output_dir=os.path.join(root, "out"),
           device="cpu", seed=0, eval=False, test=False, resume="", pretrain_model_path="",
           start_epoch=0, debug=False)
result = main.train_loop(cfg)
assert result["state"].step == 1 and os.path.isfile(os.path.join(root, "out", "ckpt", "1.pt"))
out, _ = bench_cal.run_grid_overhead(4, device="cpu")
assert torch.equal(out, torch.full((4, 8, 128), 2.0))
assert bench_cell.check_repeat_semantics(device="cpu")[0].tolist() == list(range(8)) * 2
from richsem_tpu_torch.tools import bench_input_pipeline
line = bench_input_pipeline.bench_line(8, threads=2)
assert line["value"] > 0 and "JPEG corpus" in line["metric"]
for fn in (bench_cal.vpu, bench_cal.mxu, bench_cal.grid_overhead, bench_cal.repeat,
           bench_cell.cell, bench_cell.tile, bench_vpu_model.chain, bench_vpu_model.fma,
           bench_vpu_model.fma_chunk):
    assert fn.launches == 0
from richsem_tpu_torch.data.datasets import _polygons_to_mask, _rle_to_mask
from richsem_tpu_torch.data.loader import collate
from richsem_tpu_torch.data.transforms import normalize, resize
from richsem_tpu_torch.data.evaluation import PanopticEvaluator, panoptic_map_from_instances
from richsem_tpu_torch.utils.visualizer import save_detections
mask = _polygons_to_mask([[2.0, 3.0, 30.5, 4.0, 20.0, 35.0], [40, 40, 59, 41, 50, 49]], 50, 60)
assert mask.shape == (50, 60) and mask[10, 15] and mask[42, 50] and not mask[0, 0]
rle = _rle_to_mask({"counts": [3, 4, 5], "size": [4, 3]}, 8, 6)
assert rle.shape == (8, 6) and rle.sum() == 16
rec = {"image": img[:50, :60], "boxes": np.asarray([[2, 3, 30, 35]], np.float32),
       "labels": np.asarray([1]), "area": np.asarray([400.0], np.float32),
       "iscrowd": np.asarray([0]), "image_id": 0, "orig_size": (50, 60), "masks": mask[None]}
rec = resize(rec, 37)
batch = collate([normalize(rec)], [(64, 64)], max_gt=2)
assert batch["masks"].shape == (1, 2, 8, 8) and batch["masks"][0, 0].any()
seg, segments = panoptic_map_from_instances(mask[None], np.asarray([3]), np.asarray([0.9]))
ev = PanopticEvaluator()
ev.update(seg, segments, seg, segments)
assert ev.summarize()["PQ"] == 1.0
save_detections(os.path.join(root, "det.png"), img, np.asarray([[5, 5, 30, 30]]),
                np.asarray([2]), np.asarray([0.9]), class_names={2: "cat"})
assert imread_rgb(os.path.join(root, "det.png")).shape == img.shape
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "richsem_tpu", "cv2",
                                                        "PIL")
             and sys.modules[m] is not None)
assert not bad, bad
shutil.rmtree(root)  # the trainer's checkpoint is ~300 MB
print("OK")
"""


def _run(script):
    code = f"MODULES = {MODULES!r}\nBLOCKED = {BLOCKED!r}\n" + script
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


def test_port_runs_without_jax():
    _run(SCRIPT)


def test_data_path_and_trainer_run_without_opencv_or_jax():
    _run(DATA_SCRIPT)


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
