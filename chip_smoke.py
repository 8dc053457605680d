"""Drive the PyTorch port (``richsem_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each printed as it completes:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every hand-written kernel from
   ``richsem_tpu_torch/csrc`` (nvcc, sm_90a) with its register report.
2. K1 (deformable attention) against its plain PyTorch version at the
   production encoder shapes (clamped offsets) and decoder shapes (900 box
   queries, unclamped), in bf16 and f32: max abs error and both times.
3. K2 (fused encoder tail) against its plain version at N = 49,980 in bf16.
4. The flagship eval step (``configs/richsem/richsem_4scale_lvis.py``, bf16,
   random weights from a seeded generator, a 1204 x 1024 text bank) on 3
   batches of 2 images at 896 x 1344: outputs checked, K1/K2 launches counted
   (12 and 6 per forward), ms/batch, img/s and peak memory; then one batch
   against the same model with the plain versions in place of the kernels,
   and one profiled batch (device time by kernel).

TF32 is off for every matmul and convolution here. The second-to-last line is
the kernels' JSON record, the last ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "richsem", "richsem_4scale_lvis.py")
BATCH, CANVAS, N_BATCHES = 2, (896, 1344), 3
SHAPES = ((112, 168), (56, 84), (28, 42), (14, 21))  # the 896 x 1344 pyramid
DEVICE = "cuda"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel_out, plain_out, atol, rtol):
    import torch

    a, b = kernel_out.float(), plain_out.float()
    if not torch.isfinite(a).all():
        fail(f"{name}: kernel output is not finite")
    err = float((a - b).abs().max())
    ok = bool(torch.allclose(a, b, atol=atol, rtol=rtol))
    print(f"  {name}: max_abs_err {err:.3e} (tolerance atol {atol:g} + rtol {rtol:g} * |plain|)"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def phase_build():
    import torch

    from richsem_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print("TF32 off for matmuls and convolutions; bf16 matmuls reduce in f32")
    t0 = time.perf_counter()
    for name in ("ms_deform_attn_fwd", "fused_encoder_tail_fwd"):
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


def phase_k1():
    import torch

    from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
    from richsem_tpu_torch.ops import ms_deform_attn as k1

    g = torch.Generator(device=DEVICE).manual_seed(1)
    dev = DEVICE
    b, m, d, n_lvl, p = BATCH, 8, 32, 4, 4
    s = sum(h * w for h, w in SHAPES)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def softmax_aw(q):
        return torch.softmax(randn(b, q, m, n_lvl * p), -1).reshape(b, q, m, n_lvl, p)

    value = randn(b, s, m, d)
    # encoder: Q = S, reference points at the tokens, offsets clamped to +-5.5
    vr = torch.ones(b, n_lvl, 2, device=dev)
    refs = encoder_reference_points(SHAPES, vr)
    offs = (torch.rand((b, s, m, n_lvl, p, 2), generator=g, device=dev) * 2 - 1) * 5.5
    cases = {"encoder": (k1.compute_sampling_locations(refs, offs, SHAPES, p), softmax_aw(s))}
    # decoder: 900 box queries, unclamped offsets (some taps out of bounds)
    q = 900
    boxes = torch.cat([torch.rand((b, q, 1, 2), generator=g, device=dev),
                       torch.rand((b, q, 1, 2), generator=g, device=dev) * 0.5 + 0.02],
                      -1).expand(b, q, n_lvl, 4)
    cases["decoder"] = (k1.compute_sampling_locations(boxes, randn(b, q, m, n_lvl, p, 2) * 2,
                                                      SHAPES, p), softmax_aw(q))
    rec = {"name": "ms_deform_attn_fwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_fwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_pallas2.py:265"}
    errs = []
    for case, (loc, aw) in cases.items():
        for dtype, atol, rtol in ((torch.bfloat16, 1e-2, 1e-2), (torch.float32, 5e-5, 0.0)):
            v = value.to(dtype)
            out = k1.ms_deform_attn(v, SHAPES, loc, aw)
            ref = k1.ms_deform_attn_plain(v, SHAPES, loc, aw)
            torch.cuda.synchronize()
            tag = f"K1 {case} Q={loc.shape[1]} {str(dtype)[6:]}"
            errs.append(compare(tag, out, ref, atol, rtol))
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: k1.ms_deform_attn(v, SHAPES, loc, aw))
                plain_ms = cuda_ms(lambda: k1.ms_deform_attn_plain(v, SHAPES, loc, aw), iters=5)
                print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms", flush=True)
                key = "" if case == "encoder" else "decoder_"
                rec[f"{key}ms"], rec[f"{key}plain_ms"] = ms, plain_ms
    # Tolerances: both versions sum the 64 taps in f32, in another order and
    # with or without fused multiply-adds. In f32 that moves a sum of terms
    # below 4 by a few ulps each, under 5e-5 in all; in bf16 the sum is then
    # rounded once, and the two may land one bf16 step apart (at most 2^-6
    # below 4, i.e. within 1e-2 + 1e-2 * |plain|).
    rec["max_abs_err"] = max(errs)
    print("phase 2: K1 matches its plain version", flush=True)
    return rec


def phase_k2():
    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2

    g = torch.Generator(device=DEVICE).manual_seed(2)
    n, d, f = BATCH * sum(h * w for h, w in SHAPES), 256, 2048

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale

    args = (randn(n, d), randn(n, d, scale=0.5),
            randn(f, d, scale=d**-0.5), randn(f, scale=0.1),
            randn(d, f, scale=f**-0.5), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1), 1e-5, torch.bfloat16)
    out = k2.encoder_tail(*args)
    ref = k2.encoder_tail_plain(*args)
    torch.cuda.synchronize()
    # one bf16 rounding step of h2 (2^-8 relative, |h2| < 4) that falls the
    # other way after a differently ordered f32 sum passes through LN2
    err = compare(f"K2 N={n} bf16", out, ref, 3e-2, 0.0)
    ms = cuda_ms(lambda: k2.encoder_tail(*args))
    plain_ms = cuda_ms(lambda: k2.encoder_tail_plain(*args))
    print(f"  K2 N={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print("phase 3: K2 matches its plain version", flush=True)
    return {"name": "fused_encoder_tail_fwd", "route": "cuda",
            "source": "richsem_tpu_torch/csrc/fused_encoder_tail_fwd.cu",
            "replaces": "richsem_tpu/ops/fused_ffn.py:82",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_eval(k1_rec, k2_rec):
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.models import dino, layers
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.train.engine import make_eval_step

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
    h, w = CANVAS
    batches = []
    for _ in range(N_BATCHES + 1):
        pad = torch.ones(BATCH, h, w, dtype=torch.bool, device=DEVICE)
        pad[:, : h - 96, : w - 120] = False  # bench.py's valid extent
        batches.append({
            "images": torch.rand((BATCH, h, w, 3), generator=g, device=DEVICE) * 2 - 1,
            "pad_mask": pad,
            "orig_size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE),
        })
    step = make_eval_step(model, cfg)
    step(batches[-1], text_embed)  # warm-up (cuDNN autotuning, allocator)
    torch.cuda.synchronize()
    print(f"  setup + warm-up {time.perf_counter() - t0:.1f} s", flush=True)

    torch.cuda.reset_peak_memory_stats()
    k1.ms_deform_attn.launches = 0
    k2.encoder_tail.launches = 0
    times, results = [], []
    for batch in batches[:N_BATCHES]:
        t = time.perf_counter()
        results.append(step(batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    n_k1, n_k2 = k1.ms_deform_attn.launches, k2.encoder_tail.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for r in results:
        if r["scores"].shape != (BATCH, cfg.num_select) or r["labels"].shape != (BATCH, cfg.num_select):
            fail(f"eval output shapes {r['scores'].shape} {r['labels'].shape}")
        if r["boxes"].shape != (BATCH, cfg.num_select, 4):
            fail(f"eval box shape {r['boxes'].shape}")
        if not all(torch.isfinite(r[k].float()).all() for k in ("scores", "boxes")):
            fail("eval outputs are not finite")
        if not ((r["labels"] >= 0) & (r["labels"] < cfg.num_classes)).all():
            fail("labels out of range")
    print(f"  outputs: scores/labels {tuple(results[0]['scores'].shape)}, boxes "
          f"{tuple(results[0]['boxes'].shape)}, finite; top score {float(results[0]['scores'].max()):.4f}")
    per_fwd = cfg.enc_layers + cfg.dec_layers, cfg.enc_layers
    print(f"  launches over {N_BATCHES} forwards: K1 {n_k1} (expect {per_fwd[0] * N_BATCHES}), "
          f"K2 {n_k2} (expect {per_fwd[1] * N_BATCHES})")
    if (n_k1, n_k2) != (per_fwd[0] * N_BATCHES, per_fwd[1] * N_BATCHES):
        fail("the eval path did not launch K1 12 and K2 6 times per forward")
    k1_rec["launches"], k2_rec["launches"] = n_k1, n_k2
    ms_batch = statistics.median(times)
    print(f"  eval step: {', '.join(f'{t:.2f}' for t in times)} ms/batch; median "
          f"{ms_batch:.2f} ms/batch = {BATCH * 1e3 / ms_batch:.3f} img/s; "
          f"peak memory {peak_gb:.2f} GB", flush=True)

    # The same forward with the plain versions in place of K1 and K2, compared
    # at the encoder output. (Past it, the top-900 selection among 24,990
    # near-tied random-weight scores reorders under bf16 rounding noise, so
    # the decoder's queries are not comparable one to one.)
    batch = batches[0]
    memory = []
    hook = model.layers("encoder")[-1].register_forward_hook(
        lambda mod, args, result: memory.append(result))
    with torch.inference_mode():
        out = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        layers.ms_deform_attn, dino.encoder_tail = k1.ms_deform_attn_plain, k2.encoder_tail_plain
        try:
            ref = model(batch["images"], batch["pad_mask"], text_embed=text_embed)
        finally:
            layers.ms_deform_attn, dino.encoder_tail = k1.ms_deform_attn, k2.encoder_tail
    hook.remove()
    torch.cuda.synchronize()
    diff = (memory[0] - memory[1]).abs()
    overlap = min(
        len(set(a.tolist()) & set(b.tolist())) / a.numel()
        for a, b in zip(out["topk_idx"], ref["topk_idx"])
    )
    print(f"  kernels vs plain versions, one batch: encoder output max_abs_err "
          f"{float(diff.max()):.3e}, mean_abs_err {float(diff.mean()):.3e}; "
          f"two-stage selections overlap {overlap:.4f}", flush=True)
    # bf16 steps that round the other way (the K1/K2 checks above) feed six
    # layers: measured on an H100, max 2.6e-2 and mean 3.3e-3 at this seed,
    # and 98% of the 900 selected tokens shared
    if not (float(diff.mean()) < 1e-2 and overlap > 0.9):
        fail("the encoder with kernels departs from the one with plain versions")

    profile_once(step, batches[1], text_embed)
    print("phase 4: flagship eval step ok", flush=True)


def profile_once(step, batch, text_embed):
    """Device time by kernel over one eval step (torch.profiler / CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch, text_embed)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("  profile: no device time recorded (not measured)")
        return
    print(f"  profile: device busy {total_us / 1e3:.2f} ms of a {wall_ms:.2f} ms step "
          f"(idle share {max(0.0, 1 - total_us / 1e3 / wall_ms):.3f}), "
          f"{sum(e.count for e in rows)} device operations; top kernels:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    if not os.path.isdir(os.path.join(ROOT, "richsem_tpu_torch")) or not os.path.isfile(CONFIG):
        fail("run from the root of a checkout (richsem_tpu_torch/ and configs/ not found)")
    sys.path.insert(0, ROOT)
    t0 = time.perf_counter()
    smi = phase_build()
    k1_rec = phase_k1()
    k2_rec = phase_k2()
    phase_eval(k1_rec, k2_rec)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [k1_rec, k2_rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
