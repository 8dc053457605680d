"""Drive the PyTorch port (``richsem_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one CUDA card

Phases, each printed as it completes:

1. The card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of every hand-written kernel from
   ``richsem_tpu_torch/csrc`` (six kernels, one nvcc per source, all at once,
   sm_90a) with its register report.
2. K1 (deformable attention) against its plain PyTorch version at the
   production encoder shapes (clamped offsets) and decoder shapes (1,100 box
   queries, unclamped), in bf16 and f32: max abs error and both times.
3. K1-bwd against the autograd gradient of the plain version, same shapes.
4. K2 (fused encoder tail) against its plain version at N = 49,980 in bf16.
5. K2-bwd against the plain version's autograd gradient: all ten gradients.
6. The flagship eval step (``configs/richsem/richsem_4scale_lvis.py``, bf16,
   random weights from a seeded generator, a 1204 x 1024 text bank) on 3
   batches of 2 images at 896 x 1344: outputs checked, K1/K2 launches counted
   (12 and 6 per forward), ms/batch, img/s and peak memory; then one batch
   against the same model with the plain versions in place of the kernels,
   and one profiled batch (device time by kernel).
7. The training step of ``configs/richsem/dino_4scale_lvis.py`` (bf16, bs2
   at 896 x 1344, the synthetic batch of ``bench.py``: 300 GT slots, 16
   valid): one warm-up and 5 steps, loss and grad norm per step, launches per
   step (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K3 0, K3-bwd 0), auction rounds,
   ms/step, img/s and peak memory; then the gradients of a few named leaves
   against those of the same step with the plain versions in place of every
   kernel, and one profiled step.
8. K3 (the separable decoder sampler) against its plain dense version at the
   decoder's shapes (1,100 queries), bf16 and f32; run right after phase 3,
   on its inputs.
9. K3-bwd against the plain version's explicit backward, same shapes.
10. The flagship train step (``richsem_4scale_lvis.py``: the CLIP-text
    classifier, a random-weight bf16 CLIP-RN50 teacher and a random
    1204 x 1024 text bank as ``bench.py:114-126`` builds them, distillation
    at the first 100 valid GT boxes): the teacher's targets timed alone, then
    as phase 7 with ``loss_distill`` and ``loss_distill_dn`` per step, the
    launches checked (K1 12, K1-bwd 12, K2 6, K2-bwd 6, K3 0, K3-bwd 0) and
    the CLIP heads among the compared gradients.
11. The same step with ``dec_msda_impl="sep_pallas"``: 2 steps, launches
    checked (6 of each of the six kernels), the loss, the gradients against
    the plain versions, and one profiled step.

``python3 chip_smoke.py kernels`` stops after the kernel phases (1-5, 8, 9).

TF32 is off for every matmul and convolution here. The second-to-last line is
the kernels' JSON record, the last ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero before those lines.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "richsem", "richsem_4scale_lvis.py")
TRAIN_CONFIG = os.path.join(ROOT, "configs", "richsem", "dino_4scale_lvis.py")
BATCH, CANVAS, N_BATCHES, N_STEPS, N_SEP_STEPS = 2, (896, 1344), 3, 5, 2
MAX_GT, N_VALID = 300, 16  # bench.py's GT pad and valid count
SHAPES = ((112, 168), (56, 84), (28, 42), (14, 21))  # the 896 x 1344 pyramid
DEVICE = "cuda"
KERNELS = ("ms_deform_attn_fwd", "ms_deform_attn_bwd", "fused_encoder_tail_fwd",
           "fused_encoder_tail_bwd", "ms_deform_attn_sep_fwd", "ms_deform_attn_sep_bwd")
# H100 SXM published peaks (dense): HBM bytes/s, bf16 tensor-core and f32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
COS_MIN = 0.9  # least gradient cosine, kernels vs plain versions (phases 7, 10, 11)


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


def bound(nbytes: float, flops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and operations
    over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def compare_rel(name, kernel_out, plain_out, rel):
    """max |kernel - plain| <= rel * max |plain|; -> max abs error."""
    import torch

    a, b = kernel_out.float(), plain_out.float()
    if not torch.isfinite(a).all():
        fail(f"{name}: kernel output is not finite")
    err = float((a - b).abs().max())
    scale = float(b.abs().max())
    ok = err <= rel * scale
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {rel:g} * max|plain| = {rel * scale:.3e})"
          f" {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


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
    _build.build_all(KERNELS)  # one nvcc per source, all at once
    for name in KERNELS:
        _build.load(name)
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    return smi


def k1_cases():
    """Production K1 inputs: the encoder (B2, Q = S = 24,990, offsets clamped to
    +-5.5) and the decoder of the train step (1,100 box queries, unclamped,
    some taps out of bounds)."""
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
    vr = torch.ones(b, n_lvl, 2, device=dev)
    refs = encoder_reference_points(SHAPES, vr)
    offs = (torch.rand((b, s, m, n_lvl, p, 2), generator=g, device=dev) * 2 - 1) * 5.5
    cases = {"encoder": (k1.compute_sampling_locations(refs, offs, SHAPES, p), softmax_aw(s))}
    q = 1100
    boxes = torch.cat([torch.rand((b, q, 1, 2), generator=g, device=dev),
                       torch.rand((b, q, 1, 2), generator=g, device=dev) * 0.5 + 0.02],
                      -1).expand(b, q, n_lvl, 4)
    cases["decoder"] = (k1.compute_sampling_locations(boxes, randn(b, q, m, n_lvl, p, 2) * 2,
                                                      SHAPES, p), softmax_aw(q))
    return value, cases


def k1_taps(loc) -> int:
    return loc[..., 0].numel()  # B*Q*M*L*P


def phase_k1(value, cases):
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn as k1

    rec = {"name": "ms_deform_attn_fwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_fwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_pallas2.py:265", "library_ms": None}
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
                # 4 corners x (multiply + add) per tap and channel
                bms, by = bound(nbytes(v, loc, aw, out), 8 * k1_taps(loc) * v.shape[-1],
                                F32_FLOPS)
                print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bms:.4f} ms ({by})", flush=True)
                key = "" if case == "encoder" else "decoder_"
                rec[f"{key}ms"], rec[f"{key}plain_ms"] = ms, plain_ms
                rec[f"{key}bound_ms"], rec[f"{key}bound_by"] = bms, by
    # Tolerances: both versions sum the 64 taps in f32, in another order and
    # with or without fused multiply-adds. In f32 that moves a sum of terms
    # below 4 by a few ulps each, under 5e-5 in all; in bf16 the sum is then
    # rounded once, and the two may land one bf16 step apart (at most 2^-6
    # below 4, i.e. within 1e-2 + 1e-2 * |plain|).
    rec["max_abs_err"] = max(errs)
    print("phase 2: K1 matches its plain version", flush=True)
    return rec


def phase_k1_bwd(value, cases):
    """K1-bwd against autograd through the plain version, same inputs and g."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn as k1

    g = torch.Generator(device=DEVICE).manual_seed(3)
    rec = {"name": "ms_deform_attn_bwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_bwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_pallas2.py:306", "library_ms": None}
    errs = []
    for case, (loc, aw) in cases.items():
        for dtype in (torch.bfloat16, torch.float32):
            v = value.to(dtype)
            b, q, m = loc.shape[:3]
            grad = torch.randn((b, q, m * v.shape[-1]), generator=g, device=DEVICE).to(dtype)
            out = k1.ms_deform_attn_backward(v, SHAPES, loc, aw, grad)

            def plain():
                leaves = [t.detach().requires_grad_() for t in (v, loc, aw)]
                y = k1.ms_deform_attn_plain(leaves[0], SHAPES, leaves[1], leaves[2])
                return torch.autograd.grad(y, leaves, grad)

            ref = plain()
            torch.cuda.synchronize()
            tag = f"K1-bwd {case} Q={q} {str(dtype)[6:]}"
            # f32: the atomic adds into d_value and the warp sums run in another
            # order than autograd's index_put/sum, a few ulps of each sum; bf16:
            # d_value is rounded to bf16 once, and may land one bf16 step (2^-8
            # relative) apart where the f32 sums differ in their last bits.
            rel = 1e-4 if dtype == torch.float32 else 1e-2
            for name, o, r in zip(("d_value", "d_loc", "d_aw"), out, ref):
                errs.append(compare_rel(f"{tag} {name}", o, r, rel))
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: k1.ms_deform_attn_backward(v, SHAPES, loc, aw, grad))
                plain_ms = cuda_ms(plain, iters=3, warmup=1)
                # per tap and channel: the sample (8), its x and y derivatives
                # (10), the three products with g (6), the four scattered adds (8)
                bms, by = bound(nbytes(v, loc, aw, grad, *out),
                                32 * k1_taps(loc) * v.shape[-1], F32_FLOPS)
                print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                      f"bound {bms:.4f} ms ({by})", flush=True)
                key = "" if case == "encoder" else "decoder_"
                rec[f"{key}ms"], rec[f"{key}plain_ms"] = ms, plain_ms
                rec[f"{key}bound_ms"], rec[f"{key}bound_by"] = bms, by
    rec["max_abs_err"] = max(errs)
    print("phase 3: K1-bwd matches the plain version's autograd gradient", flush=True)
    return rec


def phase_k3(value, loc, aw):
    """K3 (the separable decoder sampler) against its plain dense version at
    the decoder's shapes (1,100 box queries, unclamped, some taps out)."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    rec = {"name": "ms_deform_attn_sep_fwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_sep_fwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_sep_pallas.py:77", "library_ms": None}
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        v = value.to(dtype)
        out = k3.ms_deform_attn_sep(v, SHAPES, loc, aw)
        ref = k3.ms_deform_attn_sep_plain(v, SHAPES, loc, aw)
        torch.cuda.synchronize()
        tag = f"K3 decoder Q={loc.shape[1]} {str(dtype)[6:]}"
        # Both round hxw and rh where the TPU kernel does and sum in f32 in
        # another order: f32 within 5e-5 of the largest magnitude; bf16 may
        # land one bf16 step apart, as K1 (1e-2 + 1e-2 * |plain|)
        if dtype == torch.float32:
            errs.append(compare_rel(tag, out, ref, 5e-5))
        else:
            errs.append(compare(tag, out, ref, 1e-2, 1e-2))
            ms = cuda_ms(lambda: k3.ms_deform_attn_sep(v, SHAPES, loc, aw))
            plain_ms = cuda_ms(lambda: k3.ms_deform_attn_sep_plain(v, SHAPES, loc, aw), iters=3,
                               warmup=1)
            # per sample and channel: two rows of (2 products + 1 add for r, the
            # hat product, the add into the sum)
            bms, by = bound(nbytes(v, loc, aw, out), 10 * k1_taps(loc) * v.shape[-1], F32_FLOPS)
            print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    rec["max_abs_err"] = max(errs)
    print("phase 8: K3 matches its plain version", flush=True)
    return rec


def phase_k3_bwd(value, loc, aw):
    """K3-bwd against the plain version's explicit backward, same inputs and g."""
    import torch

    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    g = torch.Generator(device=DEVICE).manual_seed(4)
    rec = {"name": "ms_deform_attn_sep_bwd", "route": "cuda",
           "source": "richsem_tpu_torch/csrc/ms_deform_attn_sep_bwd.cu",
           "replaces": "richsem_tpu/ops/ms_deform_attn_sep_pallas.py:109", "library_ms": None}
    errs = []
    for dtype in (torch.bfloat16, torch.float32):
        v = value.to(dtype)
        b, q, m = loc.shape[:3]
        grad = torch.randn((b, q, m * v.shape[-1]), generator=g, device=DEVICE).to(dtype)
        out = k3.ms_deform_attn_sep_backward(v, SHAPES, loc, aw, grad)
        ref = k3.ms_deform_attn_sep_backward_plain(v, SHAPES, loc, aw, grad)
        torch.cuda.synchronize()
        tag = f"K3-bwd decoder Q={q} {str(dtype)[6:]}"
        # as K1-bwd: the atomic adds into d_value and the warp sums run in
        # another order than the dense products; bf16 rounds d_value once, and
        # may land one step (2^-8 relative) apart
        rel = 1e-4 if dtype == torch.float32 else 2e-2
        for name, o, r in zip(("d_value", "d_loc", "d_aw"), out, ref):
            errs.append(compare_rel(f"{tag} {name}", o, r, rel))
        if dtype == torch.bfloat16:
            ms = cuda_ms(lambda: k3.ms_deform_attn_sep_backward(v, SHAPES, loc, aw, grad))
            plain_ms = cuda_ms(
                lambda: k3.ms_deform_attn_sep_backward_plain(v, SHAPES, loc, aw, grad),
                iters=3, warmup=1)
            # per sample and channel, two rows of: r (3), g*r*dhat and its sum
            # (3), d_r (1), the two d_hxw products and sums (4), the two
            # scattered products and adds (4)
            bms, by = bound(nbytes(v, loc, aw, grad, *out), 30 * k1_taps(loc) * v.shape[-1],
                            F32_FLOPS)
            print(f"  {tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bms:.4f} ms ({by})", flush=True)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
    rec["max_abs_err"] = max(errs)
    print("phase 9: K3-bwd matches the plain version's explicit backward", flush=True)
    return rec


def k2_args():
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(2)
    n, d, f = BATCH * sum(h * w for h, w in SHAPES), 256, 2048

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=DEVICE) * scale

    args = (randn(n, d), randn(n, d, scale=0.5),
            randn(f, d, scale=d**-0.5), randn(f, scale=0.1),
            randn(d, f, scale=f**-0.5), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1),
            1 + randn(d, scale=0.1), randn(d, scale=0.1), 1e-5, torch.bfloat16)
    return args, randn(n, d)


def phase_k2(args):
    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2

    n, d = args[0].shape
    f = args[2].shape[0]
    out = k2.encoder_tail(*args)
    ref = k2.encoder_tail_plain(*args)
    torch.cuda.synchronize()
    # one bf16 rounding step of h2 (2^-8 relative, |h2| < 4) that falls the
    # other way after a differently ordered f32 sum passes through LN2
    err = compare(f"K2 N={n} bf16", out, ref, 3e-2, 0.0)
    ms = cuda_ms(lambda: k2.encoder_tail(*args))
    plain_ms = cuda_ms(lambda: k2.encoder_tail_plain(*args))
    # inputs as the kernel reads them: f32 streams, bf16 weights, f32 LN params
    bms, by = bound(nbytes(*args[:2], out) + 2 * (2 * d * f + f + d) + 4 * 4 * d,
                    4 * n * d * f, BF16_FLOPS)
    print(f"  K2 N={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    print("phase 4: K2 matches its plain version", flush=True)
    return {"name": "fused_encoder_tail_fwd", "route": "cuda",
            "source": "richsem_tpu_torch/csrc/fused_encoder_tail_fwd.cu",
            "replaces": "richsem_tpu/ops/fused_ffn.py:82",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


def phase_k2_bwd(args, dy):
    """K2-bwd against autograd through the plain tail: all ten gradients."""
    import torch

    from richsem_tpu_torch.ops import fused_ffn as k2

    n, d = args[0].shape
    f = args[2].shape[0]
    tensors, rest = list(args[:10]), args[10:]
    out = k2.encoder_tail_backward(*args, dy)
    out = (out[0], *out)  # du1 is the gradient of both src and attn_out

    def plain():
        leaves = [t.detach().requires_grad_() for t in tensors]
        y = k2.encoder_tail_plain(*leaves, *rest)
        return torch.autograd.grad(y, leaves, dy)

    ref = plain()
    torch.cuda.synchronize()
    names = ("d_src", "d_attn", "dW1", "db1", "dW2", "db2", "ds1", "dsb1", "ds2", "dsb2")
    # bf16: the plain version rounds dW1, dW2, db2 and dx_ffn to bf16 (2^-8
    # relative) where the kernel keeps them f32, and a relu mask may flip where a
    # recomputed pre-activation lands one bf16 step apart; 2e-2 of the largest
    # magnitude covers both
    errs = [compare_rel(f"K2-bwd N={n} bf16 {name}", o, r, 2e-2)
            for name, o, r in zip(names, out, ref)]
    ms = cuda_ms(lambda: k2.encoder_tail_backward(*args, dy), iters=10)
    plain_ms = cuda_ms(plain, iters=5, warmup=1)
    bms, by = bound(nbytes(*args[:2], dy, out[0]) + 2 * (2 * d * f + f + d) + 4 * 4 * d
                    + 4 * (2 * d * f + f + 5 * d), 12 * n * d * f, BF16_FLOPS)
    print(f"  K2-bwd N={n} bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    print("phase 5: K2-bwd matches the plain version's autograd gradient", flush=True)
    return {"name": "fused_encoder_tail_bwd", "route": "cuda",
            "source": "richsem_tpu_torch/csrc/fused_encoder_tail_bwd.cu",
            "replaces": "richsem_tpu/ops/fused_ffn.py:93",
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None}


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
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
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
    k1_rec["eval_launches"], k2_rec["eval_launches"] = n_k1, n_k2
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

    profile_once(lambda: step(batches[1], text_embed))
    print("phase 6: flagship eval step ok", flush=True)


def train_batch(g):
    """bench.py's synthetic batch (bench.py:90-112), drawn on the card; ``size``
    is the valid (h, w) by which the teacher scales the GT boxes."""
    import torch

    h, w = CANVAS
    pad = torch.ones(BATCH, h, w, dtype=torch.bool, device=DEVICE)
    pad[:, : h - 96, : w - 120] = False
    return {
        "images": torch.rand((BATCH, h, w, 3), generator=g, device=DEVICE) * 2 - 1,
        "pad_mask": pad,
        "labels": torch.randint(0, 1203, (BATCH, MAX_GT), generator=g, device=DEVICE),
        "boxes": (torch.rand((BATCH, MAX_GT, 4), generator=g, device=DEVICE) * 0.6
                  + 0.1).clamp(0.02, 0.9),
        "valid": (torch.arange(MAX_GT, device=DEVICE) < N_VALID)[None].expand(BATCH, -1),
        "orig_size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE),
        "size": torch.tensor([[h - 96, w - 120]] * BATCH, device=DEVICE),
        "is_extra": torch.zeros(BATCH, dtype=torch.bool, device=DEVICE),
    }


# leaves whose gradients the kernel and plain runs compare: the encoder's
# first FFN and sampling offsets (behind K2-bwd and K1-bwd), a decoder
# cross-attention (K1-bwd or K3-bwd at the decoder), the class head and a
# backbone conv; the flagship's class head is the CLIP-text one, and its
# distillation head (clip_visual_proj) is read too
GRAD_LEAVES = ("encoder_layer0.ffn.linear1.weight", "encoder_layer5.ffn.linear2.weight",
               "encoder_layer0.self_attn.sampling_offsets.weight",
               "encoder_layer0.self_attn.value_proj.weight",
               "decoder_layer3.cross_attn.value_proj.weight", "cls_kernel",
               "backbone.layer4_block2.conv3.weight")
FLAGSHIP_LEAVES = GRAD_LEAVES[:5] + ("class_embed.dino_visual_proj.weight",
                                     "clip_visual_proj.weight", GRAD_LEAVES[6])
# launches a train step of K1, K1-bwd, K2, K2-bwd, K3, K3-bwd
COUNTED = ("K1", "K1-bwd", "K2", "K2-bwd", "K3", "K3-bwd")


def launch_counters():
    """The six kernels' counters, in the order of COUNTED and of the records."""
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    return (k1.ms_deform_attn, k1.ms_deform_attn_backward, k2.encoder_tail,
            k2.encoder_tail_backward, k3.ms_deform_attn_sep, k3.ms_deform_attn_sep_backward)


@contextlib.contextmanager
def plain_versions():
    """The plain versions in place of every kernel, at the modules' call sites."""
    from richsem_tpu_torch.models import dino, layers
    from richsem_tpu_torch.ops import fused_ffn as k2
    from richsem_tpu_torch.ops import ms_deform_attn as k1
    from richsem_tpu_torch.ops import ms_deform_attn_sep as k3

    layers.ms_deform_attn, layers.ms_deform_attn_sep = (k1.ms_deform_attn_plain,
                                                        k3.ms_deform_attn_sep_plain)
    dino.encoder_tail = k2.encoder_tail_plain
    try:
        yield
    finally:
        layers.ms_deform_attn, layers.ms_deform_attn_sep = (k1.ms_deform_attn,
                                                            k3.ms_deform_attn_sep)
        dino.encoder_tail = k2.encoder_tail


def run_train(cfg, want, n_steps, leaves, clip_model=None, text_embed=None):
    """Build the detector from seed 0, take one warm-up and ``n_steps`` train
    steps (launches checked against ``want`` a step), compare the gradients of
    ``leaves`` in one step against the same step with the plain versions, and
    profile one step. -> the launches of the six kernels over the steps."""
    import torch

    import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
    from richsem_tpu_torch.models import build_model
    from richsem_tpu_torch.ops import lap
    from richsem_tpu_torch.train.engine import (create_train_state, make_loss_fn,
                                                make_train_step, step_draws)
    from richsem_tpu_torch.train.optim import build_optimizer

    g = torch.Generator(device=DEVICE).manual_seed(0)
    t0 = time.perf_counter()
    model, _, _ = build_model("richsem", cfg, device=DEVICE, generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=1000),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, seed=0, device=DEVICE, clip_model=clip_model)
    batches = [train_batch(g) for _ in range(n_steps + 1)]
    m = step(state, batches[-1], text_embed)  # warm-up (cuDNN autotuning, allocator)
    torch.cuda.synchronize()
    print(f"  setup + warm-up step {time.perf_counter() - t0:.1f} s, loss {float(m['loss']):.4f}",
          flush=True)

    counters = launch_counters()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.launches = 0
    lap.batched_min_cost_assignment.rounds = 0
    times, metrics = [], []
    for batch in batches[:n_steps]:
        t = time.perf_counter()
        metrics.append(step(state, batch, text_embed))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = [c.launches for c in counters]
    rounds = lap.batched_min_cost_assignment.rounds
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, m in enumerate(metrics):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        distill = ""
        if clip_model is not None:
            distill = (f", loss_distill {float(m['loss_distill']):.4f}, "
                       f"loss_distill_dn {float(m['loss_distill_dn']):.4f}")
        print(f"  step {i}: loss {loss:.4f}, grad_norm {gnorm:.4f}, loss_ce {float(m['loss_ce']):.4f}, "
              f"loss_bbox {float(m['loss_bbox']):.4f}, loss_giou {float(m['loss_giou']):.4f}, "
              f"loss_ce_dn {float(m['loss_ce_dn']):.4f}{distill}, "
              f"class_error {float(m['class_error']):.2f}, "
              f"offset_beyond_margin {float(m['offset_beyond_margin']):.5f}")
        if not (bool(m["finite"]) and math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"train step {i}: loss or grad_norm is not finite")
        if clip_model is not None and not (float(m["loss_distill"]) > 0
                                           and math.isfinite(float(m["loss_distill_dn"]))):
            fail(f"train step {i}: loss_distill is not positive or loss_distill_dn not finite")
    want = [n * n_steps for n in want]
    print(f"  launches over {n_steps} steps: "
          + ", ".join(f"{k} {n}" for k, n in zip(COUNTED, launches))
          + f" (expect {want}); auction rounds {rounds} ({rounds / n_steps:.1f} a step, "
          "7 matchings)")
    if launches != want:
        fail("the train step did not launch the kernels as expected: "
             + ", ".join(f"{k} {n} of {w}" for k, n, w in zip(COUNTED, launches, want)))
    ms_step = statistics.median(times)
    print(f"  train step: {', '.join(f'{t:.2f}' for t in times)} ms/step; median "
          f"{ms_step:.2f} ms/step = {BATCH * 1e3 / ms_step:.3f} img/s; "
          f"peak memory {peak_gb:.2f} GB", flush=True)

    # The gradient of one step with the kernels against the same step with the
    # plain versions in place of all of them, same weights, batch and draws.
    loss_fn = make_loss_fn(model, cfg, clip_model)
    draws = step_draws(cfg, BATCH, torch.Generator(device=DEVICE).manual_seed(7), device=DEVICE)
    params = dict(model.named_parameters())

    def grads():
        model.zero_grad(set_to_none=True)
        total, _ = loss_fn(batches[0], draws, text_embed)
        total.backward()
        out = {n: params[n].grad.float().clone() for n in leaves}
        model.zero_grad(set_to_none=True)
        return float(total.detach()), out

    loss_k, g_k = grads()
    with plain_versions():
        loss_p, g_p = grads()
    torch.cuda.synchronize()
    print(f"  kernels vs plain versions, one step: loss {loss_k:.4f} vs {loss_p:.4f}")
    worst = 1.0
    for n in leaves:
        cos = float(torch.nn.functional.cosine_similarity(g_k[n].flatten(), g_p[n].flatten(), 0))
        worst = min(worst, cos)
        print(f"    grad cosine {cos:.5f}  {n}")
    # bf16 steps that round the other way in the kernels reorder some of the
    # 900 two-stage selections among near-tied random-weight scores (phase 6),
    # which moves the matching and the decoder's gradients; measured on an
    # H100: cosines 0.9896-0.9967 at this seed (phase 7)
    if worst < COS_MIN:
        fail(f"a gradient with the kernels departs from the plain one (cosine < {COS_MIN})")
    del g_k, g_p
    profile_once(lambda: step(state, batches[1], text_embed))
    return launches


def phase_train(recs):
    from richsem_tpu_torch.config import Config

    cfg = Config.fromfile(TRAIN_CONFIG)
    cfg.compute_dtype = "bfloat16"
    launches = run_train(cfg, (12, 12, 6, 6, 0, 0), N_STEPS, GRAD_LEAVES)
    for rec, n in zip(recs, launches):
        rec["dino_train_launches"] = n
    print("phase 7: train step ok", flush=True)


def phase_flagship(recs):
    """The flagship train step (richsem_4scale_lvis.py) with a random-weight bf16
    RN50 teacher and a random 1204 x 1024 text bank, as bench.py:114-126 builds
    them; then the same step with the separable decoder sampler (K3)."""
    import torch

    from richsem_tpu_torch.config import Config
    from richsem_tpu_torch.models.build import build_clip_teacher
    from richsem_tpu_torch.models.clip_align import (clip_spatial_features,
                                                     clip_teacher_box_targets)

    cfg = Config.fromfile(CONFIG)
    cfg.compute_dtype = "bfloat16"
    g = torch.Generator(device=DEVICE).manual_seed(2)
    teacher = build_clip_teacher(cfg, dtype=torch.bfloat16, device=DEVICE, generator=g)
    text_embed = torch.randn((cfg.num_classes, 1024), generator=g, device=DEVICE)
    batch = train_batch(g)

    def targets():
        spatial = clip_spatial_features(teacher, batch["images"])
        return clip_teacher_box_targets(
            teacher, batch["images"], batch["boxes"], batch["size"].float(), text_embed,
            teacher.logit_scale, valid=batch["valid"], max_boxes=cfg.distill_max_boxes,
            spatial=spatial)

    emb, logits, cvalid = targets()
    if not (torch.isfinite(emb).all() and torch.isfinite(logits).all()):
        fail("the teacher's box targets are not finite")
    teacher_ms = cuda_ms(targets, iters=5, warmup=1)
    print(f"  teacher: spatial forward + RoIAlign + attention pool at {int(cvalid.sum())} "
          f"boxes {teacher_ms:.3f} ms (CUDA events), embeddings {tuple(emb.shape)}, "
          f"logits {tuple(logits.shape)}", flush=True)
    del emb, logits, cvalid
    profile_once(targets, top=6)

    launches = run_train(cfg, (12, 12, 6, 6, 0, 0), N_STEPS, FLAGSHIP_LEAVES,
                         clip_model=teacher, text_embed=text_embed)
    for rec, n in zip(recs[:4], launches):
        rec["launches"] = n
    print("phase 10: flagship train step ok", flush=True)
    torch.cuda.empty_cache()

    cfg.dec_msda_impl = "sep_pallas"
    launches = run_train(cfg, (6, 6, 6, 6, 6, 6), N_SEP_STEPS, FLAGSHIP_LEAVES,
                         clip_model=teacher, text_embed=text_embed)
    for rec, n in zip(recs[4:], launches[4:]):
        rec["launches"] = n
    for rec, n in zip(recs, launches):
        rec["sep_pallas_launches"] = n
    print('phase 11: flagship train step with dec_msda_impl="sep_pallas" ok', flush=True)


def probe_bounds():
    """The H100 bound of each TPU probe still to port (tools/, PERF.md kernel
    table rows 7-9) at the arguments its main() passes: operations over the
    f32 CUDA-core or the bf16 tensor-core peak, bytes (inputs read once, the
    output written once) over the HBM rate. Elementwise bf16 is counted at the
    f32 CUDA-core rate. Arithmetic only: -> [(row, call, bound_ms, by)]."""
    out = []

    def add(row, call, nbytes_, f32_ops=0.0, bf16_mma=0.0):
        t_ops = max(f32_ops / F32_FLOPS, bf16_mma / BF16_FLOPS) * 1e3
        t_bytes = nbytes_ / HBM_BPS * 1e3
        out.append((row, call, *((t_bytes, "bytes") if t_bytes >= t_ops
                                  else (t_ops, "operations"))))

    rows, s = 768, 1664  # bench_pallas_cal.py:37
    for name, size in (("float32", 4), ("bfloat16", 2)):  # 6 ops an element a rep
        add(7, f"run_vpu({name}, reps=512)", 3 * rows * s * size, f32_ops=6 * rows * s * 512)
    for k, d in ((768, 128), (768, 32), (96, 32), (96, 128)):
        add(7, f"run_mxu({k}, {s}, {d}, bfloat16, reps=512)", 2 * (k * s + s * d) + 4 * k * d,
            f32_ops=k * s * 512, bf16_mma=2 * k * s * d * 512)
    for n in (4096, 16384):
        add(7, f"run_grid_overhead({n})", 2 * n * 8 * 128 * 4, f32_ops=n * 8 * 128)
    for name, size in (("float32", 4), ("bfloat16", 2)):  # [768, 32] -> [768, 32 * 52]
        add(7, f"run_repeat({name})", (rows * 32 + rows * 32 * 52) * size,
            f32_ops=256 * (rows * 32 + rows * 32 * 52))
    mk, p, dd = 8 * 352, 4, 32  # bench_cell.py:31-34: windows sum wy*wx = 1636, wy = 78
    win, side = 1636, 78
    for mode in ("2d", "flat"):  # per rep: the hats (~9 ops a tap), outer product and P-sum
        add(8, f"run_cell({mode!r}, reps=64)",
            3 * mk * 4 * p * 4 + 2 * 8 * dd * win + 4 * 8 * 352 * dd,
            f32_ops=64 * mk * (9 * p * side + (2 * p - 1) * win),
            bf16_mma=64 * 2 * mk * dd * win)
    add(8, "check_repeat_semantics()", 8 * 8 * 4 + 8 * 16 * 4)
    elems = 154 * 8 * 28 * 32 * 384  # bench_vpu_model.py:30-31
    for n in (1, 2, 4, 8):
        add(9, f"chain-{n}", 2 * elems * 4, f32_ops=n * elems)
    hyx = 154 * 8 * (28 + 32) * 4 * 384 * 4  # the two hat inputs, f32
    for name, n_ops in (("fma-1", 1), ("fma-2", 3), ("fma-4", 7), ("fma-4-2acc", 7),
                        ("fma-4-chunk", 7)):
        add(9, name, hyx + elems * 4, f32_ops=n_ops * elems)
    return out


# the __global__ functions of richsem_tpu_torch/csrc (K2-bwd is three of them)
HAND_WRITTEN = ("msda_fwd_kernel", "msda_bwd_kernel", "encoder_tail_fwd_kernel",
                "row_block_kernel", "atb_kernel", "colsum_kernel", "msda_sep_fwd_kernel",
                "msda_sep_bwd_kernel")


def profile_once(fn, top: int = 12):
    """Device time by kernel over one call of ``fn`` (torch.profiler / CUPTI):
    the busiest ``top`` kernels, then every hand-written one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [e for e in prof.key_averages() if getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        print("  profile: no device time recorded (not measured)")
        return
    print(f"  profile: device busy {total_us / 1e3:.2f} ms of a {wall_ms:.2f} ms call "
          f"(idle share {max(0.0, 1 - total_us / 1e3 / wall_ms):.3f}), "
          f"{sum(e.count for e in rows)} device operations; top kernels:")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    mine = [(k, e) for e in rows for k in HAND_WRITTEN if f"::{k}" in e.key]
    if mine:
        print("    hand-written: " + "; ".join(
            f"{k} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for k, e in mine))


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
    bounds = probe_bounds()
    for r in sorted({b[0] for b in bounds}):
        print(f"  bounds of the TPU probes still to port, row {r}: " + "; ".join(
            f"{call} {bms:.4g} ms ({by})" for row, call, bms, by in bounds if row == r))
    value, cases = k1_cases()
    k1_rec = phase_k1(value, cases)
    k1b_rec = phase_k1_bwd(value, cases)
    k3_rec = phase_k3(value, *cases["decoder"])
    k3b_rec = phase_k3_bwd(value, *cases["decoder"])
    del value, cases
    args, dy = k2_args()
    k2_rec = phase_k2(args)
    k2b_rec = phase_k2_bwd(args, dy)
    del args, dy
    torch.cuda.empty_cache()
    recs = [k1_rec, k1b_rec, k2_rec, k2b_rec, k3_rec, k3b_rec]
    if sys.argv[1:] != ["kernels"]:
        phase_eval(k1_rec, k2_rec)
        torch.cuda.empty_cache()
        phase_train(recs)
        torch.cuda.empty_cache()
        phase_flagship(recs)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(smi)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
