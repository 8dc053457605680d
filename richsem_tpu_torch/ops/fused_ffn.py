"""Encoder-layer tail: residual+LN1 -> FFN -> residual+LN2 (counterpart of ``richsem_tpu/ops/fused_ffn.py``).

    x  = LN1(src + attn_out)        f32 statistics (mean, mean of squares)
    h1 = relu(x @ W1 + b1)          matmul in ``cdt`` with f32 accumulation, then
    h2 = h1 @ W2 + b2               cast; bias adds in ``cdt``
    y  = LN2(x + h2)

* :func:`encoder_tail` -- the public op. On CUDA tensors it is a
  ``torch.autograd.Function``: the forward launches the hand-written kernel K2
  (``csrc/fused_encoder_tail_fwd.cu``), which keeps the [N, F] hidden on chip,
  and saves only its inputs; the backward launches K2-bwd
  (``csrc/fused_encoder_tail_bwd.cu``), which recomputes the hidden. On CPU
  tensors it runs :func:`encoder_tail_plain`, whose gradient is autograd's.
* :func:`encoder_tail_plain` -- the plain PyTorch version; it mirrors
  ``xla_encoder_tail`` (``fused_ffn.py:269-286``) cast for cast.

K2-bwd's cast points are those of the TPU kernel's backward
(``richsem_tpu/ops/fused_ffn.py:_bwd_kernel``): ``du2`` cast to bf16, the relu
mask from the recomputed ``h1``, ``dh1 = bf16(du2c @ W2)`` masked, ``db1``
from the bf16 ``dh1``, ``db2`` from the f32 ``du2``, ``dx_ffn = dh1 @ W1`` and
the weight gradients accumulated in f32; it returns ``du1`` for both ``src``
and ``attn_out`` and every parameter gradient in the parameter's dtype.

Weights come in ``nn.Linear``'s (out, in) layout: ``w1 [F, d]``, ``w2 [d, F]``
(the transposes of the flax kernels).
"""

from __future__ import annotations

import ctypes

import torch

from richsem_tpu_torch.ops import _build


def _ln(u: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in f32 from the mean and the mean of squares (flax's fast variance)."""
    mean = u.mean(dim=-1, keepdim=True)
    var = (u * u).mean(dim=-1, keepdim=True) - mean * mean
    return (u - mean) * torch.rsqrt(var + eps) * scale + bias


def encoder_tail_plain(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                       eps: float, cdt: torch.dtype) -> torch.Tensor:
    """Plain PyTorch tail. src/attn_out [N, d] f32 -> [N, d] f32."""
    x = _ln(src + attn_out, s1.float(), sb1.float(), eps)
    h1 = torch.relu((x.to(cdt) @ w1.to(cdt).t()) + b1.to(cdt))
    h2 = ((h1 @ w2.to(cdt).t()) + b2.to(cdt)).float()
    return _ln(x + h2, s2.float(), sb2.float(), eps)


_K2 = "fused_encoder_tail_fwd"
_K2_BWD = "fused_encoder_tail_bwd"


def _k2_lib() -> ctypes.CDLL:
    lib = _build.load(_K2)
    if lib.encoder_tail_fwd.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr in ((lib.encoder_tail_fwd, 11), (lib.encoder_tail_fwd_transients, 13)):
            fn.argtypes = [ptr] * n_ptr + [i32, i32, i32, ctypes.c_float, ptr]
            fn.restype = ctypes.c_int
    return lib


def _k2_bwd_lib() -> ctypes.CDLL:
    lib = _build.load(_K2_BWD)
    fn = lib.encoder_tail_bwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 23 + [i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        lib.encoder_tail_bwd_splits.argtypes = [i32]
        lib.encoder_tail_bwd_splits.restype = i32
    return lib


def _cuda_args(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2, cdt):
    """Checks and casts for K2 and K2-bwd -> the ten contiguous kernel inputs."""
    if cdt != torch.bfloat16:
        raise NotImplementedError(
            f"K2 computes in bfloat16 only; got compute dtype {cdt}: set "
            "enc_fused_tail=False to run the encoder tail as its modules' composition"
        )
    if src.dtype != torch.float32 or attn_out.dtype != torch.float32:
        raise TypeError("K2 takes float32 src and attn_out")
    if attn_out.device != src.device:
        raise ValueError("src and attn_out must share a device")
    n, d = src.shape
    f = w1.shape[0]
    if attn_out.shape != (n, d) or w1.shape != (f, d) or w2.shape != (d, f):
        raise ValueError(
            f"bad shapes: src {tuple(src.shape)}, attn_out {tuple(attn_out.shape)}, "
            f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}"
        )
    if d != 256 or f % 64 or f > 4096:
        raise ValueError(f"K2 needs d == 256, F % 64 == 0 and F <= 4096, got d={d}, F={f}")
    dev = src.device
    args = [src, attn_out]
    args += [t.to(device=dev, dtype=torch.bfloat16) for t in (w1, b1, w2, b2)]
    args += [t.to(device=dev, dtype=torch.float32) for t in (s1, sb1, s2, sb2)]
    return [t.contiguous() for t in args]


def _encoder_tail_cuda(args, eps, transients=None):
    """K2 on the checked inputs of :func:`_cuda_args`. A ``transients`` dict
    receives the kernel's bf16 x [N, d] and bf16 h1 [N, F] (after the relu),
    which chip_smoke.py compares with the plain version's; y is the same."""
    src = args[0]
    n, d = src.shape
    f = args[2].shape[0]
    out = torch.empty(n, d, dtype=torch.float32, device=src.device)
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
    lib = _k2_lib()
    fn = lib.encoder_tail_fwd
    if transients is not None:
        xb = torch.empty(n, d, dtype=torch.bfloat16, device=src.device)
        h1 = torch.empty(n, f, dtype=torch.bfloat16, device=src.device)
        transients.update(xb=xb, h1=h1)
        ptrs += [xb.data_ptr(), h1.data_ptr()]
        fn = lib.encoder_tail_fwd_transients
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, n, d, f, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K2 fused_encoder_tail_fwd launch failed: CUDA error {err}")
    encoder_tail.launches += 1
    return out


def _check_bwd_width(f: int) -> None:
    # the row pass walks the hidden in 64-wide chunks, two at a time, and keeps
    # the relu mask of at most 32 chunks on chip
    if f % 128 or f > 2048:
        raise ValueError(f"K2-bwd needs F % 128 == 0 and F <= 2048, got F={f}")


def _encoder_tail_bwd_cuda(args, eps, dy, transients=None):
    """K2-bwd on the checked inputs of :func:`_cuda_args` and the f32 upstream
    gradient -> f32 (du1, dw1, db1, dw2, db2, ds1, dsb1, ds2, dsb2).

    Transients: bf16 x, h1, dh1 and du2 (rows padded to the 128-row block) that
    the row pass writes for the weight-gradient products (461 MB at
    N = 49,980, F = 2048), the per-block column sums (5.2 MB), and the f32
    partials of dW1 and dW2 of up to 4 row splits (16.8 MB). A ``transients``
    dict receives the first N rows of bf16 x and h1 (chip_smoke.py phase 5
    counts where they differ from the plain version's)."""
    src = args[0]
    n, d = src.shape
    f = args[2].shape[0]
    _check_bwd_width(f)
    dev = src.device
    n_blk = (n + 127) // 128
    n_pad = n_blk * 128
    lib = _k2_bwd_lib()
    splits = lib.encoder_tail_bwd_splits(n)
    dy = dy.to(torch.float32).contiguous()
    bf16 = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    du1 = torch.empty(n, d, **f32)
    xb, du2c = torch.empty(n_pad, d, **bf16), torch.empty(n_pad, d, **bf16)
    h1, dh1 = torch.empty(n_pad, f, **bf16), torch.empty(n_pad, f, **bf16)
    part_vec = torch.empty(n_blk, 5 * d, **f32)  # ds1, dsb1, ds2, dsb2, db2
    part_db1 = torch.empty(n_blk, f, **f32)
    part_dw = torch.empty(2 * splits, d * f, **f32)  # dW1 (as [F, d]), then dW2
    dw1, dw2 = torch.empty(f, d, **f32), torch.empty(d, f, **f32)
    vec, db1 = torch.empty(5 * d, **f32), torch.empty(f, **f32)
    ptrs = [t.data_ptr() for t in (*args, dy, du1, xb, h1, dh1, du2c, part_vec,
                                   part_db1, part_dw, dw1, dw2, vec, db1)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.encoder_tail_bwd(*ptrs, n, d, f, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K2-bwd fused_encoder_tail_bwd launch failed: CUDA error {err}")
    encoder_tail_backward.launches += 1
    if transients is not None:
        transients.update(xb=xb[:n], h1=h1[:n])
    ds1, dsb1, ds2, dsb2, db2 = vec.view(5, d).unbind(0)
    return du1, dw1, db1, dw2, db2, ds1, dsb1, ds2, dsb2


class _EncoderTailFn(torch.autograd.Function):
    """K2 forward, K2-bwd backward; saves only the inputs (no [N, F] hidden)."""

    @staticmethod
    def forward(ctx, src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2, eps, cdt):
        args = _cuda_args(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2, cdt)
        ctx.eps = eps
        ctx.dtypes = [t.dtype for t in (w1, b1, w2, b2, s1, sb1, s2, sb2)]
        ctx.save_for_backward(*args)
        return _encoder_tail_cuda(args, eps)

    @staticmethod
    def backward(ctx, dy):
        du1, *grads = _encoder_tail_bwd_cuda(list(ctx.saved_tensors), ctx.eps, dy)
        grads = [g.to(dt) for g, dt in zip(grads, ctx.dtypes)]
        return (du1, du1, *grads, None, None)


def encoder_tail(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                 eps: float, cdt: torch.dtype) -> torch.Tensor:
    """y = LN2(x + FFN(x)), x = LN1(src + attn_out): K2 (and K2-bwd) on CUDA,
    plain on CPU."""
    if src.device.type == "cpu":
        return encoder_tail_plain(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                                  eps, cdt)
    if src.device.type != "cuda":
        raise RuntimeError(f"encoder_tail: no kernel for device {src.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2)):
        _check_bwd_width(w1.shape[0])  # fail before the forward, not in the backward
    return _EncoderTailFn.apply(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                                eps, cdt)


def encoder_tail_backward(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                          eps: float, cdt: torch.dtype, dy: torch.Tensor,
                          transients: dict | None = None):
    """K2-bwd called directly -> (du1, dw1, db1, dw2, db2, ds1, dsb1, ds2, dsb2),
    f32, weights in nn.Linear layout. CUDA tensors only. ``transients``: see
    :func:`_encoder_tail_bwd_cuda`."""
    if src.device.type != "cuda":
        raise RuntimeError(f"encoder_tail_backward: no kernel for device {src.device}")
    args = _cuda_args(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2, cdt)
    return _encoder_tail_bwd_cuda(args, eps, dy, transients)


encoder_tail.launches = 0  # K2 launches; chip_smoke.py reads and resets it
encoder_tail_backward.launches = 0  # K2-bwd launches, whichever way it is reached
