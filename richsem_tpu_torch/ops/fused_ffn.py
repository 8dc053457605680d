"""Encoder-layer tail: residual+LN1 -> FFN -> residual+LN2 (counterpart of ``richsem_tpu/ops/fused_ffn.py``).

    x  = LN1(src + attn_out)        f32 statistics (mean, mean of squares)
    h1 = relu(x @ W1 + b1)          matmul in ``cdt`` with f32 accumulation, then
    h2 = h1 @ W2 + b2               cast; bias adds in ``cdt``
    y  = LN2(x + h2)

* :func:`encoder_tail` -- the public op. On CUDA tensors it launches the
  hand-written kernel K2 (``csrc/fused_encoder_tail_fwd.cu``), which keeps the
  [N, F] hidden on chip; on CPU tensors it runs :func:`encoder_tail_plain`.
* :func:`encoder_tail_plain` -- the plain PyTorch version; it mirrors
  ``xla_encoder_tail`` (``fused_ffn.py:269-286``) cast for cast.

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


def _k2_lib() -> ctypes.CDLL:
    lib = _build.load(_K2)
    fn = lib.encoder_tail_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 11 + [i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return lib


def _encoder_tail_cuda(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2, eps, cdt):
    if cdt != torch.bfloat16:
        raise NotImplementedError(
            f"K2 computes in bfloat16 only; got compute dtype {cdt}"
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
    if d != 256 or f % 64:
        raise ValueError(f"K2 needs d == 256 and F % 64 == 0, got d={d}, F={f}")
    dev = src.device
    args = [src, attn_out]
    args += [t.to(device=dev, dtype=torch.bfloat16) for t in (w1, b1, w2, b2)]
    args += [t.to(device=dev, dtype=torch.float32) for t in (s1, sb1, s2, sb2)]
    args = [t.contiguous() for t in args]
    out = torch.empty(n, d, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _k2_lib().encoder_tail_fwd(
            *[t.data_ptr() for t in args], out.data_ptr(), n, d, f, float(eps), stream
        )
    if err != 0:
        raise RuntimeError(f"K2 fused_encoder_tail_fwd launch failed: CUDA error {err}")
    encoder_tail.launches += 1
    return out


def encoder_tail(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                 eps: float, cdt: torch.dtype) -> torch.Tensor:
    """y = LN2(x + FFN(x)), x = LN1(src + attn_out): K2 on CUDA, plain on CPU."""
    if src.device.type == "cpu":
        return encoder_tail_plain(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                                  eps, cdt)
    if src.device.type != "cuda":
        raise RuntimeError(f"encoder_tail: no kernel for device {src.device}")
    return _encoder_tail_cuda(src, attn_out, w1, b1, w2, b2, s1, sb1, s2, sb2,
                              eps, cdt)


encoder_tail.launches = 0  # K2 launches; chip_smoke.py reads and resets it
