"""Multi-scale deformable attention (counterpart of ``richsem_tpu/ops/ms_deform_attn.py``).

* :func:`ms_deform_attn` -- the public op, the dispatcher op
  ``richsem_tpu_torch::msda_out`` (:func:`msda_out`, with its autograd), whose
  output the encoder's selective checkpoint keeps (``enc_selective_remat``).
  On a CUDA tensor its forward launches the hand-written kernel K1
  (``csrc/ms_deform_attn_fwd.cu``), saves only ``(value, loc, aw)``, and its
  backward launches K1-bwd (``csrc/ms_deform_attn_bwd.cu``). On a CPU tensor it
  runs :func:`ms_deform_attn_plain`, and its backward is autograd's gradient of
  that plain version, run again from the saved inputs. Nothing else: a CUDA
  call that cannot launch raises.
* :func:`ms_deform_attn_plain` -- the plain PyTorch version, the exact gather
  of the JAX package (``_tap_geometry`` + flat take): pixel = ``loc*size - 0.5``
  and zero-padded taps, accumulated in float32. The value is gathered in
  float32 too, so autograd folds d_value in float32 and casts it once, as
  K1-bwd does.
* :func:`ms_deform_attn_dvalue_plain` -- K1-bwd's d_value as its deterministic
  pass computes it (``csrc/msda_dvalue.cuh``), in plain PyTorch: the same
  terms, rounded as the kernel rounds them, summed in 64-bit fixed point
  (:func:`fixed_point_dvalue`), so bit for bit the kernel's on any device.
  The tests and ``chip_smoke.py`` hold the kernel to it; no path runs it.
* :func:`compute_sampling_locations` -- reference points + offsets -> locations.
* :func:`tiled_supported` -- the windowing plan test of
  ``richsem_tpu/ops/ms_deform_attn_tiled.py``; the port only needs it for the
  encoder's offset-clamp rule (``models/layers.py``).

Shapes (B batch, S = sum H_l W_l tokens, M heads, D head dim, Q queries,
L levels, P points): value ``[B,S,M,D]``, sampling_locations
``[B,Q,M,L,P,2]`` (x, y) in [0, 1], attention_weights ``[B,Q,M,L,P]``
-> output ``[B,Q,M*D]`` in the value's dtype.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from richsem_tpu_torch.ops import _build


def tiled_supported(
    spatial_shapes: Sequence[Tuple[int, int]], tile: Tuple[int, int] = (16, 16)
) -> bool:
    """Whether the JAX windowed kernels can tile this pyramid.

    The rule of ``richsem_tpu/ops/ms_deform_attn_tiled.py:_plan``: one tile
    grid is shared by every level, so level ``a`` takes the tile
    ``(qh*Ha/H0, qw*Wa/W0)``, which must be integral and at least 1.
    """
    qh0, qw0 = tile
    h0, w0 = spatial_shapes[0]
    for h, w in spatial_shapes:
        qh = qh0 * h / h0
        qw = qw0 * w / w0
        if qh < 1 or qw < 1 or qh != int(qh) or qw != int(qw):
            return False
    return True


@functools.lru_cache(maxsize=None)
def _level_sizes(spatial_shapes: Tuple[Tuple[int, int], ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """``[[W_l, H_l], ...]`` on ``device``, copied there once for each pyramid,
    dtype and device, so that a forward (or a CUDA graph's capture of it)
    makes no host-to-device copy. Made outside inference mode, so that a
    training forward may use it after an eval one."""
    with torch.inference_mode(False):
        return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=dtype, device=device)


def compute_sampling_locations(
    reference_points: torch.Tensor,  # [B, Q, L, 2 or 4]
    sampling_offsets: torch.Tensor,  # [B, Q, M, L, P, 2]
    spatial_shapes: Sequence[Tuple[int, int]],
    n_points: int,
) -> torch.Tensor:
    """2-d refs: offsets in level pixels, normalized by (W_l, H_l).
    4-d refs (cx, cy, w, h): offsets in units of half the box over the point count."""
    if reference_points.shape[-1] == 2:
        normalizer = _level_sizes(tuple((int(h), int(w)) for h, w in spatial_shapes),
                                  sampling_offsets.dtype, sampling_offsets.device)
        return (
            reference_points[:, :, None, :, None, :]
            + sampling_offsets / normalizer[None, None, None, :, None, :]
        )
    if reference_points.shape[-1] == 4:
        ref = reference_points[:, :, None, :, None, :]
        return ref[..., :2] + sampling_offsets / n_points * ref[..., 2:] * 0.5
    raise ValueError(
        f"reference_points last dim must be 2 or 4, got {reference_points.shape[-1]}"
    )


def _check(value, spatial_shapes, loc, aw):
    b, s, m, d = value.shape
    if loc.dim() != 6 or loc.shape[-1] != 2 or aw.shape != loc.shape[:-1]:
        raise ValueError(
            f"bad shapes: loc {tuple(loc.shape)}, attention {tuple(aw.shape)}"
        )
    if loc.shape[0] != b or loc.shape[2] != m:
        raise ValueError("batch / head mismatch between value and locations")
    if len(spatial_shapes) != loc.shape[3]:
        raise ValueError("level count mismatch")
    if sum(h * w for h, w in spatial_shapes) != s:
        raise ValueError(
            f"spatial_shapes {spatial_shapes} do not sum to token count {s}"
        )


def ms_deform_attn_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Exact zero-padded bilinear gather in plain PyTorch (float32 accumulation)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    b, s, m, d = value.shape
    q, p = sampling_locations.shape[1], sampling_locations.shape[4]
    cdt = torch.promote_types(value.dtype, torch.float32)
    dev = value.device
    flat = value.to(cdt).permute(0, 2, 1, 3).reshape(b * m * s, d)  # row (b, m, token)
    row0 = (
        torch.arange(b, device=dev)[:, None] * m + torch.arange(m, device=dev)[None, :]
    ) * s  # [B, M]
    row0 = row0[:, None, :, None, None]
    out = torch.zeros(b, q, m, d, dtype=cdt, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lvl].to(cdt)  # [B, Q, M, P, 2]
        # the clamp only moves samples that are out of bounds anyway, and keeps
        # the integer casts in range
        x = (loc[..., 0] * w - 0.5).clamp(-2.0, w + 1.0)
        y = (loc[..., 1] * h - 0.5).clamp(-2.0, h + 1.0)
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        dx = x - x0
        dy = y - y0
        x0i = x0.long()
        y0i = y0.long()
        xs = torch.stack([x0i, x0i + 1, x0i, x0i + 1], dim=-1)
        ys = torch.stack([y0i, y0i, y0i + 1, y0i + 1], dim=-1)
        bilin = torch.stack(
            [(1 - dy) * (1 - dx), (1 - dy) * dx, dy * (1 - dx), dy * dx], dim=-1
        )
        valid = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        wts = torch.where(valid, bilin, bilin.new_zeros(()))
        wts = wts * attention_weights[:, :, :, lvl].to(cdt)[..., None]  # [B,Q,M,P,4]
        idx = ys.clamp(0, h - 1) * w + xs.clamp(0, w - 1) + start + row0
        # a gather along rows: its backward adds into d_value in a fixed order
        # on the CPU (an indexed read's backward adds with atomics across threads)
        rows = idx.reshape(-1, 1).expand(-1, d)
        taps = torch.gather(flat, 0, rows).reshape(b, q, m, p * 4, d)
        out += (wts.reshape(b, q, m, p * 4, 1) * taps).sum(dim=3)
        start += h * w
    return out.reshape(b, q, m * d).to(value.dtype)


F32_MAX = 3.4028234663852886e38


def _abs_bits_max(x: torch.Tensor) -> torch.Tensor:
    """The largest |x| of a float32 tensor as its bits (int32, 0 when empty):
    as integers every finite |x| lies below +inf, below NaN, as the kernels'
    ``abs_bits`` maxima order them."""
    bits = x.float().reshape(-1).view(torch.int32) & 0x7FFFFFFF
    return bits.max() if bits.numel() else bits.new_zeros(())


def _pow2(p: torch.Tensor) -> torch.Tensor:
    """2^p for int p in [-126, 127], from the bits (``msda_dvalue.cuh:pow2``)."""
    return ((p.int() + 127) << 23).view(torch.float32)


def dv_shift(bound: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``msda_dvalue.cuh:dv_shift``: the shift k of a row's fixed-point sums
    for n >= 1 terms under a finite bound > 0 (float32, 0-d): 61 - c - e, with
    n <= 2^c and bound < 2^e (frexp's exponent). -> int64 like ``n``."""
    _, e = torch.frexp(bound.float())
    _, c = torch.frexp((n - 1).clamp(min=0).double())  # (n - 1).bit_length()
    return 61 - c.long() - e.long()


def fixed_point_dvalue(value: torch.Tensor, rows: List[torch.Tensor], terms_of,
                       g_bits: torch.Tensor, f_bits: torch.Tensor) -> torch.Tensor:
    """The deterministic d_value pass of K1-bwd and K3-bwd (``csrc/msda_dvalue.cuh``)
    in plain PyTorch, on the device of its inputs.

    ``rows[i]`` holds the value row ((b * S + s) * M + m) of each entry of
    chunk i and ``terms_of(i)`` its float32 terms [entries, D]; ``g_bits`` and
    ``f_bits`` are the call's largest |g| and largest factor bound as bits
    (:func:`_abs_bits_max`). Each row's shift comes from its count of entries n
    and the bound max|g| * the largest factor bound (:func:`dv_shift`, 0 for a
    bound of 0); each term, times 2^k (two exact float32 products), is rounded
    to the nearest integer (ties to even), the int64 rows summed with
    ``index_add_`` (exact, so in any order), each sum rounded once to float32,
    times 2^-k, and once to the value's dtype. A row with no entry is 0; where
    the bound is not finite, every element of a row with an entry is a quiet
    NaN with the kernel's bits. -> d_value like ``value``."""
    b, s, m, d = value.shape
    n_rows, dev = b * s * m, value.device
    n = torch.zeros(n_rows, dtype=torch.int64, device=dev)
    for r in rows:
        n += torch.bincount(r, minlength=n_rows)
    bound = g_bits.view(torch.float32) * f_bits.view(torch.float32)
    finite = bool(bound <= F32_MAX)
    k = torch.where(n > 0, dv_shift(bound, n), 0) if bool(bound != 0) else torch.zeros_like(n)
    acc = torch.zeros(n_rows, d, dtype=torch.int64, device=dev)
    if finite:
        for i, r in enumerate(rows):
            kr = k[r]
            hi = kr.clamp(max=127)
            scaled = terms_of(i) * _pow2(hi)[:, None] * _pow2(kr - hi)[:, None]
            acc.index_add_(0, r, torch.round(scaled).long())
    a = (-k).clamp(min=-126)
    out = acc.float() * _pow2(a)[:, None] * _pow2(-k - a)[:, None]
    out = out.to(value.dtype)
    if not finite:
        ints = out.view(torch.int32 if value.dtype == torch.float32 else torch.int16)
        ints[n > 0] = 0x7FFFFFFF if value.dtype == torch.float32 else 0x7FFF
    return out.reshape(b, s, m, d)


def ms_deform_attn_dvalue_plain(value, spatial_shapes, sampling_locations, attention_weights,
                                grad_out):
    """K1-bwd's d_value, bit for bit (``csrc/ms_deform_attn_bwd.cu``), in plain
    PyTorch: a tap whose corners touch its level (``inside``) gives each
    in-level corner e the terms ``g * (w_e * a)``, every product rounded to
    float32 as the kernel rounds it; the factor bound is max_e |w_e a| over
    those taps, max|g| over the rows (b, q, m) with such a tap; summed by
    :func:`fixed_point_dvalue`. Any device."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    b, s, m, d = value.shape
    loc, aw = sampling_locations.float(), attention_weights.float()
    q = loc.shape[1]
    g = grad_out.to(value.dtype).float().reshape(b * q * m, d)
    keyed_rows = torch.zeros(b, q, m, dtype=torch.bool, device=value.device)
    f_bits = torch.zeros((), dtype=torch.int32, device=value.device)
    rows, chunks = [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # [B, Q, M, P]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
        keyed_rows |= inside.any(-1)
        x0, y0 = torch.floor(x), torch.floor(y)
        dx, dy = x - x0, y - y0
        a = aw[:, :, :, lvl]
        fac = [(1 - dy) * (1 - dx) * a, (1 - dy) * dx * a, dy * (1 - dx) * a, dy * dx * a]
        bound = torch.fmax(torch.fmax(fac[0].abs(), fac[1].abs()),
                           torch.fmax(fac[2].abs(), fac[3].abs()))
        f_bits = torch.maximum(f_bits, _abs_bits_max(bound[inside]))
        for e in range(4):
            cx, cy = x0.long() + (e & 1), y0.long() + (e >> 1)
            bi, qi, mi, pi = torch.nonzero(
                inside & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h), as_tuple=True)
            rows.append((bi * s + start + cy[bi, qi, mi, pi] * w + cx[bi, qi, mi, pi]) * m + mi)
            chunks.append(((bi * q + qi) * m + mi, fac[e][bi, qi, mi, pi]))
        start += h * w
    g_bits = _abs_bits_max(g[keyed_rows.reshape(-1)])
    return fixed_point_dvalue(value, rows, lambda i: g[chunks[i][0]] * chunks[i][1][:, None],
                              g_bits, f_bits)


_K1 = "ms_deform_attn_fwd"
_K1_BWD = "ms_deform_attn_bwd"


def _lib(name: str, fn_name: str, n_ptr: int) -> ctypes.CDLL:
    lib = _build.load(name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * n_ptr + [i32] * 7 + [
            ctypes.POINTER(ctypes.c_int), i32, ptr,
        ]
        fn.restype = ctypes.c_int
    return lib


def _bwd_lib(name: str, fn_name: str) -> ctypes.CDLL:
    """A backward kernel's library: ``fn_name(value, loc, aw, g, d_value, d_loc,
    d_aw, workspace, its words, B, S, Q, M, D, L, P, shapes, bf16, stream)`` and
    ``fn_name_workspace(B, S, Q, M, L, P, shapes)``, the workspace's int32 words."""
    lib = _build.load(name)
    fn, words = getattr(lib, fn_name), getattr(lib, f"{fn_name}_workspace")
    if fn.argtypes is None:
        ptr, i32, shapes = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ptr] * 8 + [ctypes.c_longlong] + [i32] * 7 + [shapes, i32, ptr]
        fn.restype = ctypes.c_int
        words.argtypes = [i32] * 6 + [shapes]
        words.restype = ctypes.c_longlong
    return lib


def backward_launch(name: str, fn_name: str, kernel: str, value, spatial_shapes, loc, aw,
                    grad_out):
    """Launch a deformable-attention backward kernel (K1-bwd or K3-bwd) on
    checked CUDA tensors -> (d_value in the value's dtype, d_loc, d_aw). The
    kernel writes every d_value element once; its d_value pass takes an int32
    workspace of the words the library asks for (the value rows' 64-bit
    integers first: the allocation's start is aligned)."""
    grad_out = grad_out.to(value.dtype).contiguous()
    d_value = torch.empty_like(value)
    d_loc = torch.empty_like(loc)
    d_aw = torch.empty_like(aw)
    b, s, q, m, d, n_lvl, p, shapes, bf16 = _shape_args(value, loc, spatial_shapes)
    lib = _bwd_lib(name, fn_name)
    words = getattr(lib, f"{fn_name}_workspace")(b, s, q, m, n_lvl, p, shapes)
    if words < 0:
        raise ValueError(f"{kernel}: spatial_shapes {spatial_shapes} do not hold {s} tokens")
    ws = torch.empty(words, dtype=torch.int32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(
            value.data_ptr(), loc.data_ptr(), aw.data_ptr(), grad_out.data_ptr(),
            d_value.data_ptr(), d_loc.data_ptr(), d_aw.data_ptr(), ws.data_ptr(), words,
            b, s, q, m, d, n_lvl, p, shapes, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} {name} launch failed: CUDA error {err}")
    return d_value, d_loc, d_aw


K1_HEAD_DIM = 32  # the forward kernels' lanes hold eight channels each, the backward's four


def _check_head_dim(value, kernels: str = "K1 and K1-bwd"):
    if value.shape[-1] != K1_HEAD_DIM:
        raise ValueError(
            f"{kernels} take a head dim of {K1_HEAD_DIM}, got {value.shape[-1]}")


def _check_cuda(value, loc, aw, kernel: str = "K1"):
    if value.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{kernel} takes a bf16 or f32 value, got {value.dtype}")
    if loc.dtype != torch.float32 or aw.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32 sampling locations and attention weights")
    if not (loc.device == aw.device == value.device):
        raise ValueError("value, locations and attention weights must share a device")


def _shape_args(value, loc, spatial_shapes):
    b, s, m, d = value.shape
    _, q, _, n_lvl, p, _ = loc.shape
    shapes = (ctypes.c_int * (2 * n_lvl))(*[v for hw in spatial_shapes for v in hw])
    return (b, s, q, m, d, n_lvl, p, shapes, int(value.dtype == torch.bfloat16))


def _ms_deform_attn_cuda(value, spatial_shapes, loc, aw):
    """K1: the forward gather. value/loc/aw contiguous, checked."""
    b, q, m, d = value.shape[0], loc.shape[1], value.shape[2], value.shape[3]
    out = torch.empty(b, q, m * d, dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(_K1, "msda_fwd", 4).msda_fwd(
            value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
            *_shape_args(value, loc, spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 ms_deform_attn_fwd launch failed: CUDA error {err}")
    ms_deform_attn.launches += 1
    return out


def _ms_deform_attn_bwd_cuda(value, spatial_shapes, loc, aw, grad_out):
    """K1-bwd: d_value (each element summed in a fixed-point pass, the same
    in every run), d_loc, d_aw."""
    out = backward_launch(_K1_BWD, "msda_bwd", "K1-bwd", value, spatial_shapes, loc, aw,
                          grad_out)
    ms_deform_attn_backward.launches += 1
    return out


@torch.library.custom_op("richsem_tpu_torch::msda_out", mutates_args=())
def msda_out(value: torch.Tensor, loc: torch.Tensor, aw: torch.Tensor,
             shapes: List[int]) -> torch.Tensor:
    """The sampler as one dispatcher op, which a selective checkpoint sees and
    can keep (``shapes``: the pyramid's ``[h0, w0, h1, w1, ...]``): K1 on CUDA
    tensors, saving only ``(value, loc, aw)`` for K1-bwd; the plain version on
    CPU ones."""
    spatial_shapes = tuple(zip(shapes[::2], shapes[1::2]))
    if value.is_cuda:
        return _ms_deform_attn_cuda(value, spatial_shapes, loc, aw)
    return ms_deform_attn_plain(value, spatial_shapes, loc, aw)


def _msda_out_setup(ctx, inputs, output):
    value, loc, aw, shapes = inputs
    ctx.shapes = tuple(zip(shapes[::2], shapes[1::2]))
    ctx.save_for_backward(value, loc, aw)


def _msda_out_backward(ctx, grad_out):
    """K1-bwd on CUDA tensors; on CPU ones autograd's gradient of the plain
    version, computed again from the saved inputs."""
    value, loc, aw = ctx.saved_tensors
    if value.is_cuda:
        return (*_ms_deform_attn_bwd_cuda(value, ctx.shapes, loc, aw, grad_out), None)
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (value, loc, aw)]
        out = ms_deform_attn_plain(inputs[0], ctx.shapes, inputs[1], inputs[2])
        return (*torch.autograd.grad(out, inputs, grad_out), None)


msda_out.register_autograd(_msda_out_backward, setup_context=_msda_out_setup)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Deformable attention core, through the op :func:`msda_out`: K1 (and
    K1-bwd) on CUDA tensors, the plain version on CPU ones."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"ms_deform_attn: no kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    if value.is_cuda:
        _check_cuda(value, sampling_locations, attention_weights)
        _check_head_dim(value)
    return msda_out(value.contiguous(), sampling_locations.contiguous(),
                    attention_weights.contiguous(), [v for hw in spatial_shapes for v in hw])


def ms_deform_attn_backward(value, spatial_shapes, sampling_locations,
                            attention_weights, grad_out):
    """K1-bwd called directly: -> (d_value, d_loc, d_aw). CUDA tensors only."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type != "cuda":
        raise RuntimeError(f"ms_deform_attn_backward: no kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    _check_cuda(value, sampling_locations, attention_weights)
    _check_head_dim(value)
    return _ms_deform_attn_bwd_cuda(
        value.contiguous(), spatial_shapes, sampling_locations.contiguous(),
        attention_weights.contiguous(), grad_out,
    )


ms_deform_attn.launches = 0  # K1 launches; chip_smoke.py reads and resets it
ms_deform_attn_backward.launches = 0  # K1-bwd launches, whichever way it is reached
