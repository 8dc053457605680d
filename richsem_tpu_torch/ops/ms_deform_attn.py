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
    """K1-bwd: d_value (f32 scratch, cast to the value's dtype), d_loc, d_aw."""
    grad_out = grad_out.to(value.dtype).contiguous()
    d_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    d_loc = torch.empty_like(loc)
    d_aw = torch.empty_like(aw)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(_K1_BWD, "msda_bwd", 7).msda_bwd(
            value.data_ptr(), loc.data_ptr(), aw.data_ptr(), grad_out.data_ptr(),
            d_value.data_ptr(), d_loc.data_ptr(), d_aw.data_ptr(),
            *_shape_args(value, loc, spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(f"K1-bwd ms_deform_attn_bwd launch failed: CUDA error {err}")
    ms_deform_attn_backward.launches += 1
    return d_value.to(value.dtype), d_loc, d_aw


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
