"""Separable deformable attention of the decoder (counterpart of
``richsem_tpu/ops/ms_deform_attn_sep_pallas.py``, the ``dec_msda_impl="sep_pallas"``
sampler).

The function is the exact zero-padded bilinear sampler written as two hat
bases per level, ``out[q] = sum_{l,p} aw * hy^T V_l hx``, with the rounding
of the TPU kernel (``_fwd_kernel`` :77-106, ``_fwd_impl`` :233-234). Per row
(b, m, q, p) and level, with ``x = loc_x*W - 0.5``, ``y = loc_y*H - 0.5``,
``hat(c, i) = max(0, 1 - |c - i|)`` and ``cdt`` the value's dtype (bf16) or
float32:

    hxw[x']   = cdt(hat(x, x') * aw)                    (:92)
    r[y', d]  = sum_x' hxw[x'] * V_l[y', x', d]          f32 (:94-98)
    rh[y', d] = cdt(r[y', d] * hat(y, y'))               (:100)
    out[b, q, m, d] = cdt(sum_p f32(sum_l sum_y' rh))    (:101-105, :233-234)

and the backward of ``_bwd_kernel`` (:109-170), with ``g`` first rounded to
``cdt`` (:122) and ``dhat(c, i) = -sign(c - i)`` for ``|c - i| < 1``, else 0
(:72-74; so 0 at ``|c - i| = 0`` and at ``|c - i| = 1``):

    d_loc_y = H * sum_{y',d} g * r * dhat(y, y')
    d_r     = cdt(g * hat(y, y'))
    d_hxw   = sum_{y',d} d_r * V_l                      f32
    d_aw    = sum_x' d_hxw * hat(x, x')
    d_loc_x = W * aw * sum_x' d_hxw * dhat(x, x')
    d_V_l   = sum_rows hxw * d_r                        f32, cast once to the value's dtype

* :func:`ms_deform_attn_sep` -- the public op. On a CUDA tensor it is a
  ``torch.autograd.Function`` around the hand-written kernels K3
  (``csrc/ms_deform_attn_sep_fwd.cu``) and K3-bwd
  (``csrc/ms_deform_attn_sep_bwd.cu``), saving only ``(value, loc, aw)``; they
  take a head dim of 32 only, as K1 and K1-bwd do. On a CPU tensor it runs
  :func:`ms_deform_attn_sep_plain`, at any head dim. Nothing else: a CUDA
  call that cannot launch raises.
* :func:`ms_deform_attn_sep_dvalue_plain` -- K3-bwd's d_value as its
  deterministic pass computes it (``csrc/msda_dvalue.cuh``), bit for bit, in
  plain PyTorch (``ms_deform_attn.fixed_point_dvalue``); the tests and
  ``chip_smoke.py`` hold the kernel to it, no path runs it.
* :func:`ms_deform_attn_sep_plain` -- the plain PyTorch version: the dense
  separable products above, chunked over rows as the TPU grid chunks them
  (``_num_chunks``), with the explicit backward
  (:func:`ms_deform_attn_sep_backward_plain`) as its gradient. Autograd of
  ``max``/``abs`` would split a tie 1/2-1/2 and give +-1/2 at ``|c - i| = 1``,
  where the TPU kernel gives 0.

Shapes as :mod:`richsem_tpu_torch.ops.ms_deform_attn`: value ``[B,S,M,D]``
(bf16 or f32), sampling_locations ``[B,Q,M,L,P,2]`` f32, attention_weights
``[B,Q,M,L,P]`` f32 -> ``[B,Q,M*D]`` in the value's dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from richsem_tpu_torch.ops.ms_deform_attn import (_abs_bits_max, _check, _check_cuda,
                                                  _check_head_dim, _lib, _shape_args,
                                                  backward_launch, fixed_point_dvalue)

_CK_TARGET = 512  # rows per chunk of the dense plain version, as the TPU grid


def _num_chunks(qp: int) -> int:
    nch = max(1, -(-qp // _CK_TARGET))
    while qp % nch:
        nch += 1
    return nch


def _cdt(value: torch.Tensor) -> torch.dtype:
    return torch.bfloat16 if value.dtype == torch.bfloat16 else torch.float32


def _hat(c: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """c [..., 1] f32, grid [n] f32 -> max(0, 1 - |c - grid|) [..., n]."""
    return torch.clamp(1.0 - (c - grid).abs(), min=0.0)


def _dhat(c: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    diff = c - grid
    return torch.where(diff.abs() < 1.0, -torch.sign(diff), diff.new_zeros(()))


def _rows(value, spatial_shapes, loc, aw):
    """-> per level (img [BM, W, H*D] in cdt, y, x, a [BM, Q*P, 1] f32)."""
    b, _, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    cdt = _cdt(value)
    out = []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        img = value[:, start:start + h * w].reshape(b, h, w, m, d)
        img = img.permute(0, 3, 2, 1, 4).reshape(b * m, w, h * d).to(cdt)
        ll = loc[:, :, :, lvl].float()  # [B, Q, M, P, 2]
        x = (ll[..., 0] * w - 0.5).permute(0, 2, 1, 3).reshape(b * m, q * p, 1)
        y = (ll[..., 1] * h - 0.5).permute(0, 2, 1, 3).reshape(b * m, q * p, 1)
        a = aw[:, :, :, lvl].float().permute(0, 2, 1, 3).reshape(b * m, q * p, 1)
        out.append((img, y, x, a))
        start += h * w
    return out


def _sep_fwd_plain(value, spatial_shapes, loc, aw):
    b, _, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    cdt = _cdt(value)
    qp = q * p
    ck = qp // _num_chunks(qp)
    dev = value.device
    acc = torch.zeros(b * m, qp, d, dtype=torch.float32, device=dev)
    for (h, w), (img, y, x, a) in zip(spatial_shapes, _rows(value, spatial_shapes, loc, aw)):
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        imgf = img.float()
        for s in range(0, qp, ck):
            rows = slice(s, s + ck)
            hxw = (_hat(x[:, rows], gx) * a[:, rows]).to(cdt).float()  # [BM, ck, W]
            r = torch.bmm(hxw, imgf).reshape(b * m, -1, h, d)  # f32
            rh = (r * _hat(y[:, rows], gy)[..., None]).to(cdt).float()
            acc[:, rows] += rh.sum(dim=2)
    out = acc.reshape(b, m, q, p, d).sum(3).permute(0, 2, 1, 3)
    return out.reshape(b, q, m * d).to(value.dtype)


def ms_deform_attn_sep_backward_plain(value, spatial_shapes, sampling_locations,
                                      attention_weights, grad_out):
    """The explicit backward of the plain version -> (d_value, d_loc, d_aw)."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    loc, aw = sampling_locations, attention_weights
    b, _, m, d = value.shape
    q, p = loc.shape[1], loc.shape[4]
    n_lvl = len(spatial_shapes)
    cdt = _cdt(value)
    qp = q * p
    ck = qp // _num_chunks(qp)
    dev = value.device
    g = grad_out.to(cdt).float().reshape(b, q, m, 1, d).permute(0, 2, 1, 3, 4)
    g = g.expand(b, m, q, p, d).reshape(b * m, qp, d)
    d_imgs: List[torch.Tensor] = []
    d_y, d_x, d_a = [], [], []
    for (h, w), (img, y, x, a) in zip(spatial_shapes, _rows(value, spatial_shapes, loc, aw)):
        gx = torch.arange(w, dtype=torch.float32, device=dev)
        gy = torch.arange(h, dtype=torch.float32, device=dev)
        imgf = img.float()
        d_img = torch.zeros(b * m, w, h * d, dtype=torch.float32, device=dev)
        dy_l, dx_l, da_l = [], [], []
        for s in range(0, qp, ck):
            rows = slice(s, s + ck)
            xs, ys, a_s = x[:, rows], y[:, rows], a[:, rows]
            g_s = g[:, rows][:, :, None, :]  # [BM, ck, 1, D]
            hx = _hat(xs, gx)  # [BM, ck, W]
            hxw = (hx * a_s).to(cdt).float()
            r = torch.bmm(hxw, imgf).reshape(b * m, -1, h, d)
            dy_l.append((g_s * r * _dhat(ys, gy)[..., None]).sum(dim=(2, 3)) * float(h))
            d_r = (g_s * _hat(ys, gy)[..., None]).to(cdt).float().reshape(b * m, -1, h * d)
            d_hxw = torch.bmm(d_r, imgf.transpose(1, 2))  # [BM, ck, W]
            da_l.append((d_hxw * hx).sum(dim=2))
            dx_l.append((d_hxw * _dhat(xs, gx)).sum(dim=2) * a_s[..., 0] * float(w))
            d_img += torch.bmm(hxw.transpose(1, 2), d_r)
        d_imgs.append(d_img.reshape(b, m, w, h, d).permute(0, 3, 2, 1, 4).reshape(b, h * w, m, d))
        d_y.append(torch.cat(dy_l, 1))
        d_x.append(torch.cat(dx_l, 1))
        d_a.append(torch.cat(da_l, 1))

    def unpack(rows):  # L x [BM, QP] -> [B, Q, M, L, P]
        t = torch.stack(rows, -1).reshape(b, m, q, p, n_lvl)
        return t.permute(0, 2, 1, 4, 3)

    d_value = torch.cat(d_imgs, 1).to(value.dtype)
    d_loc = torch.stack([unpack(d_x), unpack(d_y)], -1).to(loc.dtype)
    return d_value, d_loc, unpack(d_a).to(aw.dtype)


def ms_deform_attn_sep_dvalue_plain(value, spatial_shapes, sampling_locations,
                                    attention_weights, grad_out):
    """K3-bwd's d_value, bit for bit (``csrc/ms_deform_attn_sep_bwd.cu``), in plain
    PyTorch: a tap whose corners touch its level gives each in-range corner
    (i, j) the terms ``hxw_i * cdt(g * hy_j)``, with ``hxw_i = cdt(hat(x, x0 + i)
    * aw)`` and ``hy_j = hat(y, y0 + j)`` (``msda_common.cuh:sep_tap``: 0 out of
    range); the factor bound is max_i |hxw_i| * max_j |hy_j| over those taps,
    max|g| over every row; summed by ``fixed_point_dvalue``. Any device."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    b, s, m, d = value.shape
    loc, aw = sampling_locations.float(), attention_weights.float()
    q = loc.shape[1]
    cdt = _cdt(value)
    g = grad_out.to(value.dtype).float().reshape(b * q * m, d)
    f_bits = torch.zeros((), dtype=torch.int32, device=value.device)
    rows, chunks = [], []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5  # [B, Q, M, P]
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0, y0 = torch.floor(x), torch.floor(y)
        a = aw[:, :, :, lvl]
        xin, yin = (x0 >= 0, x0 + 1 < w), (y0 >= 0, y0 + 1 < h)
        zero = x.new_zeros(())
        hxw = [torch.where(xin[i], (_hat(x, x0 + i) * a).to(cdt).float(), zero) for i in (0, 1)]
        hy = [torch.where(yin[j], _hat(y, y0 + j), zero) for j in (0, 1)]
        bound = torch.fmax(hxw[0].abs(), hxw[1].abs()) * torch.fmax(hy[0].abs(), hy[1].abs())
        f_bits = torch.maximum(f_bits, _abs_bits_max(bound[inside]))
        for e in range(4):
            i, j = e & 1, e >> 1
            bi, qi, mi, pi = torch.nonzero(inside & xin[i] & yin[j], as_tuple=True)
            cx, cy = x0[bi, qi, mi, pi].long() + i, y0[bi, qi, mi, pi].long() + j
            rows.append((bi * s + start + cy * w + cx) * m + mi)
            chunks.append(((bi * q + qi) * m + mi, hxw[i][bi, qi, mi, pi], hy[j][bi, qi, mi, pi]))
        start += h * w

    def terms_of(i):
        gi, wx, hyv = chunks[i]
        return wx[:, None] * (g[gi] * hyv[:, None]).to(cdt).float()

    return fixed_point_dvalue(value, rows, terms_of, _abs_bits_max(g), f_bits)


class _SepPlainFn(torch.autograd.Function):
    """The plain forward with the explicit plain backward."""

    @staticmethod
    def forward(ctx, value, loc, aw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        return _sep_fwd_plain(value, spatial_shapes, loc, aw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        return (*ms_deform_attn_sep_backward_plain(value, ctx.spatial_shapes, loc, aw,
                                                   grad_out), None)


def ms_deform_attn_sep_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """The dense separable products in plain PyTorch, with the explicit backward."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    return _SepPlainFn.apply(value, sampling_locations, attention_weights, spatial_shapes)


_K3 = "ms_deform_attn_sep_fwd"
_K3_BWD = "ms_deform_attn_sep_bwd"


def _sep_cuda(value, spatial_shapes, loc, aw):
    """K3: the forward. value/loc/aw contiguous, checked."""
    b, q, m, d = value.shape[0], loc.shape[1], value.shape[2], value.shape[3]
    out = torch.empty(b, q, m * d, dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib(_K3, "msda_sep_fwd", 4).msda_sep_fwd(
            value.data_ptr(), loc.data_ptr(), aw.data_ptr(), out.data_ptr(),
            *_shape_args(value, loc, spatial_shapes), stream,
        )
    if err != 0:
        raise RuntimeError(f"K3 ms_deform_attn_sep_fwd launch failed: CUDA error {err}")
    ms_deform_attn_sep.launches += 1
    return out


def _sep_bwd_cuda(value, spatial_shapes, loc, aw, grad_out):
    """K3-bwd: d_value (each element summed in a fixed-point pass, the same
    in every run, rounded once to the value's dtype), d_loc, d_aw."""
    out = backward_launch(_K3_BWD, "msda_sep_bwd", "K3-bwd", value, spatial_shapes, loc, aw,
                          grad_out)
    ms_deform_attn_sep_backward.launches += 1
    return out


class _SepFn(torch.autograd.Function):
    """K3 forward, K3-bwd backward; saves only (value, loc, aw)."""

    @staticmethod
    def forward(ctx, value, loc, aw, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, loc, aw)
        return _sep_cuda(value, spatial_shapes, loc, aw)

    @staticmethod
    def backward(ctx, grad_out):
        value, loc, aw = ctx.saved_tensors
        return (*_sep_bwd_cuda(value, ctx.spatial_shapes, loc, aw, grad_out), None)


def ms_deform_attn_sep(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Separable deformable attention: K3 (and K3-bwd) on CUDA tensors, the
    plain version on CPU ones."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type == "cpu":
        return ms_deform_attn_sep_plain(
            value, spatial_shapes, sampling_locations, attention_weights)
    if value.device.type != "cuda":
        raise RuntimeError(f"ms_deform_attn_sep: no kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    _check_cuda(value, sampling_locations, attention_weights, "K3")
    _check_head_dim(value, "K3 and K3-bwd")
    return _SepFn.apply(
        value.contiguous(), sampling_locations.contiguous(),
        attention_weights.contiguous(), spatial_shapes,
    )


def ms_deform_attn_sep_backward(value, spatial_shapes, sampling_locations,
                                attention_weights, grad_out):
    """K3-bwd called directly: -> (d_value, d_loc, d_aw). CUDA tensors only."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    if value.device.type != "cuda":
        raise RuntimeError(f"ms_deform_attn_sep_backward: no kernel for device {value.device}")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    _check_cuda(value, sampling_locations, attention_weights, "K3")
    _check_head_dim(value, "K3 and K3-bwd")
    return _sep_bwd_cuda(
        value.contiguous(), spatial_shapes, sampling_locations.contiguous(),
        attention_weights.contiguous(), grad_out,
    )


ms_deform_attn_sep.launches = 0  # K3 launches; chip_smoke.py reads and resets it
ms_deform_attn_sep_backward.launches = 0  # K3-bwd launches, whichever way it is reached
