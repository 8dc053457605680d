"""RoIAlign of the CLIP teacher's distillation targets and visual queries
(counterpart of ``richsem_tpu/ops/roi_align.py``).

detectron2's ``ROIAlign(output_size, spatial_scale, sampling_ratio=0,
aligned=True)``, as the reference crops the CLIP spatial map: box corners
scaled by ``spatial_scale`` and shifted by -0.5, each of the ``o x o`` bins the
mean of an adaptive ``ceil(extent / o)`` grid of bilinear samples per axis,
out-of-bounds taps zero, and a box of zero or negative extent exactly zero.

Bilinear sampling factorizes per axis, so the crop is one interpolation
matrix ``W [R*o*o, H*W]`` (rows summing the samples of a bin, folded with its
average) times the flattened map. The adaptive grid count is per box, but the
matrix's shape is not: samples sit on a static ``nmax = ceil(map_extent / o)``
lattice with those past ``ceil(extent / o)`` at weight 0
(``roi_align.py:106-184``). ``W`` is cast to the map's dtype as JAX casts it;
the product runs in float32 with TF32 off, as JAX runs it at
``Precision.HIGHEST``. ``torch.bmm`` is the product: a plain matrix product
outside any kernel.

A static ``sampling_ratio`` (``n`` samples a bin and axis, every one at
weight ``1 / n``, as the visual-query crop of ``use_clip_visual_query``
takes them) uses the same matrix with ``nmax = n``.

``method="gather"`` samples the map directly (``_bilinear_grid_sample``, JAX's
``roi_align.py:187-219``): the ``n x n`` sample lattice of every bin, each
sample the sum of its four taps (zero outside the map) in float32, averaged
over the bin; linear in the map's cells, for maps where ``W`` would not fit.
Its sample count is a shape, so ``sampling_ratio=0`` raises there, as in JAX.
``method="auto"`` is the matmul path on a map of at most ``MATMUL_MAX_GRID``
cells and the gather path past it, as JAX's ``roi_align.py:71-72`` chooses:
the visual queries on a 1344 x 2048 canvas crop a 42 x 64 map (2,688 cells).
Both paths are plain PyTorch: JAX's are XLA programs, not Pallas kernels.
"""

from __future__ import annotations

import math

import torch

MATMUL_MAX_GRID = 2048  # JAX's _MATMUL_MAX_GRID: "auto" takes the matmul path up to here


def _axis_weights(start, bin_sz, extent, size: int, nmax: int, o: int,
                  adaptive: bool = True) -> torch.Tensor:
    """-> [B, R, o, size]: the interpolation weights of one axis, each bin's
    samples folded with their average (``adaptive``: ``ceil(extent / o)``
    samples, else ``nmax``)."""
    dev = start.device
    if adaptive:
        ng = torch.clamp(torch.ceil(extent / o), 1.0, float(nmax))  # [B, R]
    else:
        ng = torch.full_like(extent, float(nmax))
    j = torch.arange(nmax, dtype=torch.float32, device=dev)
    active = j < ng[..., None]  # [B, R, nmax]
    frac = (j + 0.5) / ng[..., None]
    bins = torch.arange(o, dtype=torch.float32, device=dev)
    coord = start[..., None, None] + bin_sz[..., None, None] * (
        bins[:, None] + frac[..., None, :])  # [B, R, o, nmax]
    samp_w = torch.where(active, 1.0 / ng[..., None], 0.0)
    if adaptive:  # an extent <= 0 runs no sample in detectron2: 0 / max(count, 1)
        samp_w = samp_w * (extent > 0.0)[..., None]
    c0 = torch.floor(coord)
    d = coord - c0
    c0i = c0.long()
    w0 = torch.where((c0i >= 0) & (c0i < size), 1.0 - d, 0.0)
    w1 = torch.where((c0i + 1 >= 0) & (c0i + 1 < size), d, 0.0)
    pos = torch.arange(size, device=dev)
    m = ((pos == c0i[..., None]) * w0[..., None]
         + (pos == c0i[..., None] + 1) * w1[..., None])  # [B, R, o, nmax, size]
    return (m * samp_w[:, :, None, :, None]).sum(3)


def roi_align(
    features: torch.Tensor,  # [B, H, W, C] channel-last
    boxes: torch.Tensor,  # [B, R, 4] xyxy in input-image coordinates
    output_size: int = 7,
    spatial_scale: float = 1.0,
    sampling_ratio: int = 0,
    method: str = "matmul",
) -> torch.Tensor:
    """Crop-and-resize ``boxes`` from ``features`` -> ``[B, R, o, o, C]`` in the
    features' dtype."""
    b, h, w, c = features.shape
    if method == "auto":
        method = "matmul" if h * w <= MATMUL_MAX_GRID else "gather"
    if method == "gather":
        return _roi_align_gather(features, boxes, output_size, spatial_scale, sampling_ratio)
    if method != "matmul":
        raise ValueError(f"unknown roi_align method {method!r}: 'auto', 'matmul' or 'gather'")
    r = boxes.shape[1]
    o = output_size
    bx = boxes.float() * spatial_scale
    ext_w = bx[..., 2] - bx[..., 0]
    ext_h = bx[..., 3] - bx[..., 1]
    # a box never exceeds the map, so ceil(map / o) bounds the adaptive count
    ada = sampling_ratio == 0
    ny = max(1, math.ceil(h / o)) if ada else sampling_ratio
    nx = max(1, math.ceil(w / o)) if ada else sampling_ratio
    ay = _axis_weights(bx[..., 1] - 0.5, ext_h / o, ext_h, h, ny, o, ada)
    ax = _axis_weights(bx[..., 0] - 0.5, ext_w / o, ext_w, w, nx, o, ada)
    wmat = torch.einsum("briy,brjx->brijyx", ay, ax).reshape(b, r * o * o, h * w)
    wmat = wmat.to(features.dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        crops = torch.bmm(wmat.float(), features.reshape(b, h * w, c).float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return crops.reshape(b, r, o, o, c).to(features.dtype)


def _roi_align_gather(features, boxes, output_size: int, spatial_scale: float,
                      sampling_ratio: int) -> torch.Tensor:
    """The gather path: every bin's ``n x n`` bilinear samples from the map,
    averaged (``roi_align.py:76-104``)."""
    if sampling_ratio == 0:
        raise NotImplementedError(
            "adaptive sampling_ratio=0 is implemented on the matmul path "
            "only (the gather path's sample count is a shape); use "
            "method='matmul' or a static sampling_ratio")
    b, h, w, c = features.shape
    r, n, o = boxes.shape[1], sampling_ratio, output_size
    bx = boxes.float() * spatial_scale
    start_x, start_y = bx[..., 0] - 0.5, bx[..., 1] - 0.5  # [B, R]
    bin_w = (bx[..., 2] - bx[..., 0]) / o
    bin_h = (bx[..., 3] - bx[..., 1]) / o
    dev = features.device
    frac = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
    bins = torch.arange(o, dtype=torch.float32, device=dev)
    grid = (bins[:, None] + frac[None, :]).reshape(o * n)
    sx = start_x[..., None] + bin_w[..., None] * grid  # [B, R, o*n]
    sy = start_y[..., None] + bin_h[..., None] * grid
    out = _bilinear_grid_sample(features, sy, sx)  # [B, R, o*n, o*n, C]
    out = out.reshape(b, r, o, n, o, n, c).mean(dim=(3, 5))
    return out.to(features.dtype)


def _bilinear_grid_sample(features: torch.Tensor, y: torch.Tensor, x: torch.Tensor
                          ) -> torch.Tensor:
    """``features [B, H, W, C]`` sampled at the outer grid of ``y [B, R, Gy]`` x
    ``x [B, R, Gx]`` pixel coordinates -> ``[B, R, Gy, Gx, C]`` float32: four
    taps a sample, each zero outside the map."""
    b, h, w, c = features.shape
    gy, gx = y.shape[-1], x.shape[-1]
    yy = y[..., :, None].expand(*y.shape, gx)
    xx = x[..., None, :].expand(*x.shape[:-1], gy, gx)
    feats = features.float().reshape(b, h * w, c)
    y0, x0 = torch.floor(yy), torch.floor(xx)
    dy, dx = yy - y0, xx - x0
    y0i, x0i = y0.long(), x0.long()
    acc = feats.new_zeros(*yy.shape, c)
    for cy, wy in ((y0i, 1 - dy), (y0i + 1, dy)):
        for cx, wx in ((x0i, 1 - dx), (x0i + 1, dx)):
            valid = (cy >= 0) & (cy < h) & (cx >= 0) & (cx < w)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).reshape(b, -1)
            tap = torch.gather(feats, 1, idx[:, :, None].expand(-1, -1, c))
            wgt = torch.where(valid, wy * wx, 0.0)
            acc = acc + tap.reshape(*yy.shape, c) * wgt[..., None]
    return acc
