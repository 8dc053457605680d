"""RoIAlign of the CLIP teacher's distillation targets (counterpart of
``richsem_tpu/ops/roi_align.py``, its ``method="matmul"`` path).

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
takes them) uses the same matrix with ``nmax = n``. ``method="auto"`` is the
matmul path on a map of at most ``MATMUL_MAX_GRID`` cells, as in JAX; the
``gather`` method is not ported (ROADMAP.md queue 1, item 11).
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
    if method == "auto" and h * w <= MATMUL_MAX_GRID:
        method = "matmul"
    if method != "matmul":
        raise NotImplementedError(
            f"roi_align(method={method!r}) on a {h}x{w} map is not ported to "
            "richsem_tpu_torch yet (ROADMAP.md queue 1, item 11); the port has the "
            "matmul path")
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
