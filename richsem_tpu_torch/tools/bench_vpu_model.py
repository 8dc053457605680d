"""The elementwise cost of basis-build-sized f32 passes (counterpart of
``tools/bench_vpu_model.py``).

    python3 -m richsem_tpu_torch.tools.bench_vpu_model [--device cuda]

Over [T=154, M=8, 28, 32, 384] f32 (424M elements, 1.70 GB an array), as the
JAX probe runs them over its grid of T cells (kernels in
``csrc/probe_vpu_model.cu``):

* ``chain-N`` (:func:`chain`): ``acc = x``, then N times ``acc = acc + x``;
* ``fma-P`` (:func:`fma`): ``sum_p hy[..., y, pK + k] * hx[..., x, pK + k]``
  for P points, one accumulator or, with ``two_acc``, the even and the odd
  points in two;
* ``fma-4-chunk`` (:func:`fma_chunk`): fma-4 taken in 128-lane chunks of K,
  the same function.

Each timed call is the kernel and then ``.sum()`` of its output, as
:func:`run` builds it; the sum is outside the kernel, as in JAX.
"""

from __future__ import annotations

import argparse
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from richsem_tpu_torch.tools._probe import I32, I64, PTR, device_name, launch, on_card, timeit

# level-0 basis-build shape at tile 16 margin 6: [M, wy, wxp, K]
M, WY, WXP, K = 8, 28, 32, 384
T = 154  # grid cells per layer (B=2)
_SRC = "probe_vpu_model"


def chain_plain(x: torch.Tensor, n_ops: int) -> torch.Tensor:
    acc = x
    for _ in range(n_ops):
        acc = acc + x
    return acc


def chain(x: torch.Tensor, n_ops: int) -> torch.Tensor:
    """``acc = x; n_ops times acc = acc + x`` over an f32 array."""
    if not on_card("chain", x):
        return chain_plain(x, n_ops)
    if x.dtype != torch.float32:
        raise ValueError(f"chain: needs f32, got {x.dtype}")
    x = x.contiguous()
    out = torch.empty_like(x)
    launch(_SRC, "probe_chain", [PTR, PTR, I64, I32], x.device, x.data_ptr(), out.data_ptr(),
           x.numel(), n_ops)
    chain.launches += 1
    return out


def _point(h: torch.Tensor, p: int, k: int) -> torch.Tensor:
    return h[..., p * k:(p + 1) * k]


def fma_plain(hy: torch.Tensor, hx: torch.Tensor, p_pts: int, two_acc: bool) -> torch.Tensor:
    k = hy.shape[-1] // 4
    acc0 = acc1 = None
    for p in range(p_pts):
        a = _point(hy, p, k)[:, :, :, None, :] * _point(hx, p, k)[:, :, None, :, :]
        if two_acc and p % 2:
            acc1 = a if acc1 is None else acc1 + a
        else:
            acc0 = a if acc0 is None else acc0 + a
    return acc0 if acc1 is None else acc0 + acc1


def fma_chunk_plain(hy: torch.Tensor, hx: torch.Tensor, p_pts: int) -> torch.Tensor:
    t, m, wy, k4 = hy.shape
    k = k4 // 4
    out = hy.new_empty(t, m, wy, hx.shape[2], k)
    for kc in range(k // 128):
        sl = slice(kc * 128, (kc + 1) * 128)
        acc = None
        for p in range(p_pts):
            a = _point(hy, p, k)[..., sl][:, :, :, None, :] * _point(hx, p, k)[..., sl][:, :, None]
            acc = a if acc is None else acc + a
        out[..., sl] = acc
    return out


def fma_check(hy_shape, hx_shape, p_pts: int) -> None:
    """Raise unless fma_kernel takes hy [T, M, WY, 4K] and hx [T, M, WXP, 4K]:
    T·M, WY, WXP >= 1, K a positive multiple of 4 (16-byte rows), 1 <= P <= 4."""
    ok = (len(hy_shape) == 4 and len(hx_shape) == 4 and tuple(hx_shape[:2]) == tuple(hy_shape[:2])
          and hx_shape[3] == hy_shape[3] and hy_shape[3] % 16 == 0 and hy_shape[3] > 0
          and hy_shape[0] * hy_shape[1] >= 1 and hy_shape[2] >= 1 and hx_shape[2] >= 1
          and 1 <= p_pts <= 4)
    if not ok:
        raise ValueError(f"fma: needs hy [T, M, WY, 4K] and hx [T, M, WXP, 4K] with T·M, WY, "
                         f"WXP >= 1, K a positive multiple of 4 and 1 <= P <= 4; got "
                         f"{tuple(hy_shape)}, {tuple(hx_shape)}, P={p_pts}")


def _fma_cuda(hy, hx, p_pts, two_acc, name):
    if hy.dtype != torch.float32 or hx.dtype != torch.float32:
        raise ValueError(f"{name}: needs f32 hy and hx, got {hy.dtype}, {hx.dtype}")
    fma_check(hy.shape, hx.shape, p_pts)
    t, m, wy, k4 = hy.shape
    wxp, k = hx.shape[2], k4 // 4
    hy, hx = hy.contiguous(), hx.contiguous()
    out = hy.new_empty(t, m, wy, wxp, k)
    launch(_SRC, "probe_fma", [PTR, PTR, PTR, I32, I32, I32, I32, I32, I32], hy.device,
           hy.data_ptr(), hx.data_ptr(), out.data_ptr(), t * m, wy, wxp, k, p_pts, int(two_acc))
    return out


def fma(hy: torch.Tensor, hx: torch.Tensor, p_pts: int, two_acc: bool = False) -> torch.Tensor:
    """hy [T, M, WY, 4K], hx [T, M, WXP, 4K] f32 -> [T, M, WY, WXP, K]."""
    if not on_card("fma", hy, hx):
        return fma_plain(hy, hx, p_pts, two_acc)
    out = _fma_cuda(hy, hx, p_pts, two_acc, "fma")
    fma.launches += 1
    return out


def fma_chunk(hy: torch.Tensor, hx: torch.Tensor, p_pts: int) -> torch.Tensor:
    """:func:`fma` with one accumulator, as the JAX probe's 128-lane chunks of K."""
    if not on_card("fma_chunk", hy, hx):
        return fma_chunk_plain(hy, hx, p_pts)
    out = _fma_cuda(hy, hx, p_pts, False, "fma_chunk")
    fma_chunk.launches += 1
    return out


for _fn in (chain, fma, fma_chunk):
    _fn.launches = 0  # kernel launches; chip_smoke.py reads and resets them


def draw(in_shapes: Sequence[Tuple[int, ...]], device="cuda"):
    """The inputs drawn in f32 from ``default_rng(0).normal`` in order, as the
    JAX probe draws them."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(device)
            for s in in_shapes]


def run(kern: Callable, in_shapes: Sequence[Tuple[int, ...]], extra=(), device="cuda"):
    """-> (f, args): ``f(*args)`` is ``kern(*args, *extra).sum()``."""
    return (lambda *a: kern(*a, *extra).sum()), draw(in_shapes, device)


def main(device="cuda"):
    """The JAX probe's runs. Each set of inputs is drawn once, since every
    draw of :func:`run` gives the same arrays."""
    print(device_name(device))
    elems = T * M * WY * WXP * K
    print(f"array: {elems/1e6:.1f}M elems, {elems*4/1e6:.0f} MB total")
    big = (T, M, WY, WXP, K)
    results = {}
    x = draw([big], device)
    for n_ops in (1, 2, 4, 8):
        out, dt = timeit(lambda: chain(*x, n_ops).sum(), device, n=30, warmup=1)
        print(f"chain-{n_ops}:   {dt*1e3:7.2f} ms  "
              f"{n_ops*elems/dt/1e12:6.2f} Tops/s  "
              f"{(2+n_ops)*elems*4/dt/1e12:5.2f} TB/s-if-materialized")
        results[f"chain-{n_ops}"] = (out, dt)
    del x
    hats = draw([(T, M, WY, 4 * K), (T, M, WXP, 4 * K)], device)
    for p in (1, 2, 4):
        out, dt = timeit(lambda: fma(*hats, p, False).sum(), device, n=30, warmup=1)
        ops = (2 * p - 1) * elems
        print(f"fma-{p}:     {dt*1e3:7.2f} ms  {ops/dt/1e12:6.2f} Tops/s")
        results[f"fma-{p}"] = (out, dt)
    out, dt = timeit(lambda: fma(*hats, 4, True).sum(), device, n=30, warmup=1)
    print(f"fma-4-2acc: {dt*1e3:7.2f} ms")
    results["fma-4-2acc"] = (out, dt)
    out, dt = timeit(lambda: fma_chunk(*hats, 4).sum(), device, n=30, warmup=1)
    print(f"fma-4-chunk:{dt*1e3:7.2f} ms")
    results["fma-4-chunk"] = (out, dt)
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
