"""Calibrate the card's primitives (counterpart of ``tools/bench_pallas_cal.py``).

    python3 -m richsem_tpu_torch.tools.bench_cal [--device cuda]

Each probe keeps the JAX function's name and computes what its Pallas kernel
computes, with a hand-written CUDA kernel (``csrc/probe_cal.cu``) on CUDA
tensors and the plain PyTorch version beside it on CPU tensors:

1. :func:`run_vpu` -- the CUDA-core rate: ``acc += max(0, 1 - |x - (y + i)|) * y``
   over ``reps`` passes of a [768, 1664] array, f32 and bf16 (acc in the input
   dtype), counted as 6 operations an element a pass;
2. :func:`run_mxu` -- ``acc_f32 += bf16(a + i) @ b`` over ``reps`` passes at
   the windowed contraction's narrow shapes, on the tensor cores: the passes
   are split across blocks (``wgmma`` with ``a + i`` formed in registers, the
   partials summed in a fixed order), so the TF/s it prints is the rate the
   tensor cores reach at these shapes;
3. :func:`run_grid_overhead` -- ``2 x`` with one block per [8, 128] cell; the
   time over the cell count is the memory time of an 8 KB block, not the
   cost of scheduling one;
4. :func:`run_repeat` -- ``acc += tile(x + i, 52, axis=1)``, [768, 32] ->
   [768, 1664], 256 passes.

Each prints the rate in the JAX probe's units and returns (output, seconds a
call); times are CUDA events on the card (the host clock on the CPU).
"""

from __future__ import annotations

import argparse
from typing import Tuple

import torch

from richsem_tpu_torch.tools._probe import (I32, I64, PTR, aligned16, device_name, launch, on_card,
                                            timeit)

ROWS, S = 768, 1664  # ~ (M*K, sum of windows) at tile (8, 8): 8*96 = 768, 1589 -> 1664
_SRC = "probe_cal"


def _bf16_flag(t: torch.Tensor) -> int:
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"probe kernels take float32 or bfloat16, got {t.dtype}")
    return int(t.dtype == torch.bfloat16)


def _step(i: int, like: torch.Tensor) -> torch.Tensor:
    """The pass index in the input dtype (bf16 rounds integers above 256), as
    JAX's ``i.astype(x.dtype)``."""
    return torch.tensor(i, dtype=like.dtype, device=like.device)


def vpu_plain(x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for i in range(reps):
        d = x - (y + _step(i, x))
        acc = acc + torch.clamp_min(1 - d.abs(), 0) * y
    return acc


def vpu(x: torch.Tensor, y: torch.Tensor, reps: int) -> torch.Tensor:
    """The VPU probe's function: the kernel on CUDA tensors, plain on CPU ones."""
    if not on_card("vpu", x, y):
        return vpu_plain(x, y, reps)
    if x.shape != y.shape or x.dtype != y.dtype:
        raise ValueError("vpu: x and y must share shape and dtype")
    x, y = aligned16(x, y)  # the bf16 kernel loads 16 bytes at a time
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    launch(_SRC, "probe_vpu", [PTR, PTR, PTR, I64, I32, I32], x.device,
           x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), reps, _bf16_flag(x))
    vpu.launches += 1
    return out


def mxu_plain(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32, device=a.device)
    for i in range(reps):
        acc = acc + (a + _step(i, a)).float() @ b.float()
    return acc


MXU_ROWS = 64  # rows of a mxu_kernel block's tile: one m64 wgmma product


def mxu_check(k: int, s: int, d: int) -> None:
    """Raise unless mxu_kernel takes a [k, s] @ [s, d]: k >= 1, s a positive
    multiple of 16 (the k-step), d a positive multiple of 32 (its column
    tiles are 128 or 32 wide)."""
    if k < 1 or s < 16 or s % 16 or d < 32 or d % 32:
        raise ValueError(f"mxu: needs k >= 1, s a positive multiple of 16 and d a positive "
                         f"multiple of 32, got {k}, {s}, {d}")


def mxu_tile_n(d: int) -> int:
    """mxu_kernel's column tile: 128 where it divides d, else 32."""
    return 128 if d % 128 == 0 else 32


def mxu_splits(k: int, d: int, reps: int, n_sm: int) -> int:
    """R, the blocks along the reps: as many as fill ``n_sm`` SMs with one
    block each beside the (row tile, column tile) pairs. Each block's two
    warpgroups take two of the 2 R rep ranges."""
    tiles = -(-k // MXU_ROWS) * (d // mxu_tile_n(d))
    return max(1, min(-(-reps // 2), n_sm // tiles))


def mxu_rep_range(j: int, ranges: int, reps: int) -> Tuple[int, int]:
    """The reps [i0, i1) of rep range j of ``ranges`` (2 R): warpgroup g of
    block z takes range 2 z + g."""
    return reps * j // ranges, reps * (j + 1) // ranges


def mxu(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """The MXU probe's function: a [k, s], b [s, d] bf16 -> f32 [k, d]."""
    if not on_card("mxu", a, b):
        return mxu_plain(a, b, reps)
    (k, s), d = a.shape, b.shape[1]
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or b.shape[0] != s:
        raise ValueError(f"mxu: needs bf16 a [k, s] and b [s, d], got {a.shape} {b.shape}")
    mxu_check(k, s, d)
    a, b = a.contiguous(), b.contiguous()
    n_sm = torch.cuda.get_device_properties(a.device).multi_processor_count
    splits = mxu_splits(k, d, reps, n_sm)
    part = torch.empty(2 * splits, k, d, dtype=torch.float32, device=a.device)
    out = torch.empty(k, d, dtype=torch.float32, device=a.device)
    launch(_SRC, "probe_mxu", [PTR, PTR, PTR, PTR, I32, I32, I32, I32, I32], a.device,
           a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), k, s, d, reps, splits)
    mxu.launches += 1  # one call: mxu_kernel and the fixed-order sum of its partials
    return out


def grid_overhead_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def grid_overhead(x: torch.Tensor) -> torch.Tensor:
    """``2 x`` over [n_cells, 8, 128] f32, one block a cell."""
    if not on_card("grid_overhead", x):
        return grid_overhead_plain(x)
    if x.dtype != torch.float32 or x.shape[1:] != (8, 128):
        raise ValueError(f"grid_overhead: needs f32 [n, 8, 128], got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    launch(_SRC, "probe_grid", [PTR, PTR, I32], x.device, x.data_ptr(), out.data_ptr(),
           x.shape[0])
    grid_overhead.launches += 1
    return out


def repeat_plain(x: torch.Tensor, wx: int, reps: int) -> torch.Tensor:
    acc = torch.zeros(x.shape[0], x.shape[1] * wx, dtype=x.dtype, device=x.device)
    for i in range(reps):
        acc = acc + (x + _step(i, x)).repeat(1, wx)
    return acc


REPEAT_VEC = {torch.float32: 4, torch.bfloat16: 8}  # outputs a thread of the repeat kernel
REPEAT_THREADS = 512  # most threads a block


def repeat_block(wy: int, wx: int, dtype: torch.dtype) -> Tuple[int, int, int]:
    """The repeat kernel's block (wy / V, by, bz): x the V-wide vector in the
    source group, y the copy, z the row; as many copies and rows as fill
    ``REPEAT_THREADS``. The grid is (ceil(rows / bz), ceil(wx / by))."""
    bx = wy // REPEAT_VEC[dtype]
    by = min(wx, max(1, REPEAT_THREADS // bx))
    return bx, by, max(1, REPEAT_THREADS // (bx * by))


def repeat_check(wy: int, dtype: torch.dtype) -> None:
    """Raise unless the repeat kernel takes a source group of ``wy``: a
    positive multiple of its vector width, at most a block wide."""
    v = REPEAT_VEC[dtype]
    if wy < v or wy % v or wy // v > REPEAT_THREADS:
        raise ValueError(f"repeat: {dtype} needs wy a positive multiple of {v} up to "
                         f"{v * REPEAT_THREADS}, got {wy}")


def repeat(x: torch.Tensor, wx: int, reps: int) -> torch.Tensor:
    """``acc += tile(x + i, wx, axis=1)`` over ``reps`` passes; x [rows, wy]."""
    if not on_card("repeat", x):
        return repeat_plain(x, wx, reps)
    is_bf16 = _bf16_flag(x)
    if x.dim() != 2 or wx < 1:
        raise ValueError(f"repeat: needs x [rows, wy] and wx >= 1, got {tuple(x.shape)}, {wx}")
    rows, wy = x.shape
    repeat_check(wy, x.dtype)
    (x,) = aligned16(x)  # the kernel loads V elements, 16 bytes, at a time
    out = x.new_empty((rows, wy * wx))
    if out.numel() == 0:
        return out
    _, by, bz = repeat_block(wy, wx, x.dtype)
    launch(_SRC, "probe_repeat", [PTR, PTR, I32, I32, I32, I32, I32, I32, I32], x.device,
           x.data_ptr(), out.data_ptr(), rows, wy, wx, reps, is_bf16, by, bz)
    repeat.launches += 1
    return out


for _fn in (vpu, mxu, grid_overhead, repeat):
    _fn.launches = 0  # kernel launches; chip_smoke.py reads and resets them


def _name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def run_vpu(dtype: torch.dtype, reps: int = 512, device="cuda"):
    x = torch.ones(ROWS, S, dtype=dtype, device=device)
    y = torch.full((ROWS, S), 0.5, dtype=dtype, device=device)
    out, dt = timeit(lambda: vpu(x, y, reps), device)
    ops = ROWS * S * reps * 6
    print(f"VPU {_name(dtype):9s}: {dt*1e6:8.1f} us  -> {ops/dt/1e12:6.2f} Tops/s")
    return out, dt


def run_mxu(k_rows: int, s_: int, d_: int, dtype: torch.dtype, reps: int = 512, device="cuda"):
    a = torch.ones(k_rows, s_, dtype=dtype, device=device)
    b = torch.ones(s_, d_, dtype=dtype, device=device)
    out, dt = timeit(lambda: mxu(a, b, reps), device)
    fl = 2 * k_rows * s_ * d_ * reps
    print(f"MXU [{k_rows}x{s_}]x[{s_}x{d_}] {_name(dtype):9s}: {dt*1e6:8.1f} us -> "
          f"{fl/dt/1e12:6.2f} TF/s")
    return out, dt


def run_grid_overhead(n_cells: int, device="cuda"):
    x = torch.ones(n_cells, 8, 128, dtype=torch.float32, device=device)
    out, dt = timeit(lambda: grid_overhead(x), device)
    print(f"grid overhead {n_cells} cells: {dt*1e6:8.1f} us -> {dt/n_cells*1e9:7.1f} ns/cell")
    return out, dt


def run_repeat(dtype: torch.dtype, device="cuda"):
    wy, wx = 32, 52  # [ROWS, 32] -> [ROWS, 32 * 52]
    x = torch.ones(ROWS, wy, dtype=dtype, device=device)
    out, dt = timeit(lambda: repeat(x, wx, 256), device)
    print(f"repeat {_name(dtype)}: {dt/256*1e6:8.2f} us/rep for {ROWS}x{wy}->{ROWS}x{wy*wx}")
    return out, dt


# the calls of main(), in order, as (function, arguments)
CALLS = (
    (run_vpu, (torch.float32,)), (run_vpu, (torch.bfloat16,)),
    (run_mxu, (768, 1664, 128, torch.bfloat16)), (run_mxu, (768, 1664, 32, torch.bfloat16)),
    (run_mxu, (96, 1664, 32, torch.bfloat16)), (run_mxu, (96, 1664, 128, torch.bfloat16)),
    (run_grid_overhead, (4096,)), (run_grid_overhead, (16384,)),
    (run_repeat, (torch.float32,)), (run_repeat, (torch.bfloat16,)),
)


def main(device="cuda"):
    print(device_name(device))
    return [fn(*args, device=device) for fn, args in CALLS]


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
