"""The per-cell cost of the windowed deformable-attention design (counterpart of
``tools/bench_cell.py``).

    python3 -m richsem_tpu_torch.tools.bench_cell [--device cuda]

One cell of the windowed design, at level-0 shapes (tile 16, margin 6): for
each of 4 levels, the hats ``hy [MK, P, wy]`` and ``hx [MK, P, wx]`` from the
relative coordinates, the bf16 basis ``sum_p hy (x) hx`` and its contraction
with the level's bf16 window into [M, K, D] f32, repeated ``reps`` times
(:func:`run_cell`, kernel ``csrc/probe_cell.cu:cell_kernel``: a warp per 16
rows of K and pass range, the passes split across blocks as :func:`cell_grid`
says, the partials summed in a fixed order). The JAX probe's
two modes, ``2d`` and ``flat``, are two Mosaic layouts of that one function;
here one kernel serves both and ``mode`` only names the line.
:func:`check_repeat_semantics` prints what ``pltpu.repeat`` does to a row: it
tiles (``csrc/probe_cell.cu:tile_kernel``).
"""

from __future__ import annotations

import argparse
import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from richsem_tpu_torch.tools._probe import (I32, PTR, aligned16, device_name, launch, on_card,
                                            timeit)

M, K, P, D = 8, 352, 4, 32
MK = M * K
# margin-6 windows, tile (16, 16)
WINDOWS = ((28, 28), (20, 20), (16, 16), (14, 14))
_SRC = "probe_cell"


def _hats(yr, xr, aw, v: int, wy: int, wx: int, it: float):
    sl = slice(v * P, (v + 1) * P)
    gy = torch.arange(wy, dtype=torch.float32, device=yr.device)
    gx = torch.arange(wx, dtype=torch.float32, device=yr.device)
    yv = yr[:, sl, None] + it
    av = aw[:, sl, None]
    hy = torch.clamp_min(av - av * (yv - gy).abs(), 0)      # [MK, P, wy]
    hx = torch.clamp_min(1 - (xr[:, sl, None] - gx).abs(), 0)  # [MK, P, wx]
    return hy, hx


def cell_plain(yr, xr, aw, wins: Sequence[torch.Tensor], reps: int) -> torch.Tensor:
    m, d = wins[0].shape[:2]
    k = yr.shape[0] // m
    carry = torch.zeros(m, k, d, dtype=torch.float32, device=yr.device)
    for rep in range(reps):
        acc = torch.zeros_like(carry)
        for v, w in enumerate(wins):
            wy, wx = w.shape[2:]
            hy, hx = _hats(yr, xr, aw, v, wy, wx, float(rep))
            prod = hy[..., None] * hx[..., None, :]            # [MK, P, wy, wx]
            basis = prod[:, 0]
            for p in range(1, prod.shape[1]):  # the points summed in order
                basis = basis + prod[:, p]
            basis = basis.to(torch.bfloat16).float().reshape(m, k, wy * wx)
            acc = acc + torch.bmm(basis, w.float().reshape(m, d, wy * wx).transpose(1, 2))
        carry = carry + acc
    return carry


CELL_TILE, CELL_MAX_WARPS = 16, 12  # rows of K a warp (one m16 product tile); warps a block


def cell_check(coords: Sequence[int], windows: Sequence[Sequence[int]]) -> None:
    """Raise unless cell_kernel takes coordinates [M*K, 4 L] and L <= 4 windows
    [M, 32, wy, wx] with M, K >= 1 and sides 1 .. 32."""
    mk, lp = coords
    m = windows[0][0] if windows else 0
    if not (1 <= len(windows) <= 4 and m >= 1 and mk >= m and mk % m == 0
            and lp == P * len(windows)
            and all(len(w) == 4 and tuple(w[:2]) == (m, D) and 1 <= w[2] <= 32
                    and 1 <= w[3] <= 32 for w in windows)):
        raise ValueError(f"cell: needs coordinates [M*K, {P}*L] and 1-4 windows [M, {D}, wy, wx] "
                         f"with sides 1-32; got coordinates {tuple(coords)}, windows "
                         f"{[tuple(w) for w in windows]}")


def cell_grid(m: int, k: int, reps: int, n_sm: int) -> Tuple[int, int, int]:
    """-> (warps a block, blocks along K, R pass ranges) of cell_kernel: as few
    blocks along K as hold its 16-row tiles at <= 12 warps each, the tiles
    spread evenly over them; R as many as fill ``n_sm`` SMs with one block
    each (M x blocks along K x R)."""
    tiles = -(-k // CELL_TILE)
    groups = -(-tiles // CELL_MAX_WARPS)
    return -(-tiles // groups), groups, max(1, min(reps, n_sm // (m * groups)))


def cell_pass_range(j: int, ranges: int, reps: int) -> Tuple[int, int]:
    """The passes [i0, i1) of pass range j of ``ranges``."""
    return reps * j // ranges, reps * (j + 1) // ranges


def cell(yr, xr, aw, wins: Sequence[torch.Tensor], reps: int) -> torch.Tensor:
    """yr/xr/aw [M*K, L*P] f32, wins L x [M, D, wy, wx] bf16 -> [M, K, D] f32."""
    if not on_card("cell", yr, xr, aw, *wins):
        return cell_plain(yr, xr, aw, wins, reps)
    cell_check(tuple(yr.shape), [tuple(w.shape) for w in wins])
    if any(t.dtype != torch.float32 or t.shape != yr.shape for t in (xr, aw)) or any(
            w.dtype != torch.bfloat16 for w in wins):
        raise ValueError("cell: f32 coordinates of one shape and bf16 windows")
    yr, xr, aw = aligned16(yr, xr, aw)  # the kernel loads them as float4
    wins = [w.contiguous() for w in wins]
    m, d = wins[0].shape[:2]
    k = yr.shape[0] // m
    n_sm = torch.cuda.get_device_properties(yr.device).multi_processor_count
    warps, groups, splits = cell_grid(m, k, reps, n_sm)
    part = torch.empty(splits, m, k, d, dtype=torch.float32, device=yr.device)
    out = torch.empty(m, k, d, dtype=torch.float32, device=yr.device)
    n = len(wins)
    ptrs = (ctypes.c_void_p * n)(*[w.data_ptr() for w in wins])
    wy = (ctypes.c_int * n)(*[w.shape[2] for w in wins])
    wx = (ctypes.c_int * n)(*[w.shape[3] for w in wins])
    launch(_SRC, "probe_cell",
           [PTR, PTR, PTR, PTR, PTR, PTR, I32, PTR, PTR, I32, I32, I32, I32, I32, I32],
           yr.device, yr.data_ptr(), xr.data_ptr(), aw.data_ptr(), ptrs, wy, wx, n,
           part.data_ptr(), out.data_ptr(), m, k, reps, warps, groups, splits)
    cell.launches += 1  # one call: cell_kernel and the fixed-order sum of its partials
    return out


def tile_plain(x: torch.Tensor, times: int) -> torch.Tensor:
    return x.repeat(1, times)


def tile(x: torch.Tensor, times: int) -> torch.Tensor:
    """x [rows, w] f32 -> [rows, w * times], out[r, c] = x[r, c % w]."""
    if not on_card("tile", x):
        return tile_plain(x, times)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"tile: needs f32 [rows, w], got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    rows, w = x.shape
    out = torch.empty(rows, w * times, dtype=x.dtype, device=x.device)
    launch(_SRC, "probe_tile", [PTR, PTR, I32, I32, I32], x.device, x.data_ptr(),
           out.data_ptr(), rows, w, times)
    tile.launches += 1
    return out


cell.launches = 0  # kernel launches; chip_smoke.py reads and resets them
tile.launches = 0


def cell_inputs(device="cuda"):
    """The JAX probe's inputs, drawn from the same numpy generator."""
    rng = np.random.default_rng(0)
    yr = rng.uniform(2, 20, (MK, 4 * P)).astype(np.float32)
    xr = rng.uniform(2, 20, (MK, 4 * P)).astype(np.float32)
    aw = rng.uniform(0, 1, (MK, 4 * P)).astype(np.float32)
    wins = [torch.from_numpy(rng.normal(size=(M, D, wy, wx))).to(torch.bfloat16)
            for wy, wx in WINDOWS]
    return ([torch.from_numpy(a).to(device) for a in (yr, xr, aw)],
            [w.to(device) for w in wins])


def run_cell(mode: str, reps: int = 64, device="cuda"):
    if mode not in ("2d", "flat"):
        raise ValueError(f"mode must be '2d' or 'flat', got {mode!r}")
    (yr, xr, aw), wins = cell_inputs(device)
    out, dt = timeit(lambda: cell(yr, xr, aw, wins, reps), device, n=10)
    per_cell = dt / reps
    print(f"cell fwd ({mode}): {per_cell*1e6:8.2f} us/cell -> "
          f"{per_cell*154*1e3:6.2f} ms/layer-fwd (154 cells)")
    return out, dt


def check_repeat_semantics(device="cuda"):
    x = torch.arange(8, dtype=torch.float32, device=device)[None].repeat(8, 1)  # [8, 8]
    out = tile(x, 2)
    print("repeat row:", out[0].long().tolist())
    return out


def main(device="cuda"):
    print(device_name(device))
    return [check_repeat_semantics(device), run_cell("2d", device=device),
            run_cell("flat", device=device)]


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(p.parse_args().device)
