"""How ``cell_kernel`` (``csrc/probe_cell.cu``) and ``vpu_bf16_kernel``
(``csrc/probe_cal.cu``) split their work, emulated in plain torch on the CPU
and held against the Pallas probes of ``tools/`` in interpret mode (as
``tests/test_torch_probes.py`` runs them) and against the port's plain
versions.

The emulations follow the kernels:

* cell: a grid of (blocks along K) x M x R pass ranges (``bench_cell.cell_grid``:
  R as many as fill the SMs with one block each), warp w of block x taking the
  16 rows 16 (x warps + w) of its channel row m over the passes of its range.
  For each level the block stages the window in the column order of
  ``tap_col`` (a 32-bit word a (channel, gy pair, gx), zeros past wy and wx);
  a lane (g, t) holds hx at its x taps gx = 4 c + t and forms, for each
  16-column chunk (y-group, x-group), the basis at rows g and g + 8 and
  gy = 4 ig + e, which the m16n8k16 A fragment places at columns 2t + e % 2
  + 8 (e // 2) (PTX ISA, "Matrix Fragments for mma.m16n8k16"); every level
  and pass goes into one f32 accumulator, written as the range's partial, and
  the partials are summed in order. The basis is each lane's f32 arithmetic,
  bit for bit; only the contraction's f32 order is another.
* vpu bf16: a thread per 16 elements (8 packed pairs; the last thread of a
  ragged n pads with zeros), each pass bf16(i) from the f32 pass index, then
  the packed operations, each rounded once: y + i, x - that, the sign bits
  cleared, relu(|d| * -1 + 1), the product with y, the sum into acc.

Tolerances: cell 4e-3 of the largest magnitude (``chip_smoke.py`` phase 12's:
one bf16 rounding step of a basis entry whose f32 sums differ, against the
Pallas kernel; against the plain version only the contraction's f32 order
differs); vpu bf16 exact.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.bench_cell as jax_cell
import tools.bench_pallas_cal as jax_cal
from richsem_tpu_torch.tools import bench_cal, bench_cell

torch.set_num_threads(2)

N_SM = 132  # the H100's SMs, as the wrapper reads them from the card
TILE = 16   # csrc/probe_cell.cu kTile: rows of K a warp


@pytest.fixture
def interpret(monkeypatch):
    """pl.pallas_call in interpret mode; -> the list of callables it built."""
    real = pl.pallas_call
    built = []

    def call(*args, **kw):
        kw.pop("compiler_params", None)
        fn = real(*args, interpret=True, **kw)
        built.append(fn)
        return fn

    monkeypatch.setattr(pl, "pallas_call", call)
    return built


# ---- cell_kernel ---------------------------------------------------------


def tap_col(gy, gx, c_groups):
    """csrc/probe_cell.cu:tap_col, the staged column of window tap (gy, gx)."""
    return 16 * (c_groups * (gy // 4) + gx // 4) + 2 * (gx % 4) + gy % 2 + 8 * ((gy // 2) % 2)


def stage_window(win_m):
    """stage_window: win_m [D, wy, wx] bf16 -> (staged [D, 16 nG C] bf16, how
    often each column was written)."""
    d, wy, wx = win_m.shape
    c_groups, n_g = -(-wx // 4), -(-wy // 4)
    staged = torch.full((d, 16 * n_g * c_groups), float("nan")).to(torch.bfloat16)
    count = torch.zeros(staged.shape[1], dtype=torch.int32)
    zero = torch.zeros(d, dtype=torch.bfloat16)
    for gy in range(0, 4 * n_g, 2):    # the warp's (channel, gy pair) rows
        for gx in range(4 * c_groups):  # the live lanes
            col = tap_col(gy, gx, c_groups)
            staged[:, col] = win_m[:, gy, gx] if gy < wy and gx < wx else zero
            staged[:, col + 1] = win_m[:, gy + 1, gx] if gy + 1 < wy and gx < wx else zero
            count[col:col + 2] += 1
    return staged, count


# the m16n8k16 A fragment (PTX ISA): register j of lane (g, t) holds rows
# g + 8 (j % 2) and columns 2t + 8 (j // 2) + {0, 1}; the kernel packs into
# register j the basis of row g + 8 (j % 2) at gy % 4 = 2 (j // 2) + {0, 1}
A_REGS = [(j % 2, 2 * (j // 2)) for j in range(4)]  # (row half, first e)


@functools.lru_cache(maxsize=None)
def a_sources(n_g, c_groups):
    """The basis element (flat gy * 4C + gx) that each A column of a level
    holds, from the fragment layout and each lane's registers."""
    src = torch.full((16 * n_g * c_groups,), -1, dtype=torch.long)
    for ig in range(n_g):
        for c in range(c_groups):
            base = 16 * (ig * c_groups + c)
            for t in range(4):  # a lane's x tap: gx = 4 c + t, in every register
                for _, e0 in A_REGS:
                    for half in (0, 1):
                        col = base + 2 * t + 8 * (e0 // 2) + half
                        gy, gx = 4 * ig + e0 + half, 4 * c + t
                        assert src[col] in (-1, gy * 4 * c_groups + gx)
                        src[col] = gy * 4 * c_groups + gx
    assert bool((src >= 0).all())
    return src


def _rows(t, row0, rows):
    """Rows row0 .. row0 + 15 of t, zeros past ``rows`` (the kernel loads none)."""
    idx = (row0 + torch.arange(TILE)).clamp(max=t.shape[0] - 1)
    return torch.where((torch.arange(TILE) < rows)[:, None], t[idx], torch.zeros(()))


def warp_level(yr, xr, aw, row0, rows, v, staged, wy, wx, passes):
    """One warp's level over its passes: -> its f32 accumulation [16, D]."""
    c_groups, n_g = -(-wx // 4), -(-wy // 4)
    sl = slice(v * 4, v * 4 + 4)
    x, y, a = (_rows(t, row0, rows)[:, sl] for t in (xr, yr, aw))
    gx = torch.arange(4 * c_groups, dtype=torch.float32)
    gy = torch.arange(4 * n_g, dtype=torch.float32)
    hx = torch.where(gx[None, :, None] < wx,
                     torch.clamp_min(1 - (x[:, None, :] - gx[None, :, None]).abs(), 0),
                     torch.zeros(()))                                 # [16, 4C, P]
    src = a_sources(n_g, c_groups)
    acc = torch.zeros(TILE, staged.shape[0])
    for i in passes:
        yi = y + float(i)
        hy = torch.where(gy[None, :, None] < wy,
                         torch.clamp_min(a[:, None] - a[:, None] * (yi[:, None] - gy[None, :, None]).abs(), 0),
                         torch.zeros(()))                             # [16, 4nG, P]
        basis = hy[:, :, None, 0] * hx[:, None, :, 0]
        for p in range(1, 4):  # the points in order, each operation rounded
            basis = basis + hy[:, :, None, p] * hx[:, None, :, p]
        a_tile = basis.reshape(TILE, -1)[:, src].to(torch.bfloat16)
        acc = acc + a_tile.float() @ staged.float().T
    return acc


def cell_emulate(yr, xr, aw, wins, reps, n_sm=N_SM, block_order=None):
    """cell_kernel and cell_reduce_kernel on the CPU; -> (out, R, how often
    each (row, level, pass) was contracted). ``block_order`` permutes the
    order in which the blocks run."""
    m, d = wins[0].shape[:2]
    k = yr.shape[0] // m
    warps, groups, splits = bench_cell.cell_grid(m, k, reps, n_sm)
    part = torch.full((splits, m * k, d), float("nan"))
    covered = torch.zeros(m * k, len(wins), reps, dtype=torch.int32)
    blocks = [(x, mm, z) for z in range(splits) for mm in range(m) for x in range(groups)]
    for x, mm, z in (block_order(blocks) if block_order else blocks):
        i0, i1 = bench_cell.cell_pass_range(z, splits, reps)
        accs = {}
        for v, win in enumerate(wins):
            staged, count = stage_window(win[mm])
            assert bool((count == 1).all())
            wy, wx = win.shape[2:]
            for w in range(warps):
                k0 = (x * warps + w) * TILE
                rows = min(TILE, k - k0)
                if rows <= 0:
                    continue
                row0 = mm * k + k0
                acc = warp_level(yr, xr, aw, row0, rows, v, staged, wy, wx, range(i0, i1))
                accs[w] = accs.get(w, 0) + acc
                covered[row0:row0 + rows, v, i0:i1] += 1
        for w, acc in accs.items():
            k0 = (x * warps + w) * TILE
            rows = min(TILE, k - k0)
            part[z, mm * k + k0:mm * k + k0 + rows] = acc[:rows]
    out = part[0]
    for z in range(1, splits):  # cell_reduce_kernel: the ranges in order
        out = out + part[z]
    return out.reshape(m, k, d), splits, covered


def _small_cell(monkeypatch, m, k):
    for mod in (jax_cell, bench_cell):
        monkeypatch.setattr(mod, "M", m)
        monkeypatch.setattr(mod, "K", k)
        monkeypatch.setattr(mod, "MK", m * k)


def _within(out, ref, rel=4e-3):
    return float((out - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("m,k,reps,n_sm,want", [
    (2, 20, 5, 6, (2, 1, 3)),    # K past a tile (rows 16-19); 5 passes over R = 3
    (1, 200, 2, 1, (7, 2, 1)),   # two blocks along K, the second's last warp idle
    (1, 40, 3, 2, (3, 1, 2)),    # 3 passes over R = 2
], ids=["ragged-K", "two-blocks", "uneven-ranges"])
def test_cell_split_against_jax_and_plain(monkeypatch, interpret, m, k, reps, n_sm, want):
    _small_cell(monkeypatch, m, k)
    outs = []
    monkeypatch.setattr(jax_cell, "timeit",
                        lambda fn, *a, **kw: outs.append(np.array(fn(*a))) or 1.0)
    jax_cell.run_cell("flat", reps=reps)
    (yr, xr, aw), wins = bench_cell.cell_inputs("cpu")
    out, splits, covered = cell_emulate(yr, xr, aw, wins, reps, n_sm)
    assert bench_cell.cell_grid(m, k, reps, n_sm) == want and splits == want[2]
    assert bool((covered == 1).all())  # every row, level and pass contracted once
    plain = bench_cell.cell_plain(yr, xr, aw, wins, reps)
    assert _within(out, plain, 1e-5)  # the same basis; the f32 order differs
    assert _within(out, torch.from_numpy(outs[0]))


def test_cell_split_odd_windows():
    """Sides that are not multiples of 4 (padded y- and x-groups) and a
    32 x 32 window (8 x-groups), against the plain version."""
    rng = np.random.default_rng(5)
    m, k, reps = 1, 24, 3
    shapes = ((13, 7), (32, 32), (5, 30), (1, 1))
    coords = [torch.from_numpy(rng.uniform(lo, hi, (m * k, 16)).astype(np.float32))
              for lo, hi in ((0, 30), (0, 30), (0, 1))]
    wins = [torch.from_numpy(rng.normal(size=(m, 32, wy, wx))).to(torch.bfloat16)
            for wy, wx in shapes]
    out, _, covered = cell_emulate(*coords, wins, reps, n_sm=3)
    assert bool((covered == 1).all())
    assert _within(out, bench_cell.cell_plain(*coords, wins, reps), 1e-5)


@pytest.mark.parametrize("wy,wx", list(jax_cell.WINDOWS) + [(13, 7), (32, 32), (1, 1), (5, 30)])
def test_cell_staging_writes_every_column_once(wy, wx):
    """Every staged column of the level written once; the A fragment's
    columns hold each (gy, gx) of the padded level once, at the column where
    the staging put that tap."""
    win = torch.arange(32 * wy * wx, dtype=torch.float32).reshape(32, wy, wx).to(torch.bfloat16)
    staged, count = stage_window(win)
    assert bool((count == 1).all())
    c_groups, n_g = -(-wx // 4), -(-wy // 4)
    src = a_sources(n_g, c_groups)
    assert sorted(src.tolist()) == list(range(16 * n_g * c_groups))
    for col, s in enumerate(src.tolist()):
        gy, gx = divmod(s, 4 * c_groups)
        want = win[:, gy, gx] if gy < wy and gx < wx else torch.zeros(32, dtype=torch.bfloat16)
        assert torch.equal(staged[:, col], want)


@pytest.mark.parametrize("m,k,reps,n_sm", [(8, 352, 64, 132), (8, 352, 64, 114), (8, 352, 7, 132),
                                           (3, 37, 5, 132), (1, 1, 1, 132), (1, 400, 0, 132),
                                           (16, 352, 64, 132)])
def test_cell_grid_covers_every_row_and_pass_once(m, k, reps, n_sm):
    warps, groups, splits = bench_cell.cell_grid(m, k, reps, n_sm)
    assert 1 <= warps <= 12 and 1 <= splits
    assert m * groups * splits <= max(n_sm, m * groups)  # one wave where the card holds it
    tiles = -(-k // TILE)
    assert (groups - 1) * warps < tiles <= groups * warps  # no block without a live warp
    rows = torch.zeros(k, dtype=torch.int32)
    for x in range(groups):
        for w in range(warps):
            k0 = (x * warps + w) * TILE
            rows[k0:k0 + TILE] += 1
    assert bool((rows == 1).all())
    ranges = [bench_cell.cell_pass_range(z, splits, reps) for z in range(splits)]
    assert [i for i0, i1 in ranges for i in range(i0, i1)] == list(range(reps))
    sizes = [i1 - i0 for i0, i1 in ranges]
    assert max(sizes) - min(sizes) <= 1


def test_cell_production_grid():
    """The JAX defaults on 132 SMs: 11 warps a block, two blocks along K, 8
    pass ranges of 8 passes: 128 blocks, one wave."""
    assert bench_cell.cell_grid(bench_cell.M, bench_cell.K, 64, N_SM) == (11, 2, 8)


def test_cell_fixed_order_sum_is_reproducible(monkeypatch):
    """The partials are written by range and summed in order, so the order in
    which the blocks run does not change a bit."""
    _small_cell(monkeypatch, 2, 20)
    (yr, xr, aw), wins = bench_cell.cell_inputs("cpu")
    out, splits, _ = cell_emulate(yr, xr, aw, wins, 5, n_sm=8)
    again, _, _ = cell_emulate(yr, xr, aw, wins, 5, n_sm=8, block_order=lambda b: b[::-1])
    assert splits == 4 and torch.equal(out, again)


@pytest.mark.parametrize("coords,windows", [
    ((2816, 16), [(8, 32, 28, 28), (8, 32, 20, 20), (8, 32, 16, 16), (8, 32, 14, 14)]),
    ((352, 4), [(1, 32, 32, 32)]),
    ((3, 8), [(3, 32, 1, 1), (3, 32, 13, 7)]),
])
def test_cell_check_accepts(coords, windows):
    bench_cell.cell_check(coords, windows)


@pytest.mark.parametrize("coords,windows", [
    ((2816, 16), [(8, 16, 28, 28)] * 4),          # D 16
    ((2816, 4), [(8, 32, 33, 28)]),               # a side past 32
    ((2816, 4), [(8, 32, 0, 28)]),                # an empty side
    ((2816, 20), [(8, 32, 14, 14)] * 5),          # five levels
    ((2816, 12), [(8, 32, 14, 14)] * 4),          # coordinates for three levels
    ((2817, 4), [(8, 32, 14, 14)]),               # M * K not a multiple of M
    ((2816, 8), [(8, 32, 14, 14), (4, 32, 14, 14)]),  # another M
    ((2816, 0), []),
])
def test_cell_check_refuses(coords, windows):
    with pytest.raises(ValueError, match="cell: needs"):
        bench_cell.cell_check(coords, windows)


# ---- vpu_bf16_kernel ------------------------------------------------------


def vpu_bf16_emulate(x, y, reps):
    """vpu_bf16_kernel's threads on the CPU, packed pairs as bf16 tensors."""
    n, per = x.numel(), 16
    pad = -(-n // per) * per - n
    xv, yv = (torch.cat([t.reshape(-1), torch.zeros(pad, dtype=torch.bfloat16)]).view(-1, per // 2, 2)
              for t in (x, y))
    acc = torch.zeros_like(xv)
    for i in range(reps):
        ii = torch.tensor(float(i)).to(torch.bfloat16)  # one packed convert of the f32 index
        d = xv - (yv + ii)
        ad = (d.view(torch.int16) & 0x7FFF).view(torch.bfloat16)   # the sign bits cleared
        h = (1 - ad.float()).to(torch.bfloat16)  # |d| * -1 + 1, the product exact: one rounding
        h = torch.where(h < 0, torch.zeros_like(h), h)  # relu
        acc = acc + h * yv
    return acc.reshape(-1)[:n].view(x.shape)


def _vpu_inputs(shape, reps, seed):
    """x around the pass index; a third of the elements with x = y + i +- 1 at
    some pass i, so 1 - |d| is exactly zero there (and h * y a signed zero
    where y < 0)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(-8, 9, shape) / 4
    x = rng.uniform(0, reps, shape)
    tie = rng.random(shape) < 1 / 3
    x = np.where(tie, y + rng.integers(0, reps, shape) + rng.choice([-1.0, 1.0], shape), x)
    return (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(y.astype(np.float32)).to(torch.bfloat16))


@pytest.mark.parametrize("shape,reps", [((3, 37), 300), ((1, 1), 5), ((8, 128), 270)],
                         ids=["odd-n", "one", "whole-threads"])
def test_vpu_bf16_packed_against_jax(interpret, shape, reps):
    x, y = _vpu_inputs(shape, reps, seed=sum(shape) + reps)
    ref = pl.pallas_call(functools.partial(jax_cal.vpu_kernel, reps),
                         out_shape=jax_cal.jax.ShapeDtypeStruct(shape, jnp.bfloat16))(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(y.float().numpy(), jnp.bfloat16))
    out = vpu_bf16_emulate(x, y, reps)
    ref = torch.from_numpy(np.asarray(ref).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))  # bit for bit, zeros' signs too
    assert torch.equal(out.view(torch.int16), bench_cal.vpu_plain(x, y, reps).view(torch.int16))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 33, 767])
def test_vpu_bf16_packed_ragged_n(n):
    """A ragged last thread: its missing elements padded with zeros, not
    written; bit for bit against the plain version past 256 passes."""
    x, y = _vpu_inputs((n,), 260, seed=n)
    out = vpu_bf16_emulate(x, y, 260)
    assert out.shape == (n,)
    assert torch.equal(out.view(torch.int16), bench_cal.vpu_plain(x, y, 260).view(torch.int16))


def test_vpu_bf16_hat_zero_and_signed_zeros():
    """1 - |d| exactly zero gives +0 (relu keeps it), and +0 * y < 0 = -0 adds
    to acc = +0 as +0: the sign of every zero as the plain version's."""
    y = torch.tensor([-0.5, 0.5, -2.0, 3.0], dtype=torch.bfloat16)
    x = y + torch.tensor([1.0, -1.0, 1.0, 2.0], dtype=torch.bfloat16)  # pass 0: |d| = 1, 1, 1, 2
    out = vpu_bf16_emulate(x, y, 1)
    ref = bench_cal.vpu_plain(x, y, 1)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert out.view(torch.int16).tolist() == [0, 0, 0, 0]


def test_wrappers_check_before_launch():
    """A CUDA tensor the kernels do not take is refused before any launch; the
    checks reached through meta tensors that report a CUDA device."""
    from unittest import mock

    yr = torch.zeros(2816, 16, device="meta")
    bad = [torch.zeros(8, 16, 28, 28, dtype=torch.bfloat16, device="meta")] * 4
    with mock.patch.object(bench_cell, "on_card", return_value=True), \
            pytest.raises(ValueError, match="cell: needs"):
        bench_cell.cell(yr, yr, yr, bad, 64)
    wins = [torch.zeros(8, 32, 28, 28, dtype=torch.bfloat16, device="meta")] * 4
    with mock.patch.object(bench_cell, "on_card", return_value=True), \
            pytest.raises(ValueError, match="cell: f32 coordinates"):
        bench_cell.cell(yr, yr, yr.to(torch.bfloat16), wins, 64)
    x = torch.zeros(768, 1664, dtype=torch.bfloat16, device="meta")
    with mock.patch.object(bench_cal, "on_card", return_value=True), \
            pytest.raises(ValueError, match="vpu: x and y must share"):
        bench_cal.vpu(x, x[:, :1663], 512)
    with mock.patch.object(bench_cal, "on_card", return_value=True), \
            pytest.raises(ValueError, match="vpu: x and y must share"):
        bench_cal.vpu(x, x.float(), 512)
    assert bench_cell.cell.launches == 0 and bench_cal.vpu.launches == 0


def _off16(shape, dtype):
    """A contiguous CPU view whose first element lies off a 16-byte boundary."""
    n = int(np.prod(shape))
    t = torch.arange(n + 1, dtype=torch.float32).to(dtype)[1:].view(*shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("wrapper", ["cell", "vpu"])
def test_wrappers_hand_aligned_pointers(wrapper):
    """The kernels load the coordinates (cell) and x, y (vpu) 16 bytes at a
    time, so a view off a 16-byte boundary reaches the launch as an aligned
    copy and an aligned tensor as itself; the launch is stubbed, so CPU
    tensors stand for CUDA ones."""
    from types import SimpleNamespace
    from unittest import mock

    seen = []

    def fake_launch(source, fn, argtypes, device, *args):
        seen.extend(args)

    if wrapper == "cell":
        mod, fn, n_ptrs = bench_cell, bench_cell.cell, 3
        yr, aw = _off16((16, 16), torch.float32), _off16((16, 16), torch.float32)
        xr = torch.zeros(16, 16)
        ins = (yr, xr, aw)
        wins = [torch.zeros(1, 32, w, w, dtype=torch.bfloat16) for w, _ in jax_cell.WINDOWS]
        call = lambda: fn(yr, xr, aw, wins, 3)  # noqa: E731
    else:
        mod, fn, n_ptrs = bench_cal, bench_cal.vpu, 2
        x, y = _off16((37,), torch.bfloat16), torch.zeros(37, dtype=torch.bfloat16)
        ins = (x, y)
        call = lambda: fn(x, y, 3)  # noqa: E731
    props = SimpleNamespace(multi_processor_count=132)
    with mock.patch.object(mod, "on_card", return_value=True), \
            mock.patch.object(mod, "launch", fake_launch), \
            mock.patch.object(fn, "launches", 0), \
            mock.patch("torch.cuda.get_device_properties", return_value=props):
        call()
    assert len(seen) > n_ptrs
    for t, ptr in zip(ins, seen[:n_ptrs]):
        assert ptr % 16 == 0
        assert (ptr == t.data_ptr()) == (t.data_ptr() % 16 == 0)  # copied only when off
