"""How ``mxu_kernel`` (``csrc/probe_cal.cu``), ``fma_kernel``
(``csrc/probe_vpu_model.cu``) and ``tile_kernel`` (``csrc/probe_cell.cu``)
split their work, emulated in plain torch on the CPU and held against the Pallas probes of ``tools/`` in interpret mode (as
``tests/test_torch_probes.py`` runs them) and against the port's plain versions.

The emulations follow the kernels:

* mxu: a grid of 64-row tiles x column tiles x R (``bench_cal.mxu_splits``:
  as many blocks as fill 132 SMs in one wave), the two warpgroups of block z
  taking rep ranges 2 z and 2 z + 1 of 2 R (range j holds reps
  ``[j reps / 2R, (j + 1) reps / 2R)``). The rows past
  k of the last tile (rows 96-127 at k = 96) and the s past s of the last
  64-wide chunk are staged as zeros, and their outputs are not written. Each
  warpgroup walks the chunks in order and, per chunk, its reps in groups of
  G (2 at a 128-wide column tile, 4 at a 32-wide one), adding
  ``bf16(a + bf16(i)) @ b`` into the tensor-core accumulators; every
  32 reps (counted in groups, across chunks) and at the end the
  accumulators are added into an f32 carry. Both warpgroups of a block run
  as many groups as the longer of its two ranges needs, a rep past a range
  adding zeros. The second pass sums the 2 R partials in a fixed order: chain
  y of 8 takes ranges y, y + 8, ... in order, then the chains are added in
  order. All column tiles (and all row tiles) of a rep range are computed at
  once: they are independent.
* fma: a block per (t·m, 128-wide chunk of k, 32 x); its 8 warps take y = w,
  w + 8, ...; a lane holds one float4 of k, the x walk in order; lanes past K
  and x past WXP write nothing. Each output element is written once with the
  plain version's operations in its order, so the result is bit for bit.
* tile: a thread a source element, writing its copies; rows step over the
  grid's height (at most 65,535 blocks of 8 rows).

Tolerances: mxu relative 1e-5 of the largest magnitude (``chip_smoke.py``
phase 12's: f32 sums of exact bf16 products in another order); fma exact
against the plain versions, and within an ulp of each of the P terms against
the Pallas kernel (XLA's CPU backend contracts its sums into fused
multiply-adds, as ``test_torch_probes.py:test_fma`` says).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.bench_pallas_cal as jax_cal
import tools.bench_vpu_model as jax_vpu_model
from richsem_tpu_torch.tools import bench_cal, bench_vpu_model

torch.set_num_threads(2)

N_SM = 132  # the H100's SMs, as the wrapper reads them from the card
JAX_MXU = ((768, 1664, 128), (768, 1664, 32), (96, 1664, 32), (96, 1664, 128))
# csrc/probe_cal.cu, namespace mxu: s staged a chunk at a time, reps between
# flushes into the carry, reps a group at a column tile of 128 and of 32
MXU_CHUNK, MXU_FLUSH, MXU_GROUP = 64, 32, {128: 2, 32: 4}
# csrc/probe_vpu_model.cu: a block's warps (over y), k and x
FMA_WARPS, FMA_KC, FMA_XB = 8, 128, 32


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


def _step(i):
    return torch.tensor(i, dtype=torch.bfloat16)


def mxu_emulate(a, b, reps, n_sm=N_SM):
    """mxu_kernel's partition on the CPU; -> (out [k, d] f32, R)."""
    (k, s), d = a.shape, b.shape[1]
    bench_cal.mxu_check(k, s, d)
    rows, cw = bench_cal.MXU_ROWS, MXU_CHUNK
    splits = bench_cal.mxu_splits(k, d, reps, n_sm)
    G = MXU_GROUP[bench_cal.mxu_tile_n(d)]
    chunks = -(-s // cw)
    a_st = torch.zeros(-(-k // rows) * rows, chunks * cw, dtype=torch.bfloat16)
    a_st[:k, :s] = a
    b_st = torch.zeros(chunks * cw, d, dtype=torch.bfloat16)
    b_st[:s] = b
    parts = []
    for j in range(2 * splits):
        i0, i1 = bench_cal.mxu_rep_range(j, 2 * splits, reps)
        # both warpgroups of the block run the longer range's groups of G reps
        z = j - j % 2
        longer = max(i1_ - i0_ for i0_, i1_ in (bench_cal.mxu_rep_range(z + g, 2 * splits, reps)
                                                for g in (0, 1)))
        groups = -(-longer // G)
        acc = torch.zeros(a_st.shape[0], d)
        carry = torch.zeros_like(acc)
        since = 0
        for c in range(chunks):
            ac, bc = a_st[:, c * cw:(c + 1) * cw], b_st[c * cw:(c + 1) * cw].float()
            for t in range(groups):
                for r in range(i0 + G * t, i0 + G * t + G):
                    if r < i1:  # a rep past the range adds zeros
                        acc = acc + (ac + _step(r)).float() @ bc
                since += G
                if since >= MXU_FLUSH:
                    carry, acc, since = carry + acc, torch.zeros_like(acc), 0
        parts.append((carry + acc)[:k])  # rows past k are not written
    # the second pass: chain y of 8 sums ranges y, y + 8, ... in order, then
    # the 8 chains are added in order
    chains = [sum(parts[y::8], torch.zeros(k, d)) for y in range(min(8, len(parts)))]
    out = chains[0]
    for ch in chains[1:]:
        out = out + ch
    return out, splits


def _rel_err(out, ref):
    return float((out.double() - ref.double()).abs().max()) / float(ref.abs().max())


@pytest.mark.parametrize("k,s,d,reps", [(96, 64, 32, 7), (64, 96, 32, 5), (32, 128, 64, 40)],
                         ids=["masked-half-tile", "chunk-past-s", "two-column-tiles"])
def test_mxu_split_against_jax(monkeypatch, interpret, k, s, d, reps):
    outs = []
    monkeypatch.setattr(jax_cal, "timeit",
                        lambda fn, *a, **kw: outs.append(np.array(fn(*a))) or 1.0)
    jax_cal.run_mxu(k, s, d, jnp.bfloat16, reps=reps)
    out, splits = mxu_emulate(torch.ones(k, s, dtype=torch.bfloat16),
                              torch.ones(s, d, dtype=torch.bfloat16), reps)
    assert splits == min(-(-reps // 2), N_SM // (-(-k // 64) * (d // bench_cal.mxu_tile_n(d))))
    assert _rel_err(out, torch.from_numpy(outs[0])) <= 1e-5


PRODUCTION_KD = [(768, 128), (768, 32), (96, 32), (96, 128)]


def _ab(k, d, s):
    g = torch.Generator().manual_seed(k + d + s)
    return (torch.randn(k, s, generator=g).to(torch.bfloat16),
            torch.randn(s, d, generator=g).to(torch.bfloat16))


@pytest.mark.parametrize("k,d", PRODUCTION_KD)
@pytest.mark.parametrize("s", [128, 112])
def test_mxu_split_production_widths(k, d, s):
    """The four JAX (k, d) at the JAX reps with s cut to 112-128 (a chunk
    partly past s)."""
    a, b = _ab(k, d, s)
    out, splits = mxu_emulate(a, b, 512)
    assert splits == {768: 11, 96: 66}[k]
    assert _rel_err(out, bench_cal.mxu_plain(a, b, 512)) <= 1e-5


@pytest.mark.parametrize("k,d", PRODUCTION_KD)
def test_mxu_split_flushes_into_the_carry(k, d):
    """20 reps a warpgroup over two chunks: the accumulators are flushed into
    the carry inside the second chunk (bf16(i) rounds past 256). The reference
    sums the exact products in float64: the plain version's running f32 sum
    drifts by ~1e-5 of the largest magnitude over 2,640 reps."""
    s, reps = 128, {768: 440, 96: 2640}[k]
    a, b = _ab(k, d, s)
    out, splits = mxu_emulate(a, b, reps)
    assert reps // (2 * splits) == 20 and 20 * 2 > MXU_FLUSH
    ref = sum((a + _step(i)).double() @ b.double() for i in range(reps))
    assert _rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("reps", [0, 1, 7, 65, 511, 512, 513])
def test_mxu_rep_ranges_cover_every_rep_once(reps):
    for k, _, d in JAX_MXU:
        splits = bench_cal.mxu_splits(k, d, reps, N_SM)
        tiles = -(-k // 64) * (d // bench_cal.mxu_tile_n(d))
        assert 1 <= splits and tiles * splits <= max(N_SM, tiles)
        ranges = [bench_cal.mxu_rep_range(j, 2 * splits, reps) for j in range(2 * splits)]
        assert [i for i0, i1 in ranges for i in range(i0, i1)] == list(range(reps))
        sizes = [i1 - i0 for i0, i1 in ranges]
        assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("k,s,d", JAX_MXU + ((96, 32, 32), (1, 16, 64), (100, 48, 96)))
def test_mxu_check_accepts(k, s, d):
    bench_cal.mxu_check(k, s, d)


@pytest.mark.parametrize("k,s,d", [(0, 64, 32), (96, 24, 32), (96, 0, 32), (96, 64, 48),
                                   (96, 64, 16), (96, 64, 0)])
def test_mxu_check_refuses(k, s, d):
    with pytest.raises(ValueError, match="mxu: needs"):
        bench_cal.mxu_check(k, s, d)


def fma_emulate(hy, hx, p_pts, two_acc):
    """fma_kernel's tiling on the CPU; -> (out, how often each element was
    written)."""
    t, m, wy, k4 = hy.shape
    wxp, kk = hx.shape[2], k4 // 4
    warps, kc_w, xb_w = FMA_WARPS, FMA_KC, FMA_XB
    hy2, hx2 = hy.reshape(t * m, wy, k4), hx.reshape(t * m, wxp, k4)
    out = torch.full((t * m, wy, wxp, kk), float("nan"))
    count = torch.zeros(out.shape, dtype=torch.int32)
    for tm in range(t * m):
        for kc in range(-(-kk // kc_w)):
            ks = torch.arange(kc * kc_w, min(kk, (kc + 1) * kc_w))  # the live lanes' k
            for xb in range(-(-wxp // xb_w)):
                x0 = xb * xb_w
                xs = slice(x0, min(wxp, x0 + xb_w))
                hxs = [hx2[tm, xs][:, p * kk + ks] for p in range(p_pts)]  # shared memory
                for w in range(warps):
                    for y in range(w, wy, warps):
                        a = [hy2[tm, y, p * kk + ks] for p in range(p_pts)]  # registers
                        acc0 = acc1 = None
                        for p in range(p_pts):
                            prod = a[p][None] * hxs[p]
                            if two_acc and p % 2:
                                acc1 = prod if acc1 is None else acc1 + prod
                            else:
                                acc0 = prod if acc0 is None else acc0 + prod
                        if two_acc and p_pts > 1:
                            acc0 = acc0 + acc1
                        out[tm, y, xs, ks] = acc0
                        count[tm, y, xs, ks] += 1
    return out.reshape(t, m, wy, wxp, kk), count


FMA_CASES = [(1, False, False), (2, False, False), (3, False, False), (4, False, False),
             (4, True, False), (3, True, False), (4, False, True)]
FMA_IDS = ["fma-1", "fma-2", "fma-3", "fma-4", "fma-4-2acc", "fma-3-2acc", "fma-4-chunk"]


def _hats(t, m, wy, wxp, kk, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(t, m, wy, 4 * kk)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(t, m, wxp, 4 * kk)).astype(np.float32)))


SHAPES = {"ragged": (2, 2, 11, 37, 132), "production-cell": (1, 2, 28, 32, 384)}


@pytest.mark.parametrize("p,two_acc,chunk,shape", [
    (*case, shape) for case, name in zip(FMA_CASES, FMA_IDS) for shape in SHAPES
    if not (case[2] and SHAPES[shape][4] % 128)  # fma_chunk_plain walks 128-lane chunks
], ids=[f"{name}-{shape}" for case, name in zip(FMA_CASES, FMA_IDS) for shape in SHAPES
        if not (case[2] and SHAPES[shape][4] % 128)])
def test_fma_split_bit_for_bit(p, two_acc, chunk, shape):
    """Every (t, m, y, x, k) written once, equal to the plain version's bits:
    WY = 11 and 28 are not multiples of the 8 warps, WXP = 37 spans two
    x-blocks, K = 132 leaves 31 lanes of its second k-chunk idle."""
    shape = SHAPES[shape]
    hy, hx = _hats(*shape, seed=sum(shape) + p)
    out, count = fma_emulate(hy, hx, p, two_acc)
    assert bool((count == 1).all())
    if chunk:
        ref = bench_vpu_model.fma_chunk_plain(hy, hx, p)
    else:
        ref = bench_vpu_model.fma_plain(hy, hx, p, two_acc)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("p,two_acc,chunk", [c for c in FMA_CASES if c[0] != 3],
                         ids=[i for i in FMA_IDS if "3" not in i])
def test_fma_split_against_jax(monkeypatch, interpret, p, two_acc, chunk):
    shape = dict(T=2, M=2, WY=11, WXP=37, K=256)
    for mod in (jax_vpu_model, bench_vpu_model):
        for key, v in shape.items():
            monkeypatch.setattr(mod, key, v)
    hats = [(2, 2, 11, 4 * 256), (2, 2, 37, 4 * 256)]
    if chunk:
        _, args = jax_vpu_model.run(jax_vpu_model.fma_chunk_kernel, hats, extra=(p,))
    else:
        _, args = jax_vpu_model.run(jax_vpu_model.fma_kernel, hats, extra=(p, two_acc))
    ref = torch.from_numpy(np.array(interpret[-1](*args)))
    hy, hx = (torch.from_numpy(np.array(x)) for x in args)
    out, count = fma_emulate(hy, hx, p, two_acc)
    assert bool((count == 1).all())
    # within an ulp of each of the P terms (XLA contracts the sums into FMAs)
    bound = 2.0**-21 * bench_vpu_model.fma_plain(hy.abs(), hx.abs(), p, False)
    assert bool(((out - ref).abs() <= bound).all())


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("wy,wxp", [(28, 32), (1, 1), (11, 37)])
def test_fma_check_accepts(p, wy, wxp):
    bench_vpu_model.fma_check((154, 8, wy, 4 * 384), (154, 8, wxp, 4 * 384), p)


@pytest.mark.parametrize("hy,hx,p", [
    ((154, 8, 28, 1544), (154, 8, 32, 1544), 4),   # K = 386: rows not 16-byte aligned
    ((154, 8, 28, 1536), (154, 8, 32, 1536), 0),
    ((154, 8, 28, 1536), (154, 8, 32, 1536), 5),
    ((154, 8, 28, 1536), (154, 4, 32, 1536), 2),   # another M
    ((154, 8, 28, 1536), (154, 8, 32, 1024), 2),   # another K
    ((154, 8, 0, 1536), (154, 8, 32, 1536), 1),    # no y
    ((0, 8, 28, 1536), (0, 8, 32, 1536), 1),       # no cell
    ((154, 8, 28, 1536), (8, 32, 1536), 1),
])
def test_fma_check_refuses(hy, hx, p):
    with pytest.raises(ValueError, match="fma: needs"):
        bench_vpu_model.fma_check(hy, hx, p)


def tile_emulate(x, times, max_height=65535):
    """tile_kernel's threads (csrc/probe_cell.cu) on the CPU: thread (c, r) of
    a (32, 8) block copies x[r, c] to out[r, j w + c] for j < times, the rows
    stepping by the grid's height; -> (out, how often each element was
    written)."""
    rows, w = x.shape
    out = torch.full((rows, w * times), float("nan"))
    count = torch.zeros(out.shape, dtype=torch.int32)
    height = min(-(-rows // 8), max_height)
    for bx in range(-(-w // 32)):
        for by in range(height):
            for ty in range(8):
                cs = torch.arange(bx * 32, min(w, bx * 32 + 32))
                for r in range(by * 8 + ty, rows, height * 8):
                    for j in range(times):
                        out[r, j * w + cs] = x[r, cs]
                        count[r, j * w + cs] += 1
    return out, count


@pytest.mark.parametrize("rows,w,times,max_height", [(8, 8, 2, 65535), (37, 45, 3, 65535),
                                                     (37, 45, 3, 2), (1, 1, 1, 65535)],
                         ids=["probe", "ragged", "grid-stride", "one"])
def test_tile_split_covers_every_element_once(rows, w, times, max_height):
    """The tiling of check_repeat_semantics, equal to x.repeat (the plain
    version); max_height 2 makes the rows step over the grid."""
    x = torch.from_numpy(np.random.default_rng(rows + w).normal(size=(rows, w)).astype(np.float32))
    out, count = tile_emulate(x, times, max_height)
    assert bool((count == 1).all())
    assert torch.equal(out, x.repeat(1, times))


def test_wrappers_check_before_launch():
    """A CUDA tensor the kernels do not take is refused before any launch; the
    check reached through a meta tensor that reports a CUDA device."""
    from unittest import mock

    a = torch.zeros(96, 24, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(24, 32, dtype=torch.bfloat16, device="meta")
    with mock.patch.object(bench_cal, "on_card", return_value=True), \
            pytest.raises(ValueError, match="mxu: needs"):
        bench_cal.mxu(a, b, 4)
    hy = torch.zeros(2, 2, 3, 1544, device="meta")
    hx = torch.zeros(2, 2, 4, 1544, device="meta")
    with mock.patch.object(bench_vpu_model, "on_card", return_value=True), \
            pytest.raises(ValueError, match="fma: needs"):
        bench_vpu_model.fma(hy, hx, 4)
    assert bench_cal.mxu.launches == 0 and bench_vpu_model.fma.launches == 0
