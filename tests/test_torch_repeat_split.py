"""How the repeat probe's kernel (``csrc/probe_cal.cu:repeat_body``, entered as
``repeat_f32_kernel`` and ``repeat_bf16_kernel``) splits ``run_repeat``,
emulated in numpy on the CPU and held to the port's plain ``repeat_plain``
bit for bit.

The emulation follows the kernel: a block of (wy / V, by, bz) threads
(``bench_cal.repeat_block``) over a grid of (ceil(rows / bz), ceil(wx / by));
thread (g, k, z) of block (bx, by) takes row bx * bz + z, copy
by * blockDim.y + k and the V consecutive columns g * V ... of that copy's
source group (V = 4 in f32, 8 in bf16), so its V chains read V different
sources. Each output keeps its own chain of rounded adds, acc = acc + (x + i):
f32 in float32, bf16 as packed pairs (element 2q in the low half), each half
of ``add.rn.bf16x2`` the float32 sum rounded to bf16 to nearest even (a
single rounding of the exact sum, since 24 >= 2 * 8 + 2), bf16(i) in both
halves.

Cases: run_repeat's [768, 32] -> [768, 1664] over 256 passes in both dtypes,
and ragged launches (rows past the last block's bz, copies past the last
block's by) for the map. Last, the wrapper's refusals and its launch
arguments, reached on a meta tensor that reports a CUDA device.
"""

import numpy as np
import pytest
import torch

from richsem_tpu_torch.tools import bench_cal

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def thread_map(rows, wy, wx, dtype):
    """Every live thread of the launch -> (row, first output column, first
    source column), each an array over threads in launch order; and the
    block's thread count."""
    v = bench_cal.REPEAT_VEC[dtype]
    bx, by, bz = bench_cal.repeat_block(wy, wx, dtype)
    grid = (-(-rows // bz), -(-wx // by))
    gx, gy, tz, ty, tx = np.meshgrid(np.arange(grid[0]), np.arange(grid[1]), np.arange(bz),
                                     np.arange(by), np.arange(bx), indexing="ij")
    r, copy, src = gx * bz + tz, gy * by + ty, tx * v
    live = (r < rows) & (copy < wx)
    return r[live], (copy * wy + src)[live], src[live], bx * by * bz


def to_bf16_bits(f: np.ndarray) -> np.ndarray:
    """float32 -> bf16 bits, rounded to nearest even (no NaN here)."""
    u = np.ascontiguousarray(f, np.float32).view(np.uint32)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32)


def bf16_float(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint32) << 16).view(np.float32)


def bf2_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """add.rn.bf16x2 on uint32 pairs."""
    lo = to_bf16_bits(bf16_float(a & 0xFFFF) + bf16_float(b & 0xFFFF))
    hi = to_bf16_bits(bf16_float(a >> 16) + bf16_float(b >> 16))
    return lo | (hi << 16)


def chains(x: torch.Tensor, reps: int) -> np.ndarray:
    """Each source's chain as a thread computes it -> [rows, wy], f32 values
    or bf16 bits; a thread's V outputs are V of these, one a source."""
    if x.dtype == torch.float32:
        xs = x.numpy()
        acc = np.zeros_like(xs)
        for i in range(reps):
            acc = acc + (xs + np.float32(i))
        return acc
    bits = x.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF
    pairs = bits[:, 0::2] | (bits[:, 1::2] << 16)  # element 2q low, 2q + 1 high
    acc = np.zeros_like(pairs)
    for i in range(reps):
        s = to_bf16_bits(np.float32(i))
        acc = bf2_add(acc, bf2_add(pairs, s | (s << 16)))
    out = np.empty_like(bits)
    out[:, 0::2], out[:, 1::2] = acc & 0xFFFF, acc >> 16
    return out


def emulate(x: torch.Tensor, wx: int, reps: int):
    """The kernel's output and how many times each element was written."""
    rows, wy = x.shape
    v = bench_cal.REPEAT_VEC[x.dtype]
    r, col, src, _ = thread_map(rows, wy, wx, x.dtype)
    per_source = chains(x, reps)
    out = np.zeros((rows, wy * wx), per_source.dtype)
    count = np.zeros((rows, wy * wx), np.int64)
    for e in range(v):
        out[r, col + e] = per_source[r, src + e]
        np.add.at(count, (r, col + e), 1)
    if x.dtype == torch.bfloat16:
        out = torch.from_numpy(out.astype(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        out = torch.from_numpy(out)
    return out, count


@pytest.mark.parametrize("rows,wy,wx", [(768, 32, 52), (37, 32, 53), (5, 64, 700), (3, 8, 1)],
                         ids=["run_repeat", "ragged-rows", "ragged-copies", "one-group"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_thread_map_writes_every_output_once(rows, wy, wx, dtype):
    """Every output is written once, a thread's V sources are distinct and
    are its outputs' columns mod wy, a block has at most 512 threads, and a
    block's threads in launch order write consecutive vectors of a row."""
    dt = DTYPES[dtype]
    v = bench_cal.REPEAT_VEC[dt]
    r, col, src, threads = thread_map(rows, wy, wx, dt)
    assert threads <= bench_cal.REPEAT_THREADS
    count = np.zeros((rows, wy * wx), np.int64)
    for e in range(v):
        np.add.at(count, (r, col + e), 1)
        assert ((col + e) % wy == src + e).all()
    assert (count == 1).all()
    assert (src % v == 0).all() and (src + v <= wy).all()  # V distinct sources in one group
    same_row = r[1:] == r[:-1]
    assert (np.diff(col)[same_row & (np.diff(col) > 0)] == v).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chains_bit_for_bit_with_the_plain_version(dtype):
    """run_repeat's shapes, x uniform in [-2, 2] from a seed (phase 12 of
    chip_smoke.py draws the same range): the kernel's arithmetic on its
    thread map equals ``repeat_plain`` bit for bit."""
    dt = DTYPES[dtype]
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.uniform(-2, 2, (bench_cal.ROWS, 32)).astype(np.float32)).to(dt)
    out, count = emulate(x, 52, 256)
    ref = bench_cal.repeat_plain(x, 52, 256)
    assert (count == 1).all() and out.shape == ref.shape == (768, 1664)
    assert torch.equal(out, ref)
    if dt == torch.bfloat16:  # the pass values above 256 round, as JAX's i.astype(bf16)
        x = x[:4]
        assert torch.equal(emulate(x, 3, 300)[0], bench_cal.repeat_plain(x, 3, 300))


def test_bf16_rounding_is_nearest_even():
    """The emulated packed add against torch's bf16 add on the CPU, ties and
    carries into the exponent included."""
    a = torch.tensor([1.0, 1.0, 255.0, 256.0, -3.0, 1e-3], dtype=torch.bfloat16)
    b = torch.tensor([2.0**-8, 3 * 2.0**-8, 0.5, 1.0, 2.0**-7, -1e-3], dtype=torch.bfloat16)
    bits = [t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF for t in (a, b)]
    got = bf2_add(bits[0], bits[1]) & 0xFFFF
    assert (got == ((a + b).view(torch.int16).numpy().astype(np.uint32) & 0xFFFF)).all()


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrapper's
    kernel path without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    def new_empty(self, size, **kwargs):  # the output, on the meta device too
        return torch.empty(size, dtype=self.dtype, device="meta").as_subclass(_OnCard)


def on_card(rows, wy, dtype, offset=0):
    flat = torch.empty(rows * wy + offset, dtype=dtype, device="meta")
    return flat[offset:].view(rows, wy).as_subclass(_OnCard)


def test_wrapper_refuses_before_launching(monkeypatch):
    """A wrong dtype, a source group the vectors do not tile, a group wider
    than a block or a tensor that is not 2-D raises before any launch; a
    misaligned tensor is copied; a good call launches with the block of
    ``repeat_block``."""
    calls = []
    monkeypatch.setattr(bench_cal, "launch", lambda *a: calls.append(a))
    monkeypatch.setattr(bench_cal.repeat, "launches", 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        bench_cal.repeat(on_card(768, 32, torch.float16), 52, 256)
    with pytest.raises(ValueError, match="multiple of 8"):
        bench_cal.repeat(on_card(768, 12, torch.bfloat16), 52, 256)
    with pytest.raises(ValueError, match="multiple of 4"):
        bench_cal.repeat(on_card(768, 30, torch.float32), 52, 256)
    with pytest.raises(ValueError, match="up to"):
        bench_cal.repeat(on_card(2, 8 * 513, torch.bfloat16), 1, 256)
    with pytest.raises(ValueError, match=r"x \[rows, wy\]"):
        bench_cal.repeat(on_card(768, 32, torch.float32).view(768, 2, 16), 52, 256)
    assert calls == [] and bench_cal.repeat.launches == 0
    for dt, (by, bz) in ((torch.float32, (52, 1)), (torch.bfloat16, (52, 2))):
        x = on_card(768, 32, dt, offset=1)
        assert x.data_ptr() % 16
        out = bench_cal.repeat(x, 52, 256)
        assert out.shape == (768, 1664) and out.dtype == dt
        source, fn, argtypes, device, ptr, _, rows, wy, wx, reps, is_bf16, *block = calls[-1]
        assert (source, fn, device.type) == ("probe_cal", "probe_repeat", "cuda")
        assert ptr % 16 == 0 and (rows, wy, wx, reps) == (768, 32, 52, 256)
        assert is_bf16 == (dt == torch.bfloat16) and tuple(block) == (by, bz)
        assert bench_cal.repeat_block(32, 52, dt)[1:] == (by, bz)
    assert bench_cal.repeat.launches == 2
