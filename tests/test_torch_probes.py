"""The card's calibration probes (``richsem_tpu_torch/tools``) held against the
Pallas probes of ``tools/`` run in interpret mode on the CPU.

Each JAX probe runs as its own ``main()`` would call it, at small sizes: the
module constants are patched down, ``pl.pallas_call`` is wrapped to drop the
TPU compiler parameters and run in interpret mode, and the module's ``timeit``
is replaced to capture the output. The port's functions run on CPU tensors,
which takes their plain versions (the CUDA kernels beside them are held to
those plain versions on the card by ``chip_smoke.py``).

Tolerances: exact for the elementwise probes (the same operations rounded in
the same order, f32 and bf16), but where XLA's CPU backend contracts a
multiply and an add into one fused operation (f32 ``acc + h * y``): there
within an ulp of each term; relative 1e-5 of the largest magnitude for
``run_mxu`` (f32 sums of exact bf16 products, in another order); for
``run_cell`` 4e-3 of the largest magnitude, one bf16 rounding step (2^-8) of
the basis where the two sums of its four products differ in their last bit.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tools.bench_cell as jax_cell
import tools.bench_pallas_cal as jax_cal
import tools.bench_vpu_model as jax_vpu_model
from richsem_tpu_torch.tools import bench_cal, bench_cell, bench_vpu_model

torch.set_num_threads(2)


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


def _capture(monkeypatch, mod):
    """Replace ``mod.timeit``: run the function once and keep its output."""
    outs = []

    def timeit(fn, *args, **kw):
        outs.append(np.asarray(fn(*args)).astype(np.float32))
        return 1.0

    monkeypatch.setattr(mod, "timeit", timeit)
    return outs


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_vpu(monkeypatch, interpret, dtype):
    monkeypatch.setattr(jax_cal, "ROWS", 16)
    monkeypatch.setattr(jax_cal, "S", 128)
    monkeypatch.setattr(bench_cal, "ROWS", 16)
    monkeypatch.setattr(bench_cal, "S", 128)
    outs = _capture(monkeypatch, jax_cal)
    jax_cal.run_vpu(getattr(jnp, dtype), reps=40)
    out, _ = bench_cal.run_vpu(getattr(torch, dtype), reps=40, device="cpu")
    np.testing.assert_array_equal(_np(out), outs[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vpu_kernel_random_inputs(interpret, dtype):
    """The kernel body on random inputs around the pass index, past 256 where
    bf16 integers round."""
    rng = np.random.default_rng(0)
    reps = 300
    x = (rng.uniform(0, reps, (8, 128))).astype(np.float32)
    y = rng.uniform(-1, 2, (8, 128)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = pl.pallas_call(functools.partial(jax_cal.vpu_kernel, reps),
                         out_shape=jax_cal.jax.ShapeDtypeStruct((8, 128), jdt))(
        jnp.asarray(x, jdt), jnp.asarray(y, jdt))
    out = bench_cal.vpu(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt), reps)
    ref = np.asarray(ref).astype(np.float32)
    if dtype == "float32":
        # XLA's CPU backend contracts acc + h * y into a fused multiply-add;
        # the port rounds the product first, as the card's kernel does: an ulp
        np.testing.assert_allclose(_np(out), ref, rtol=2.5e-7, atol=1e-7)
    else:
        np.testing.assert_array_equal(_np(out), ref)


@pytest.mark.parametrize("k,s,d", [(32, 64, 32), (64, 96, 32)])
def test_run_mxu(monkeypatch, interpret, k, s, d):
    outs = _capture(monkeypatch, jax_cal)
    jax_cal.run_mxu(k, s, d, jnp.bfloat16, reps=300)
    out, _ = bench_cal.run_mxu(k, s, d, torch.bfloat16, reps=300, device="cpu")
    ref = outs[0]
    assert np.abs(_np(out) - ref).max() <= 1e-5 * np.abs(ref).max()


def test_mxu_random_inputs():
    """The plain version against a float64 product of the same bf16 operands."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(32, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, 32, generator=g).to(torch.bfloat16)
    out = bench_cal.mxu(a, b, 5)
    ref = sum((a + torch.tensor(i, dtype=torch.bfloat16)).double() @ b.double() for i in range(5))
    assert float((out.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("n_cells", [4, 16])
def test_run_grid_overhead(monkeypatch, interpret, n_cells):
    outs = _capture(monkeypatch, jax_cal)
    jax_cal.run_grid_overhead(n_cells)
    out, _ = bench_cal.run_grid_overhead(n_cells, device="cpu")
    np.testing.assert_array_equal(_np(out), outs[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_repeat(monkeypatch, interpret, dtype):
    monkeypatch.setattr(jax_cal, "ROWS", 16)
    monkeypatch.setattr(bench_cal, "ROWS", 16)
    outs = _capture(monkeypatch, jax_cal)
    jax_cal.run_repeat(getattr(jnp, dtype))
    out, _ = bench_cal.run_repeat(getattr(torch, dtype), device="cpu")
    assert out.shape == (16, 32 * 52)
    np.testing.assert_array_equal(_np(out), outs[0])


def test_check_repeat_semantics(interpret, capsys):
    jax_cell.check_repeat_semantics()
    jax_row = capsys.readouterr().out.strip().split(":", 1)[1]
    out = bench_cell.check_repeat_semantics(device="cpu")
    assert out[0].long().tolist() == eval(jax_row) == list(range(8)) * 2
    assert torch.equal(out, torch.arange(8.0).repeat(8, 2))


@pytest.mark.parametrize("mode", ["2d", "flat"])
def test_run_cell(monkeypatch, interpret, mode):
    for mod in (jax_cell, bench_cell):
        monkeypatch.setattr(mod, "M", 2)
        monkeypatch.setattr(mod, "K", 16)
        monkeypatch.setattr(mod, "MK", 32)
    outs = _capture(monkeypatch, jax_cell)
    jax_cell.run_cell(mode, reps=3)
    out, _ = bench_cell.run_cell(mode, reps=3, device="cpu")
    assert out.shape == (2, 16, 32)
    ref = outs[0]
    assert np.abs(_np(out) - ref).max() <= 4e-3 * np.abs(ref).max()


def test_cell_inputs_are_the_jax_probes(monkeypatch):
    for mod in (jax_cell, bench_cell):
        monkeypatch.setattr(mod, "MK", 32)
        monkeypatch.setattr(mod, "M", 2)
    (yr, xr, aw), wins = bench_cell.cell_inputs("cpu")
    rng = np.random.default_rng(0)
    for t in (yr, xr):
        np.testing.assert_array_equal(t.numpy(), rng.uniform(2, 20, (32, 16)).astype(np.float32))
    np.testing.assert_array_equal(aw.numpy(), rng.uniform(0, 1, (32, 16)).astype(np.float32))
    for w, (wy, wx) in zip(wins, jax_cell.WINDOWS):
        ref = jnp.asarray(rng.normal(size=(2, 32, wy, wx)), jnp.bfloat16)
        np.testing.assert_array_equal(w.float().numpy(), np.asarray(ref).astype(np.float32))


SMALL = dict(T=2, M=2, WY=3, WXP=4, K=256)


def _small_vpu_model(monkeypatch):
    for mod in (jax_vpu_model, bench_vpu_model):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


@pytest.mark.parametrize("n_ops", [1, 2, 4, 8])
def test_chain(monkeypatch, interpret, n_ops):
    _small_vpu_model(monkeypatch)
    big = (2, 2, 3, 4, 256)
    f, args = jax_vpu_model.run(jax_vpu_model.chain_kernel, [big], extra=(n_ops,))
    ref = np.asarray(interpret[-1](*args))
    tf, targs = bench_vpu_model.run(bench_vpu_model.chain, [big], extra=(n_ops,), device="cpu")
    np.testing.assert_array_equal(targs[0].numpy(), np.asarray(args[0]))
    np.testing.assert_array_equal(bench_vpu_model.chain(targs[0], n_ops).numpy(), ref)
    np.testing.assert_allclose(float(tf(*targs)), float(f(*args)), rtol=1e-5)


@pytest.mark.parametrize("p,two_acc,chunk", [(1, False, False), (2, False, False),
                                             (4, False, False), (4, True, False),
                                             (4, False, True)],
                         ids=["fma-1", "fma-2", "fma-4", "fma-4-2acc", "fma-4-chunk"])
def test_fma(monkeypatch, interpret, p, two_acc, chunk):
    _small_vpu_model(monkeypatch)
    hats = [(2, 2, 3, 4 * 256), (2, 2, 4, 4 * 256)]
    if chunk:
        f, args = jax_vpu_model.run(jax_vpu_model.fma_chunk_kernel, hats, extra=(p,))
        fn = lambda hy, hx: bench_vpu_model.fma_chunk(hy, hx, p)  # noqa: E731
    else:
        f, args = jax_vpu_model.run(jax_vpu_model.fma_kernel, hats, extra=(p, two_acc))
        fn = lambda hy, hx: bench_vpu_model.fma(hy, hx, p, two_acc)  # noqa: E731
    ref = np.asarray(interpret[-1](*args))
    _, targs = bench_vpu_model.run(bench_vpu_model.fma, hats, device="cpu")
    for t, a in zip(targs, args):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    out = fn(*targs)
    assert out.shape == (2, 2, 3, 4, 256)
    # XLA's CPU backend contracts acc + hy * hx into fused multiply-adds; the
    # port rounds every product, as the card's kernel does: within an ulp of
    # each of the P terms
    bound = 2.0**-21 * bench_vpu_model.fma_plain(targs[0].abs(), targs[1].abs(), p, False)
    assert ((out - torch.from_numpy(np.array(ref))).abs() <= bound).all()
    np.testing.assert_allclose(float(out.sum()), float(f(*args)), rtol=1e-5)


def test_wrappers_refuse_other_devices():
    x = torch.zeros(2, 8, 128, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        bench_cal.grid_overhead(x)
    assert bench_cal.grid_overhead.launches == 0
