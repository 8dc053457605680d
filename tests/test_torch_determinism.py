"""The port's train step repeats bit for bit (ROADMAP F-P6).

* Two eager steps of the tiny CLIP flagship (``tests/test_torch_flagship_train.py``'s
  recipe and teacher) from one state, batch and set of draws, on four CPU
  threads, in both decoder routes: every metric, gradient, parameter, AdamW
  moment and EMA leaf equal bit for bit.
* The plain versions of K1-bwd and K3-bwd, the CPU's reference, repeat bit for
  bit on four threads.
* The mask heads' resizes (``models/segmentation.py``): their gradients, the
  products with the resize's weights, against autograd of ``index_select``
  and of ``F.interpolate``, and bit for bit from call to call.
* The deterministic d_value pass of K1-bwd and K3-bwd
  (``csrc/msda_dvalue.cuh``), emulated in ``tests/msda_dvalue_pass.py``: the
  taps placed in their keys' segments in three orders give the same d_value
  bit for bit, held against the JAX package's VJPs (the exact gather on F3's
  256 x 384 canvas with a 200 x 300 valid extent and offsets on the clamp's
  edge, f32 to 1e-5 of the largest magnitude; ``ms_deform_attn_sep_pallas``
  in interpret mode, f32 to 5e-5 and bf16 to one bf16 step); the fixed-point
  shift ``dv_shift``, its range and its refusals; the fixed-point sum against
  the exact sum, and with a bound that is not finite.

Inputs are drawn with numpy from fixed seeds.
"""

import fractions
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msda_dvalue_pass as dvalue_pass
from richsem_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from richsem_tpu.ops.ms_deform_attn_sep_pallas import ms_deform_attn_sep_pallas
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.models.segmentation import (nearest_index, upsample_bilinear,
                                                   upsample_nearest)
from richsem_tpu_torch.models.transformer_utils import encoder_reference_points
from richsem_tpu_torch.ops import ms_deform_attn as k1
from richsem_tpu_torch.ops import ms_deform_attn_sep as k3
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import build_optimizer
from richsem_tpu_torch.utils.misc import resize_mask, valid_ratios
from tests.test_torch_clip import tiny_pair
from tests.test_torch_flagship_train import CONFIG, FLAGSHIP, _batches, _with_teacher_keys

F3_SHAPES = ((32, 48), (16, 24), (8, 12), (4, 6))  # the 256 x 384 canvas's pyramid


@pytest.fixture
def four_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _state_of(state):
    """Everything a step changes or leaves behind, copied."""
    opt = state.optimizer
    out = {f"param {n}": p.detach().clone() for n, p in state.model.named_parameters()}
    out.update({f"grad {n}": t.grad.clone() for n, t in opt.trainable + opt.frozen
                if t.grad is not None})
    out.update({f"mu {i}": t.clone() for i, t in enumerate(opt.mu)})
    out.update({f"nu {i}": t.clone() for i, t in enumerate(opt.nu)})
    out.update({f"ema {k}": t.clone() for k, t in (state.ema or {}).items()})
    return out


def _put(state, saved):
    opt = state.optimizer
    with torch.no_grad():
        for n, p in state.model.named_parameters():
            p.copy_(saved[f"param {n}"])
        for i, t in enumerate(opt.mu):
            t.copy_(saved[f"mu {i}"])
        for i, t in enumerate(opt.nu):
            t.copy_(saved[f"nu {i}"])
        for k, t in (state.ema or {}).items():
            t.copy_(saved[f"ema {k}"])


@pytest.mark.parametrize("route", ["default", "sep_pallas"])
def test_two_eager_steps_repeat_bit_for_bit(four_threads, route):
    cfg = Config.fromfile(CONFIG)
    cfg.update(dict(FLAGSHIP, **({"dec_msda_impl": route} if route != "default" else {})))
    g = torch.Generator().manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device="cpu", generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2),
                               use_ema=cfg.use_ema)
    step = make_train_step(model, cfg, device="cpu", clip_model=tiny_pair(seed=5)[2])
    batch = {k: torch.from_numpy(v) for k, v in _with_teacher_keys(_batches())[0].items()}
    batch["labels"] = batch["labels"].long()
    text = torch.from_numpy(np.random.default_rng(2).normal(
        size=(cfg.num_classes, 16)).astype(np.float32))
    draws = step.draws(state, batch["labels"].shape[0])
    start, count = _state_of(state), state.optimizer.count
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    runs = []
    for _ in range(2):
        _put(state, start)
        state.optimizer.count, state.step = count, 0
        metrics = step.eager(state, batch, text, draws=draws)
        runs.append(({k: v.clone() for k, v in metrics.items()}, _state_of(state)))
    (m1, s1), (m2, s2) = runs
    assert bool(m1["finite"]) and math.isfinite(float(m1["grad_norm"]))
    assert [k for k in m1 if not torch.equal(m1[k], m2[k])] == []
    assert set(s1) == set(s2) and any(k.startswith("grad ") for k in s1)
    assert [k for k in s1 if not torch.equal(s1[k], s2[k])] == []
    assert [k for k in start if k.startswith("param ")
            and not torch.equal(start[k], s1[k])], "the step moved no parameter"
    # the step leaves PyTorch's settings as they were
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before


def test_train_step_body_runs_with_deterministic_convolutions():
    """The body runs under cuDNN's deterministic mode (no benchmark), seen
    from inside the forward, and puts the caller's settings back, also when
    it raises."""
    cfg = Config.fromfile(CONFIG)
    cfg.update(FLAGSHIP)
    g = torch.Generator().manual_seed(0)
    model, _, _ = build_model("richsem", cfg, device="cpu", generator=g)
    state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2))
    step = make_train_step(model, cfg, device="cpu", clip_model=tiny_pair(seed=5)[2])
    seen = []

    def loss_fn(*a, **kw):
        seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
        raise RuntimeError("stop")

    step.loss_fn = loss_fn
    before = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    try:
        with pytest.raises(RuntimeError, match="stop"):
            step.body(state, {}, {})
        assert seen == [(True, False)]
        assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False, True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = before


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("src,dst", [((7, 9), (14, 18)), ((5, 6), (13, 17)), ((28, 42), (56, 84)),
                                     ((4, 5), (3, 4))])
def test_resize_gradient_is_a_fixed_order_product(mode, src, dst):
    """The resize's forward equals the library's bit for bit; its gradient,
    S_h^T d_y S_w, equals autograd's (an indexed add, or upsample's own) to
    f32 rounding, and two calls agree bit for bit."""
    import torch.nn.functional as F

    rng = np.random.default_rng(20)
    x = torch.from_numpy(rng.normal(size=(3, 2, *src)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(3, 2, *dst)).astype(np.float32))

    def ours():
        leaf = x.clone().requires_grad_()
        fn = upsample_nearest if mode == "nearest" else upsample_bilinear
        y = fn(leaf, dst)
        return y, torch.autograd.grad(y, leaf, dy)[0]

    leaf = x.clone().requires_grad_()
    if mode == "nearest":
        y_ref = leaf.index_select(2, nearest_index(src[0], dst[0])).index_select(
            3, nearest_index(src[1], dst[1]))
    else:
        y_ref = F.interpolate(leaf, size=dst, mode="bilinear", align_corners=False)
    (g_ref,) = torch.autograd.grad(y_ref, leaf, dy)
    (y1, g1), (y2, g2) = ours(), ours()
    assert torch.equal(y1, y_ref.detach())
    assert torch.equal(g1, g2)
    np.testing.assert_allclose(g1.numpy(), g_ref.numpy(), rtol=0,
                               atol=1e-6 * float(g_ref.abs().max()))


def _sampler_inputs(seed, q=None, shapes=F3_SHAPES, m=4, d=32, p=4):
    """F3's encoder (offsets on the clamp's edge, +-5.5 px, the reference
    points scaled by the levels' unequal valid ratios) or ``q`` unclamped
    decoder queries, some taps out of bounds. -> (val, loc, aw, g) f32."""
    rng = np.random.default_rng(seed)
    b, n_lvl = 2, len(shapes)
    s = sum(h * w for h, w in shapes)
    val = rng.normal(size=(b, s, m, d)).astype(np.float32)
    if q is None:
        q = s
        pad = torch.ones(b, 256, 384, dtype=torch.bool)
        pad[:, :200, :300] = False
        vr = torch.stack([valid_ratios(resize_mask(pad, hw)) for hw in shapes], 1)
        offs = np.where(rng.uniform(size=(b, s, m, n_lvl, p, 2)) < 0.5, 5.5, -5.5)
        loc = k1.compute_sampling_locations(encoder_reference_points(shapes, vr),
                                            torch.from_numpy(offs.astype(np.float32)),
                                            shapes, p).numpy()
    else:
        loc = rng.uniform(-0.1, 1.1, (b, q, m, n_lvl, p, 2)).astype(np.float32)
    a = rng.uniform(0.05, 1.0, (b, q, m, n_lvl * p))
    aw = (a / a.sum(-1, keepdims=True)).reshape(b, q, m, n_lvl, p).astype(np.float32)
    return val, loc, aw, rng.normal(size=(b, q, m * d)).astype(np.float32)


def _orders(n, which):
    if which == "taps":
        return np.arange(n)
    if which == "reversed":
        return np.arange(n)[::-1]
    return np.random.default_rng(3).permutation(n)


@pytest.mark.parametrize("order", ["taps", "reversed", "shuffled"])
def test_k1_dvalue_pass_matches_jax_gather_on_f3_clamp_edge(order):
    """K1-bwd's d_value pass in three placement orders: bit for bit the same,
    and within 1e-5 of the largest magnitude of JAX's exact-gather VJP on F3's
    canvas, every tap on the clamp's edge."""
    val, loc, aw, g = _sampler_inputs(10)
    base = dvalue_pass.d_value(loc, aw, g, F3_SHAPES, val.shape)
    got = dvalue_pass.d_value(loc, aw, g, F3_SHAPES, val.shape,
                              order=_orders(aw.size, order))
    np.testing.assert_array_equal(got, base)
    _, vjp = jax.vjp(lambda v: jax_msda(v, F3_SHAPES, jnp.asarray(loc), jnp.asarray(aw)),
                     jnp.asarray(val))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.fixture
def _interpret_mode(monkeypatch):
    import richsem_tpu.ops.ms_deform_attn_sep_pallas as sp
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        kw.pop("compiler_params", None)
        return orig(*a, **kw)

    monkeypatch.setattr(sp.pl, "pallas_call", patched)


SEP_SHAPES = ((12, 10), (6, 5))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("order", ["taps", "shuffled"])
def test_k3_dvalue_pass_matches_sep_pallas_vjp(_interpret_mode, order, dtype):
    """K3-bwd's d_value pass in two placement orders: bit for bit the same,
    and against the VJP of ``ms_deform_attn_sep_pallas`` in interpret mode
    (f32 within 5e-5 of the largest magnitude; bf16 within one bf16 step)."""
    bf16 = dtype == "bf16"
    val, loc, aw, g = _sampler_inputs(11, q=37, shapes=SEP_SHAPES, m=2, p=4)
    if bf16:
        val, g = (torch.from_numpy(x).bfloat16().float().numpy() for x in (val, g))
    base = dvalue_pass.d_value(loc, aw, g, SEP_SHAPES, val.shape, kernel="k3", bf16=bf16)
    got = dvalue_pass.d_value(loc, aw, g, SEP_SHAPES, val.shape, kernel="k3", bf16=bf16,
                              order=_orders(aw.size, order))
    np.testing.assert_array_equal(got, base)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    _, vjp = jax.vjp(lambda v: ms_deform_attn_sep_pallas(v, SEP_SHAPES, jnp.asarray(loc),
                                                         jnp.asarray(aw)),
                     jnp.asarray(val, jdt))
    ref = np.asarray(vjp(jnp.asarray(g, jdt))[0], np.float32)
    scale = np.abs(ref).max()
    if bf16:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * scale)


@pytest.mark.parametrize("which", ["k1", "k3-f32", "k3-bf16"])
def test_plain_backward_repeats_bit_for_bit(four_threads, which):
    """The CPU reference of K1-bwd (autograd of the plain gather) and K3-bwd
    (the explicit plain backward), twice on four threads: equal bit for bit."""
    val, loc, aw, g = _sampler_inputs(12, q=300, shapes=F3_SHAPES)
    dt = torch.bfloat16 if which == "k3-bf16" else torch.float32
    v, lc, a, gr = (torch.from_numpy(x) for x in (val, loc, aw, g))
    v, gr = v.to(dt), gr.to(dt)

    def grads():
        if which == "k1":
            leaves = [t.clone().requires_grad_() for t in (v, lc, a)]
            out = k1.ms_deform_attn(leaves[0], F3_SHAPES, leaves[1], leaves[2])
            return torch.autograd.grad(out, leaves, gr)
        return k3.ms_deform_attn_sep_backward_plain(v, F3_SHAPES, lc, a, gr)

    first, second = grads(), grads()
    for name, x, y in zip(("d_value", "d_loc", "d_aw"), first, second):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("mx,n", [(1.0, 1), (1.0, 2), (0.75, 3), (3.0e38, 1), (3.0e38, 4096),
                                  (1e-45, 1), (1e-45, 70_000), (6.1e-5, 17_600),
                                  (2.0 ** -126, 5), (np.float32(1 - 2 ** -24), 2 ** 20)])
def test_dv_shift_keeps_the_sum_in_range(mx, n):
    """n terms below twice the bound mx, each rounded up by 1/2 at worst, sum
    below 2^63 (2 n mx 2^k <= 2^62), and the shift uses the room: 8 n mx 2^k
    > 2^62."""
    k = int(dvalue_pass.dv_shift(mx, n))
    exact = n * fractions.Fraction(float(np.float32(mx))) * fractions.Fraction(2) ** k
    assert 2 * exact <= 2 ** 62
    assert 2 * exact + fractions.Fraction(n, 2) < 2 ** 63
    assert 8 * exact > 2 ** 62


@pytest.mark.parametrize("mx,n", [(float("nan"), 3), (float("inf"), 3), (-float("inf"), 1),
                                  (0.0, 4), (-1.0, 2), (1.0, 0)])
def test_dv_shift_refuses(mx, n):
    """No shift for a largest term that is not finite and positive, or no term
    (the pass writes 0, NaN or the infinity before it asks)."""
    with pytest.raises(ValueError, match="no fixed-point shift"):
        dvalue_pass.dv_shift(mx, n)


@pytest.mark.parametrize("slack", [1.0, 3.0], ids=["tight", "loose"])
@pytest.mark.parametrize("seed", range(4))
def test_fixed_point_sum_is_exact_to_one_rounding_in_every_order(seed, slack):
    """Terms over twelve decades: the sum is the same in three orders and lies
    within one float32 rounding (plus the terms' quantization, n 2^-k) of
    the exact sum, with a bound equal to the largest |term| or three times it
    (the call's bound, max|g| times the largest factor bound, lies above)."""
    rng = np.random.default_rng(seed)
    n, d = 257, 32
    terms = (rng.normal(size=(n, d)) * 10.0 ** rng.uniform(-8, 4, (n, d))).astype(np.float32)
    rows = np.zeros(n, np.int64)
    bound = np.abs(terms).max() * np.float32(slack)
    sums = [dvalue_pass.fixed_point_sums(terms[o], rows, 1, bound)[0]
            for o in (np.arange(n), np.arange(n)[::-1], rng.permutation(n))]
    np.testing.assert_array_equal(sums[0], sums[1])
    np.testing.assert_array_equal(sums[0], sums[2])
    k = int(dvalue_pass.dv_shift(bound, n))
    for c in range(d):
        exact = math.fsum(float(t) for t in terms[:, c])
        tol = abs(float(np.spacing(np.float32(exact)))) + n * 2.0 ** -k
        assert abs(float(sums[0][c]) - exact) <= tol


@pytest.mark.parametrize("bound", [np.inf, np.nan])
def test_fixed_point_sum_with_a_bound_that_is_not_finite(bound):
    """A g or a factor that is not finite (a step that diverged): every element
    of a row with an entry is NaN, a row without one 0, in any order."""
    terms = np.asarray([[1.0, 2.0], [3.0, -1.0], [5.0, 0.0]], np.float32)
    rows = np.asarray([2, 0, 2])
    for order in (np.arange(3), np.arange(3)[::-1]):
        got = dvalue_pass.fixed_point_sums(terms[order], rows[order], 4, np.float32(bound))
        assert np.isnan(got[[0, 2]]).all() and (got[[1, 3]] == 0).all()
