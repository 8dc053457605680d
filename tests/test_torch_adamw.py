"""The optimizer's kernels K5 and K6 (``richsem_tpu_torch/ops/adamw.py``,
``csrc/adamw.cu``) and the two AdamW orders of ``train/optim.py``.

* The port's ``fused`` order, on its plain path, against the JAX package's
  ``fused_adamw`` on the tiny DINO's tree: three steps of seeded gradients for
  every leaf (the FrozenBN buffers in the norm), the first two where the 0.1
  clip binds, the last below it; the parameters to float32 rounding and the
  norm (float64 here, an f32 sum in JAX) to 1e-6.
* Two steps of the tiny DINO train step with ``fused_adamw=True`` against
  JAX's ``make_train_step`` under the same config.
* K5's and K6's splits emulated in numpy: the leaves cut into chunks of
  ``CHUNK`` (a block each), the tables cut into launches (at the kernels' own
  sizes and at a small stand-in), each block's leaf found by the kernels'
  binary search, each element covered once; K5's float64 sums in the
  kernel's order (a thread's elements in order, the shuffle tree, the warps
  in order, the partials in index order) against the plain version; K6's
  per-element roundings in both orders bit for bit against the plain version.
* The wrappers' refusals, reached on a meta tensor that reports a CUDA device
  before any launch; on CPU tensors the plain versions run and nothing is
  launched.
* A checkpoint written under one order restores under the other bit for bit.
"""

import ctypes
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import richsem_tpu.train.optim as jax_optim
import richsem_tpu_torch.models.build  # noqa: F401  (registers "richsem")
from richsem_tpu.config import Config as JaxConfig
from richsem_tpu.models.dino import DINO as JaxDINO
from richsem_tpu.models.dino import DINOConfig as JaxDINOConfig
from richsem_tpu.train.engine import create_train_state as jax_create_state
from richsem_tpu.train.engine import make_train_step as jax_make_train_step
from richsem_tpu_torch.config import Config
from richsem_tpu_torch.models import build_model
from richsem_tpu_torch.ops import adamw
from richsem_tpu_torch.ops.adamw import CHUNK, plan, total_chunks
from richsem_tpu_torch.train.engine import create_train_state, make_train_step
from richsem_tpu_torch.train.optim import AdamW, build_optimizer, frozen_leaves
from richsem_tpu_torch.utils.checkpoint import CheckpointManager, state_to_dict
from richsem_tpu_torch.utils.convert import params_from_jax
from tests.test_torch_checkpoint import _batch, _same
from tests.test_torch_checkpoint import _cfg as _ckpt_cfg
from tests.test_torch_train_step import (CONFIG, TINY, _batches, _freeze_every_frozen_bn,
                                         _jax_draws, _np_params)
from tests.test_torch_main import _drop_checkpoints  # noqa: F401  (autouse: ~400 MB a checkpoint)

torch.set_num_threads(2)

THREADS = 512  # csrc/adamw.cu kThreads
PARAM_LIMIT = 32764  # bytes of kernel parameters sm_70 and newer take since CUDA 12.1
B1, B2, EPS, WD, MAX_NORM = 0.9, 0.999, 1e-8, 1e-4, 0.1
TRAIN_STEPS = 2


@pytest.fixture(scope="module")
def fused_setup():
    """The tiny DINO of test_torch_train_step.py with ``fused_adamw=True`` on both
    sides, one set of numpy weights, and JAX's freeze rule as that file fixes it."""
    knobs = dict(TINY, fused_adamw=True)
    jcfg = JaxConfig.fromfile(CONFIG)
    jcfg.update(knobs)
    cfg = Config.fromfile(CONFIG)
    cfg.update(knobs)
    jax_model = JaxDINO(JaxDINOConfig.from_config(jcfg))
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64), bool))
    params = jax.tree.map(jnp.asarray, _np_params(shapes, np.random.default_rng(0)))
    orig = jax_optim.lr_scale_tree
    jax_optim.lr_scale_tree = _freeze_every_frozen_bn(orig)
    try:
        tx = jax_optim.build_optimizer(params, jcfg, steps_per_epoch=2)
    finally:
        jax_optim.lr_scale_tree = orig
    return dict(jcfg=jcfg, cfg=cfg, jax_model=jax_model, params=params, tx=tx)


def _port_model(s):
    model, _, _ = build_model("richsem", s["cfg"], device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, s["params"]),
                                          expected=model.state_dict()))
    return model


def test_fused_order_matches_jax_fused_adamw(fused_setup):
    """The port's fused order against ``fused_adamw`` on the same gradients:
    parameters to float32 rounding, the pre-clip norm to 1e-6."""
    s = fused_setup
    params, tx = s["params"], s["tx"]
    model = _port_model(s)
    opt = build_optimizer(model, s["cfg"], steps_per_epoch=2)
    assert opt.order == "fused"
    leaves = dict(model.named_parameters())
    leaves.update(frozen_leaves(model))
    opt_state = tx.init(params)
    assert isinstance(opt_state, jax_optim.FusedAdamWState)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(5)
    for scale in (1.0, 0.3, 1e-6):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * scale,
                                                   jnp.float32), params)
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        g = params_from_jax(jax.tree.map(np.asarray, grads), expected=model.state_dict())
        opt.zero_grad()
        for name, t in leaves.items():
            t.grad = g[name].clone()
        gnorm = opt.step()
        np.testing.assert_allclose(float(gnorm), float(opt_state.gnorm), rtol=1e-6)
        assert (float(opt_state.gnorm) > MAX_NORM) == (scale > 1e-3)
    ref = params_from_jax(jax.tree.map(np.asarray, params), expected=model.state_dict())
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_dino_train_step_with_fused_adamw_tracks_jax(fused_setup):
    """Two steps of the tiny DINO with ``fused_adamw=True`` against JAX's
    ``make_train_step`` under the same config, with test_torch_train_step.py's
    tolerances: the first step's metrics to 1e-5 (the norm to 1e-4), the
    second's to 5e-2 (the clip binds, so Adam's first steps give the sign of
    entries below the convolutions' rounding noise at random), and no
    parameter or EMA entry further apart than two full steps of its group's
    lr a step, with 80% of the entries within a tenth of one."""
    s = fused_setup
    cfg = s["cfg"]
    state = jax_create_state(jax.tree.map(jnp.copy, s["params"]), s["tx"], use_ema=True)
    jax_step = jax_make_train_step(s["jax_model"], s["jcfg"], s["tx"])
    model = _port_model(s)
    port_state = create_train_state(model, build_optimizer(model, cfg, steps_per_epoch=2),
                                    use_ema=True)
    assert port_state.optimizer.order == "fused"
    port_step = make_train_step(model, cfg, device="cpu")
    rng = jax.random.PRNGKey(11)
    for i, batch in enumerate(_batches()[:TRAIN_STEPS]):
        state, ref = jax_step(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        t = {k: torch.from_numpy(v) for k, v in batch.items()}
        t["labels"] = t["labels"].long()
        out = port_step(port_state, t, draws=_jax_draws(cfg, rng, i))
        assert set(out) == set(ref)
        assert float(ref["grad_norm"]) > 10 * MAX_NORM
        for k in ref:
            rtol = (1e-4 if k == "grad_norm" else 1e-5) if i == 0 else 5e-2
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=rtol,
                                       atol=1e-6, err_msg=f"{k} @ {i}")
    ref_p = params_from_jax(jax.tree.map(np.asarray, state.params), expected=model.state_dict())
    ref_e = params_from_jax(jax.tree.map(np.asarray, state.ema_params),
                            expected=model.state_dict())
    opt = port_state.optimizer
    close = total = 0
    for name, p in model.state_dict().items():
        lr = TINY["lr"] * opt.scales.get(name, 0.0)
        d = (p - ref_p[name]).abs()
        assert float(d.max()) <= 2 * TRAIN_STEPS * lr * 1.001 + 1e-7, name
        close += int((d <= 0.1 * lr + 1e-7).sum())
        total += d.numel()
        if name in port_state.ema:
            de = (port_state.ema[name] - ref_e[name]).abs()
            assert float(de.max()) <= 2 * TRAIN_STEPS * lr * 1.001 + 1e-7, name
    assert close >= 0.8 * total, close / total


# ------------------------------------------------------------- the kernels' splits

# ragged leaves: one element, exactly one chunk, a chunk and one, past the
# flagship's largest (4,718,592), a median one, and a few chunks less five
SIZES = (1, CHUNK, CHUNK + 1, 4_718_593, 1024, 3 * CHUNK - 5, 7)
NULL = 4  # the leaf whose gradient is None


def _find_leaf(first, n, chunk):
    """csrc/adamw.cu:find_leaf, the largest i < n with first[i] <= chunk."""
    lo, hi = 0, n - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if first[mid] <= chunk:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _blocks(numels, max_leaves):
    """Every block of every launch: (global chunk, leaf, start, n)."""
    for launch in plan(numels, max_leaves):
        assert 0 < len(launch.leaves) <= max_leaves
        assert len(launch.first) == len(launch.leaves) + 1
        for c in range(launch.chunks):
            k = _find_leaf(launch.first, len(launch.leaves), c)
            assert launch.first[k] <= c < launch.first[k + 1]
            j = launch.leaves[k]
            start = (c - launch.first[k]) * CHUNK
            yield launch.chunk_base + c, j, start, min(CHUNK, numels[j] - start)


@pytest.mark.parametrize("max_leaves", [adamw.NORM_LEAVES, adamw.ADAMW_LEAVES, 2, 1])
def test_plan_covers_every_element_once(max_leaves):
    """Each element of each leaf lies in exactly one block; the chunks are
    numbered 0.. in order over the launches; an empty leaf takes none."""
    numels = list(SIZES[:NULL]) + [0] + list(SIZES[NULL + 1:])
    cover = [np.zeros(n, np.int64) for n in numels]
    chunks = []
    for c, j, start, n in _blocks(numels, max_leaves):
        assert 0 < n <= CHUNK and start % CHUNK == 0
        cover[j][start:start + n] += 1
        chunks.append(c)
    assert all((c == 1).all() for c in cover)
    want = sum(-(-n // CHUNK) for n in numels)
    assert chunks == list(range(want)) == list(range(total_chunks(plan(numels, max_leaves))))
    assert len(plan(numels, max_leaves)) == -(-(len(numels) - 1) // max_leaves)


def test_tables_fit_the_parameter_limit():
    """One launch's table and its other arguments fit the kernel parameter
    limit, and the flagship's 562 norm leaves and 338 trainable leaves each fit
    one table; the sizes ops/adamw.py packs are the C structs' (checked again
    against csrc/adamw.cu's own sizes when the library loads)."""
    norm, upd = ctypes.sizeof(adamw._NormTable), ctypes.sizeof(adamw._AdamwTable)
    assert norm + 8 <= PARAM_LIMIT
    assert upd + 2 * 8 + ctypes.sizeof(adamw._AdamwConsts) <= PARAM_LIMIT
    assert norm == adamw.NORM_LEAVES * 16 + 8 and upd == adamw.ADAMW_LEAVES * 44 + 8
    assert len(plan([1] * 562, adamw.NORM_LEAVES)) == len(plan([1] * 338, adamw.ADAMW_LEAVES)) == 1


def _leaves(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=n) * scale).astype(np.float32) for n in SIZES]


def _sumsq_block(x):
    """csrc/adamw.cu:sumsq_kernel on one chunk: the f32 squares, thread t's
    sum over elements t, t + THREADS, ... in order, the shuffle tree, the warp
    sums in warp order."""
    sq = np.zeros(CHUNK, np.float64)
    sq[:x.size] = (x * x).astype(np.float64)  # each square rounded in f32
    acc = np.zeros(THREADS)
    for row in sq.reshape(-1, THREADS):  # row k: elements k * THREADS + t
        acc = acc + row  # +0.0 past the chunk's end adds nothing
    lanes = acc.reshape(-1, 32)
    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync: a lane past 31 reads its own
        shifted = lanes.copy()
        shifted[:, :32 - off] = lanes[:, off:]
        lanes = lanes + shifted
    s = 0.0
    for w in lanes[:, 0]:
        s += w
    return s


def _k5(grads, max_leaves):
    numels = [0 if g is None else g.size for g in grads]
    partials = np.zeros(total_chunks(plan(numels, max_leaves)))
    for c, j, start, n in _blocks(numels, max_leaves):
        partials[c] = _sumsq_block(grads[j][start:start + n])
    return partials


def test_k5_split_sums_in_a_fixed_order():
    """The float64 partials of K5's blocks, summed in index order by the
    finish, equal numpy's sequential float64 sum in that order; a split
    table gives the same partials; the norm is the plain version's, to one f32
    step, and the sum within 1e-13 of the exact one. A None gradient adds
    nothing."""
    grads = _leaves(0)
    grads[NULL] = None
    partials = _k5(grads, adamw.NORM_LEAVES)
    assert np.array_equal(partials, _k5(grads, 2))
    total = 0.0
    for p in partials:  # sumsq_finish_kernel
        total += p
    assert total == np.cumsum(partials)[-1]
    exact = math.fsum(float(v) for g in grads if g is not None
                      for v in (g * g).astype(np.float64))
    assert abs(total - exact) <= 1e-13 * exact
    gnorm = np.float32(np.sqrt(total))
    plain, state = adamw.global_norm_clip(
        [None if g is None else torch.from_numpy(g) for g in grads], MAX_NORM)
    assert abs(gnorm - plain.numpy()) <= np.spacing(gnorm)
    assert float(state[1]) == np.float32(MAX_NORM) / plain.numpy()  # clip = max / gnorm
    assert state[0].item() == plain.item()


def _k6(params, grads, mu, nu, hyper, clip_state, scales, order, max_leaves):
    """csrc/adamw.cu:adamw_kernel in numpy float32, block by block."""
    f = np.float32
    lr, c1, c2 = hyper
    gnorm, clip = clip_state
    b1, omb1, b2, omb2 = f(B1), f(1.0 - B1), f(B2), f(1.0 - B2)
    eps, wd, max_norm = f(EPS), f(WD), f(MAX_NORM)
    cover = [np.zeros(p.size, np.int64) for p in params]
    for _, j, start, n in _blocks([p.size for p in params], max_leaves):
        sl = slice(start, start + n)
        cover[j][sl] += 1
        s = f(scales[j])
        g = np.zeros(n, f) if grads[j] is None else grads[j][sl]
        if order == "chain":
            if not gnorm < max_norm:
                g = (g / gnorm) * max_norm
        else:
            g = g * clip
        m = omb1 * g + b1 * mu[j][sl]
        v = omb2 * (g * g) + b2 * nu[j][sl]
        adam = (m / c1) / (np.sqrt(v / c2) + eps)
        p = params[j][sl]
        u = adam + wd * p
        if order == "chain":
            params[j][sl] = p - (u * s if s != f(1.0) else u) * lr
        else:
            params[j][sl] = p + (f(-s) * lr) * u
        mu[j][sl], nu[j][sl] = m, v
    assert all((c == 1).all() for c in cover)


@pytest.mark.parametrize("order", ["chain", "fused"])
@pytest.mark.parametrize("grad_scale", [1.0, 1e-6], ids=["clipped", "unclipped"])
def test_k6_split_matches_the_plain_version_bit_for_bit(order, grad_scale):
    """K6's blocks, at its own table size and split two leaves a launch, give
    the plain version's parameters and moments bit for bit, in both orders,
    where the clip binds and where it does not; a None gradient is a zero."""
    params, mu, nu = _leaves(1), [np.abs(x) * np.float32(1e-2) for x in _leaves(2)], \
        [np.abs(x) * np.float32(1e-5) for x in _leaves(3)]
    grads = _leaves(4, grad_scale)
    grads[NULL] = None
    scales = [1.0, 0.1, 1.0, 0.1, 1.0, 1.0, 0.1]
    hyper = np.asarray([2e-4, 1 - 0.9 ** 3, 1 - 0.999 ** 3], np.float32)
    tg = [None if g is None else torch.from_numpy(g) for g in grads]
    gnorm, clip_state = adamw.global_norm_clip(tg, MAX_NORM)
    assert (float(gnorm) < MAX_NORM) == (grad_scale < 1e-3)
    tp, tm, tv = ([torch.from_numpy(x.copy()) for x in xs] for xs in (params, mu, nu))
    adamw.adamw_update(tp, tg, tm, tv, torch.from_numpy(hyper), clip_state, scales, b1=B1,
                       b2=B2, eps=EPS, weight_decay=WD, max_norm=MAX_NORM, order=order)
    for max_leaves in (adamw.ADAMW_LEAVES, 2):
        ep, em, ev = ([x.copy() for x in xs] for xs in (params, mu, nu))
        _k6(ep, grads, em, ev, hyper, clip_state.numpy(), scales, order, max_leaves)
        for want, got in ((tp, ep), (tm, em), (tv, ev)):
            for a, b in zip(want, got):
                assert np.array_equal(a.numpy(), b), (order, max_leaves)
    assert not np.array_equal(tp[0].numpy(), params[0])


# ------------------------------------------------------------- the wrappers

class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrappers'
    kernel paths without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_card(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta").as_subclass(_OnCard)


def test_wrappers_refuse_before_launching(monkeypatch):
    """K5 and K6 take float32, contiguous tensors on one device, leaves of
    fewer than 2^31 elements, lists of one length, the leaves' shapes, hyper
    [3] and a clip state [2], and a known order: a CUDA call that breaks any of
    these raises before any build or launch; one that keeps them goes on to
    the launch."""

    def no_launch(*args, **kw):
        raise AssertionError("kernel launch reached")

    monkeypatch.setattr(adamw, "_norm_cuda", no_launch)
    monkeypatch.setattr(adamw, "_update_cuda", no_launch)
    before = (adamw.global_norm_clip.launches, adamw.adamw_update.launches)
    g = [_on_card(4, 3), None, _on_card(5)]
    with pytest.raises(TypeError, match="float32"):
        adamw.global_norm_clip([_on_card(4, dtype=torch.bfloat16)], MAX_NORM)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.global_norm_clip([_on_card(4, 3).t()], MAX_NORM)
    with pytest.raises(ValueError, match="one device"):
        adamw.global_norm_clip([_on_card(4), torch.zeros(4)], MAX_NORM)
    with pytest.raises(ValueError, match="int32"):
        adamw.global_norm_clip([_on_card(2**31)], MAX_NORM)
    with pytest.raises(AssertionError, match="kernel launch reached"):
        adamw.global_norm_clip(g, MAX_NORM)

    p = [_on_card(4, 3), _on_card(2), _on_card(5)]
    m, v = [_on_card(*t.shape) for t in p], [_on_card(*t.shape) for t in p]
    hyper, state = _on_card(3), _on_card(2)
    kw = dict(b1=B1, b2=B2, eps=EPS, weight_decay=WD, max_norm=MAX_NORM)
    with pytest.raises(ValueError, match="order"):
        adamw.adamw_update(p, g, m, v, hyper, state, [1.0] * 3, order="adam", **kw)
    with pytest.raises(ValueError, match="differ in length"):
        adamw.adamw_update(p, g[:2], m, v, hyper, state, [1.0] * 3, **kw)
    with pytest.raises(TypeError, match="float32"):
        adamw.adamw_update(p, g, m, v, _on_card(3, dtype=torch.float64), state, [1.0] * 3, **kw)
    with pytest.raises(ValueError, match=r"hyper \[3\]"):
        adamw.adamw_update(p, g, m, v, _on_card(4), state, [1.0] * 3, **kw)
    with pytest.raises(ValueError, match="its shape"):
        adamw.adamw_update(p, g, [_on_card(4, 3), _on_card(3), _on_card(5)], v, hyper, state,
                           [1.0] * 3, **kw)
    with pytest.raises(ValueError, match="its shape"):
        adamw.adamw_update(p, [_on_card(3, 4), None, None], m, v, hyper, state, [1.0] * 3, **kw)
    for order in adamw.ORDERS:
        with pytest.raises(AssertionError, match="kernel launch reached"):
            adamw.adamw_update(p, g, m, v, hyper, state, [1.0, 0.1, 1.0], order=order, **kw)
    assert (adamw.global_norm_clip.launches, adamw.adamw_update.launches) == before


def test_cpu_runs_the_plain_versions_and_launches_nothing():
    """On CPU tensors the wrappers are their plain versions and count no
    launch; with every gradient None the norm is 0 and the clip 1."""
    before = (adamw.global_norm_clip.launches, adamw.adamw_update.launches)
    gnorm, state = adamw.global_norm_clip([None, None], MAX_NORM, "cpu")
    assert float(gnorm) == 0.0 and state.tolist() == [0.0, 1.0]
    g = [torch.full((3,), 2.0), torch.full((4,), 1.0)]
    gnorm, state = adamw.global_norm_clip(g, MAX_NORM)
    assert float(gnorm) == 4.0 and float(state[1]) == np.float32(MAX_NORM) / np.float32(4.0)
    assert (adamw.global_norm_clip.launches, adamw.adamw_update.launches) == before
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        adamw.global_norm_clip([torch.empty(3, device="meta")], MAX_NORM)


@pytest.mark.parametrize("saved,restored", [("chain", "fused"), ("fused", "chain")])
def test_checkpoint_restores_across_orders(tmp_path, saved, restored):
    """Both orders keep the same state (``mu``, ``nu`` of the trainable
    leaves, ``count``): two train steps under one order, saved, restore into
    a fresh state under the other bit for bit, which then trains on."""
    def state_for(order, seed):
        cfg = _ckpt_cfg()
        cfg.fused_adamw = order == "fused"
        model, _, _ = build_model("richsem", cfg, device="cpu",
                                  generator=torch.Generator().manual_seed(seed))
        opt = build_optimizer(model, cfg, steps_per_epoch=4)
        assert isinstance(opt, AdamW) and opt.order == order
        return cfg, create_train_state(model, opt, use_ema=True)

    cfg, state = state_for(saved, 0)
    step = make_train_step(state.model, cfg, seed=0, device="cpu")
    for _ in range(2):
        step(state, _batch())
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state, epoch=0)
    cfg2, fresh = state_for(restored, 5)
    mgr.restore(fresh)
    assert fresh.optimizer.order == restored
    _same(state_to_dict(state), state_to_dict(fresh))
    m = make_train_step(fresh.model, cfg2, seed=0, device="cpu")(fresh, _batch())
    assert bool(m["finite"]) and fresh.optimizer.count == 3
