"""How K3 (``csrc/ms_deform_attn_sep_fwd.cu``) and K3-bwd
(``csrc/ms_deform_attn_sep_bwd.cu``) split the separable decoder sampler,
emulated in plain torch on the CPU and held against
``richsem_tpu/ops/ms_deform_attn_sep_pallas.py`` in Pallas interpret mode (as
``tests/test_torch_msda_sep.py`` runs it) and against the port's plain version.

The emulation follows the kernels. A half-warp serves one (b, q, m) row and
takes its taps 16 at a time; a warp serves two rows, so when the rows are odd
in number the last warp's spare half-warp reads the last row again, with every
tap zeroed and nothing written. The lane that loads a tap computes its geometry
once: the pixel (``loc * size`` then ``- 0.5``), the token of the first corner
clamped into the level and the steps to the others, ``hxw_i = cdt(hat(x, i) *
aw)``, ``hat(y, j)`` and, for the backward, ``hat(x, i)``, ``dhat(x, i)`` and
``dhat(y, j)``, each 0 for a corner or tap out of range; every corner is then
read from its clamped address.

* K3: four lanes of eight channels serve a tap, so lane group g (of 4) of the
  row takes taps 4 r + g in rounds r = 0 .. 3 of a chunk. Per channel,
  ``r_j = hxw_x0 * V[j, x0] + hxw_x1 * V[j, x1]`` and ``rh_j = cdt(r_j *
  hat(y, j))`` with every product and sum rounded on its own, added in f32 in
  order; the groups meet in the shuffle tree (xor 4, then xor 8).
* K3-bwd: eight lanes of four channels serve a tap, so group g (of 2) takes
  taps 2 r + g in rounds r = 0 .. 7. Each lane sums ``g r_j dhat(y, j)``,
  ``d_r_j V[j, x0]`` and ``d_r_j V[j, x1]`` (``d_r_j = cdt(g hat(y, j))``) over
  its channels, rows first; the 8 lanes meet in three shuffle steps (xor 1, 2,
  4); d_value takes ``hxw_i d_r_j`` of every corner in the deterministic
  pass of ``tests/msda_dvalue_pass.py`` (the taps listed by their top-left
  corner in a shuffled order, each element's terms summed in fixed point and
  rounded once).

Tolerances: f32 to 5e-5 of the largest magnitude (``chip_smoke.py`` phase
8's); bf16 within one bf16 step (2^-7 relative), where an f32 sum taken in
another order rounds to the other side of a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import msda_dvalue_pass as dvalue_pass
from richsem_tpu.ops.ms_deform_attn_sep_pallas import ms_deform_attn_sep_pallas
from richsem_tpu_torch.ops import ms_deform_attn_sep as port

torch.set_num_threads(2)

SHAPES = ((12, 10), (6, 5))
S = sum(h * w for h, w in SHAPES)
B, M, D, Q = 2, 2, 32, 37
L = len(SHAPES)
F32_TOL = 5e-5


def _inputs(seed, p, b=B, m=M):
    rng = np.random.default_rng(seed)
    val = rng.normal(size=(b, S, m, D)).astype(np.float32)
    loc = rng.uniform(-0.15, 1.15, (b, Q, m, L, p, 2)).astype(np.float32)
    a = rng.uniform(0.1, 1.0, (b, Q, m, L, p)).astype(np.float32)
    aw = (a / a.sum(axis=(-2, -1), keepdims=True)).astype(np.float32)
    g = rng.normal(size=(b, Q, m * D)).astype(np.float32)
    return val, loc, aw, g


def _special_loc(seed, p):
    """Integer pixels (|c - i| = 0), ties one pixel from a tap (|c - i| = 1),
    taps in (-1, 0) and (w - 1, w), and taps outside the level."""
    rng = np.random.default_rng(seed)
    loc = np.empty((B, Q, M, L, p, 2), np.float32)
    for lvl, (h, w) in enumerate(SHAPES):
        for axis, size in ((0, w), (1, h)):
            pix = rng.integers(-2, size + 2, (B, Q, M, p)).astype(np.float32)
            frac = rng.choice([0.0, 0.0, 0.25, 0.5], size=pix.shape).astype(np.float32)
            loc[:, :, :, lvl, :, axis] = (pix + frac + 0.5) / size
    return loc


def _case(case, p):
    if case.startswith("odd"):  # B1, Q 37, M 1 or 3: 37 or 111 rows
        return _inputs(60 + p, p, b=1, m=int(case[-1]))
    val, loc, aw, g = _inputs(30 + p, p)
    if case == "special":
        loc = _special_loc(40 + p, p)
    return val, loc, aw, g


def _hat(c, i):
    return torch.clamp(1.0 - (c - i).abs(), min=0.0)


def _dhat(c, i):
    diff = c - i
    return torch.where(diff.abs() < 1.0, -torch.sign(diff), torch.zeros_like(diff))


def _cdt(t, bf16):
    return t.to(torch.bfloat16).float() if bf16 else t


def _geometry(locr, awr, live, t, p, bf16):
    """The loading lane's work for tap t of every half-warp's row (f32 [rows]
    each); a spare half-warp's (``live`` false) taps are zero."""
    lvl = t // p
    h, w = SHAPES[lvl]
    start = sum(hh * ww for hh, ww in SHAPES[:lvl])
    x = locr[:, t, 0] * w - 0.5  # two roundings, as msda_common.cuh:pixel
    y = locr[:, t, 1] * h - 0.5
    ok = live & (x > -1) & (x < w) & (y > -1) & (y < h)
    x, y = torch.where(ok, x, 0.0), torch.where(ok, y, 0.0)
    a = awr[:, t]
    x0, y0 = torch.floor(x), torch.floor(y)
    x0in, x1in = ok & (x0 >= 0), ok & (x0 + 1 < w)
    y0in, y1in = ok & (y0 >= 0), ok & (y0 + 1 < h)
    zero = torch.zeros_like(x)
    hx = [torch.where(x0in, _hat(x, x0), zero), torch.where(x1in, _hat(x, x0 + 1), zero)]
    dx = [torch.where(x0in, _dhat(x, x0), zero), torch.where(x1in, _dhat(x, x0 + 1), zero)]
    hy = [torch.where(y0in, _hat(y, y0), zero), torch.where(y1in, _hat(y, y0 + 1), zero)]
    dy = [torch.where(y0in, _dhat(y, y0), zero), torch.where(y1in, _dhat(y, y0 + 1), zero)]
    hxw = [_cdt(hx[0] * a, bf16), _cdt(hx[1] * a, bf16)]
    cx, cy = x0.long().clamp(min=0), y0.long().clamp(min=0)
    tok = torch.where(ok, start + cy * w + cx, torch.zeros_like(cx))
    sx = (x0in & x1in).long()
    sy = torch.where(y0in & y1in, w, 0)
    corners = [tok, tok + sx, tok + sy, tok + sy + sx]  # (x0 + (e & 1), y0 + (e >> 1))
    return dict(h=h, w=w, a=a, hx=hx, dx=dx, hy=hy, dy=dy, hxw=hxw, corners=corners)


def _rows(val, loc, aw, p):
    """The half-warps' rows: B*Q*M rows, then a spare one when they are odd in
    number, which reads the last row's addresses (``live`` false)."""
    val, loc, aw = (torch.from_numpy(np.asarray(v, np.float32)) for v in (val, loc, aw))
    b, q, m = loc.shape[:3]
    rows = b * q * m
    lp = L * p
    half_warps = rows + rows % 2
    row = torch.arange(half_warps).clamp(max=rows - 1)
    live = torch.arange(half_warps) < rows
    bi, mi = row // (q * m), row % m
    flat = val.reshape(b * S * m, D)  # rows (b, token, m)

    def gather(tok):  # [half-warps] tokens -> [half-warps, D] value rows
        return flat[(bi * S + tok) * m + mi]

    return (loc.reshape(rows, lp, 2)[row], aw.reshape(rows, lp)[row], live, gather, rows, lp,
            flat, bi, mi)


def _k3_emulated(val, loc, aw, p, bf16):
    """K3's split -> [B, Q, M * D] in f32 (bf16: rounded once)."""
    locr, awr, live, gather, rows, lp, _, _, _ = _rows(val, loc, aw, p)
    groups = 4  # lane groups a row, eight channels a lane
    acc = torch.zeros(live.numel(), groups, D)
    for t0 in range(0, lp, 16):
        for rnd in range(4):  # a group's taps of the chunk, in order
            for grp in range(groups):
                t = t0 + rnd * groups + grp
                if t >= lp:
                    continue  # zero factors: adds 0
                geo = _geometry(locr, awr, live, t, p, bf16)
                v = [gather(c) for c in geo["corners"]]
                w0, w1 = (f[:, None] for f in geo["hxw"])
                for j in range(2):
                    r = w0 * v[2 * j] + w1 * v[2 * j + 1]  # each product rounded, then the sum
                    acc[:, grp] += _cdt(r * geo["hy"][j][:, None], bf16)
    while acc.shape[1] > 1:  # the shuffle tree: xor 4, then xor 8
        acc = acc[:, 0::2] + acc[:, 1::2]
    return _cdt(acc[:rows, 0], bf16).reshape(*loc.shape[:2], -1)  # the live rows


def _k3_bwd_emulated(val, loc, aw, g, p, bf16):
    """K3-bwd's split -> (d_value, d_loc, d_aw) in f32 (d_value rounded once)."""
    locr, awr, live, gather, rows, lp, _, _, _ = _rows(val, loc, aw, p)
    n = live.numel()
    # lane k: channels 4k .. 4k + 3; the spare half-warp loads the last row's g
    gr = _cdt(torch.from_numpy(g).reshape(rows, 8, 4)[torch.arange(n).clamp(max=rows - 1)], bf16)
    d_aw = torch.zeros(n, lp)
    d_loc = torch.zeros(n, lp, 2)
    for t in range(lp):  # each tap's sums are its own, whatever the rounds' order
        geo = _geometry(locr, awr, live, t, p, bf16)
        v = [gather(c).reshape(n, 8, 4) for c in geo["corners"]]
        w0, w1 = (f[:, None] for f in geo["hxw"])
        s_y, s_h0, s_h1 = (torch.zeros(n, 8) for _ in range(3))
        for j in range(2):
            hy, dy = geo["hy"][j][:, None], geo["dy"][j][:, None]
            for c in range(4):  # a lane's channels in order
                v0, v1 = v[2 * j][:, :, c], v[2 * j + 1][:, :, c]
                rj = w0 * v0 + w1 * v1
                s_y = s_y + (gr[:, :, c] * rj) * dy
                d_r = _cdt(gr[:, :, c] * hy, bf16)
                s_h0 = s_h0 + d_r * v0
                s_h1 = s_h1 + d_r * v1

        def lanes(s):  # group_sum: xor 1, 2, 4
            s = s[:, 0::2] + s[:, 1::2]
            s = s[:, 0::2] + s[:, 1::2]
            return s[:, 0] + s[:, 1]

        s_y, s_h0, s_h1 = lanes(s_y), lanes(s_h0), lanes(s_h1)
        hx, dx = geo["hx"], geo["dx"]
        d_aw[:, t] = s_h0 * hx[0] + s_h1 * hx[1]
        d_loc[:, t, 0] = (s_h0 * dx[0] + s_h1 * dx[1]) * geo["a"] * geo["w"]
        d_loc[:, t, 1] = s_y * geo["h"]
    g_cdt = _cdt(torch.from_numpy(np.asarray(g, np.float32)), bf16).numpy()
    d_value = dvalue_pass.d_value(
        loc, aw, g_cdt, SHAPES, np.shape(val), kernel="k3", bf16=bf16,
        order=np.random.default_rng(0).permutation(np.asarray(aw).size))
    # the spare half-warp writes no d_loc or d_aw
    return torch.from_numpy(d_value), d_loc[:rows].reshape(loc.shape), d_aw[:rows].reshape(aw.shape)


def _bf16_input(val, dtype):
    return torch.from_numpy(val).to(torch.bfloat16).float().numpy() if dtype == "bf16" else val


def _jax_fwd(val, loc, aw, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return np.asarray(ms_deform_attn_sep_pallas(
        jnp.asarray(val, jdt), SHAPES, jnp.asarray(loc), jnp.asarray(aw)).astype(jnp.float32))


def _jax_vjp(val, loc, aw, g, dtype):
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    _, vjp = jax.vjp(lambda v_, l_, a_: ms_deform_attn_sep_pallas(v_, SHAPES, l_, a_),
                     jnp.asarray(val, jdt), jnp.asarray(loc), jnp.asarray(aw))
    return [np.asarray(t.astype(jnp.float32)) for t in vjp(jnp.asarray(g, jdt))]


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _close(got, want, dtype, name=""):
    got = np.asarray(got, np.float32)
    scale = float(np.abs(want).max())
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL * scale, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5 * scale, err_msg=name)


CASES = [("random", 8), ("special", 8), ("ragged", 3), ("ragged", 5), ("ragged", 10),
         ("odd-m1", 8), ("odd-m3", 8)]
CASE_IDS = ["random", "special", "ragged-p3", "ragged-p5", "ragged-p10", "odd-rows37",
            "odd-rows111"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,p", CASES, ids=CASE_IDS)
def test_k3_split_matches_sep_pallas_and_plain(case, p, dtype):
    """The emulated K3 against the TPU kernel in interpret mode and the port's
    plain dense version: random points, the special points, ragged tap chunks
    (L * P = 6 and 10 taps a row, less than a 16-tap chunk; 20, one chunk and
    a partial one), and odd row counts (37 and 111), where a spare half-warp
    runs."""
    val, loc, aw, _ = _case(case, p)
    val = _bf16_input(val, dtype)
    out = _k3_emulated(val, loc, aw, p, dtype == "bf16").numpy()
    _close(out, _jax_fwd(val, loc, aw, dtype), dtype, "vs sep_pallas")
    plain = port.ms_deform_attn_sep_plain(torch.from_numpy(val).to(_tdt(dtype)), SHAPES,
                                          torch.from_numpy(loc), torch.from_numpy(aw))
    _close(out, plain.float().numpy(), dtype, "vs plain")
    if dtype == "bf16":  # one rounding of the same bf16 terms: nearly all equal
        assert np.mean(out == plain.float().numpy()) > 0.99


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,p", CASES, ids=CASE_IDS)
def test_k3_bwd_split_matches_sep_pallas_vjp_and_plain(case, p, dtype):
    """The emulated K3-bwd against JAX's VJP of the TPU kernel in interpret
    mode and the port's explicit plain backward, same cases."""
    val, loc, aw, g = _case(case, p)
    val = _bf16_input(val, dtype)
    g = _bf16_input(g, dtype)
    got = _k3_bwd_emulated(val, loc, aw, g, p, dtype == "bf16")
    want = _jax_vjp(val, loc, aw, g, dtype)
    plain = port.ms_deform_attn_sep_backward_plain(
        torch.from_numpy(val).to(_tdt(dtype)), SHAPES, torch.from_numpy(loc),
        torch.from_numpy(aw), torch.from_numpy(g).to(_tdt(dtype)))
    for name, a, w_, pl_ in zip(("d_value", "d_loc", "d_aw"), got, want, plain):
        _close(a.numpy(), w_, dtype, f"{name} vs sep_pallas")
        _close(a.numpy(), pl_.float().numpy(), dtype, f"{name} vs plain")


def test_k3_bwd_out_of_range_corners_add_nothing_to_d_loc():
    """Taps in (-1, 0) and (w - 1, w): dhat is nonzero one pixel outside the
    level, where the TPU kernel's dense basis has no row. The emulation reads
    those corners from clamped addresses with every factor zeroed, and its
    d_loc equals the VJP's there (f32)."""
    p = 4
    val, _, aw, g = _inputs(50, p)
    loc = np.empty((B, Q, M, L, p, 2), np.float32)
    rng = np.random.default_rng(51)
    for lvl, (h, w) in enumerate(SHAPES):
        for axis, size in ((0, w), (1, h)):
            edge = rng.choice([-0.5, -0.25, size - 0.75, size - 0.5], size=(B, Q, M, p))
            loc[:, :, :, lvl, :, axis] = (edge + 0.5) / size
    got = _k3_bwd_emulated(val, loc, aw, g, p, False)
    want = _jax_vjp(val, loc, aw, g, "f32")
    assert np.abs(want[1]).max() > 0  # the in-range corners do move the taps
    for name, a, w_ in zip(("d_value", "d_loc", "d_aw"), got, want):
        _close(a.numpy(), w_, "f32", name)


class _OnCard(torch.Tensor):
    """A meta tensor that reports a CUDA device: it reaches the wrappers'
    kernel path without a card, and no kernel can run on it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_k3_head_dim_other_than_32_raises_before_launching(monkeypatch, entry):
    """K3 and K3-bwd take a head dim of 32 only (ROADMAP F-P5): a CUDA call
    with another raises before any kernel is built or launched; one with 32
    goes on to the launch."""

    def no_launch(*args):
        raise AssertionError("kernel launch reached")

    monkeypatch.setattr(port, "_sep_cuda", no_launch)
    monkeypatch.setattr(port, "_sep_bwd_cuda", no_launch)
    for d, raises in ((16, pytest.raises(ValueError, match="K3 and K3-bwd take a head dim of 32")),
                      (32, pytest.raises(AssertionError, match="kernel launch reached"))):
        val = torch.empty(B, S, M, d, device="meta").as_subclass(_OnCard)
        loc = torch.empty(B, Q, M, L, 4, 2, device="meta").as_subclass(_OnCard)
        aw = torch.empty(B, Q, M, L, 4, device="meta").as_subclass(_OnCard)
        assert val.device.type == "cuda"
        with raises:
            if entry == "forward":
                port.ms_deform_attn_sep(val, SHAPES, loc, aw)
            else:
                port.ms_deform_attn_sep_backward(val, SHAPES, loc, aw,
                                                 torch.empty(B, Q, M * d, device="meta"))
    assert port.ms_deform_attn_sep.launches == 0
    assert port.ms_deform_attn_sep_backward.launches == 0
