"""A plain emulation, in numpy, of the deterministic d_value pass that K1-bwd
(``csrc/ms_deform_attn_bwd.cu``) and K3-bwd (``csrc/ms_deform_attn_sep_bwd.cu``)
share (``csrc/msda_dvalue.cuh``), for the CPU tests.

A tap whose corners touch its level is keyed by its top-left corner on the
level's extended grid of (h + 1) x (w + 1) positions; the keys are counted,
scanned into segments and each tap's id placed in its key's segment, here in
any order the caller gives (the kernel's integer atomics fix none). Value row
(y, x) takes corner e of the taps keyed at (y - (e >> 1) + 1, x - (e & 1) + 1),
and each element sums its terms in fixed point: the call's bound max|g| times
the largest factor bound (``factor_bound``) and the count of the row's terms
give the shift ``dv_shift``; every
term times 2^k is rounded to an integer, the int64 sum is exact, and it is
rounded once to float32. Where the bound is not finite (a g or a factor is
not), every element of a row with an entry is NaN. (The kernels keep no
list of the taps: each term's integer goes into its row by a 64-bit atomic
add, in whatever order the card runs them, for which the placement order
here stands; the integers, and so the sums, are the same.)

JAX-free: the tests hold it against the JAX package's VJPs themselves.
"""

import numpy as np

F32 = np.float32


def pixel(loc, size):
    """``loc * size - 0.5``, each operation rounded to float32 (msda_common.cuh:pixel)."""
    return (np.asarray(loc, F32) * F32(size)).astype(F32) - F32(0.5)


def ext_starts(shapes):
    """-> (the extended grids' starts by level, their total S_ext)."""
    sizes = [(h + 1) * (w + 1) for h, w in shapes]
    return np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64), int(sum(sizes))


def tap_keys(loc, shapes):
    """Each tap's key in tap order ((b, q, m, l, p) row-major), -1 where no
    corner touches the level. -> (keys, n_keys)."""
    loc = np.asarray(loc, F32)
    b, q, m, n_lvl, p, _ = loc.shape
    starts, total = ext_starts(shapes)
    keys = np.full((b, q, m, n_lvl, p), -1, np.int64)
    bi = np.arange(b)[:, None, None, None]
    mi = np.arange(m)[None, None, :, None]
    for lvl, (h, w) in enumerate(shapes):
        x, y = pixel(loc[:, :, :, lvl, :, 0], w), pixel(loc[:, :, :, lvl, :, 1], h)
        inside = (x > -1) & (x < w) & (y > -1) & (y < h)
        x0, y0 = np.floor(np.where(inside, x, 0)), np.floor(np.where(inside, y, 0))
        pos = starts[lvl] + (y0.astype(np.int64) + 1) * (w + 1) + x0.astype(np.int64) + 1
        keys[:, :, :, lvl] = np.where(inside, (bi * total + pos) * m + mi, -1)
    return keys.reshape(-1), b * total * m


def place(keys, n_keys, order):
    """Counts, their exclusive scan and the list of tap ids, each tap placed in
    its key's segment in the order ``order`` (a permutation of the taps) visits
    them. -> (offsets [n_keys + 1], list)."""
    counts = np.bincount(keys[keys >= 0], minlength=n_keys)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    order = np.asarray(order)
    order = order[keys[order] >= 0]
    # each key's cursor hands out its slots in the order the taps come
    lst = order[np.argsort(keys[order], kind="stable")]
    return offsets, lst


def dv_shift(mx, n):
    """msda_dvalue.cuh:dv_shift, elementwise: the shift k for which n terms of
    magnitude below twice the bound ``mx`` sum below 2^63 in any order after
    rounding (n * 2^e * 2^k <= 2^61 for mx < 2^e). Refuses a bound that is not
    finite and positive, or no term: the pass gives those elements 0, NaN or
    an infinity instead."""
    mx, n = np.asarray(mx, F32), np.asarray(n, np.int64)
    if not (np.isfinite(mx).all() and (mx > 0).all() and (n >= 1).all()):
        raise ValueError(f"no fixed-point shift for largest terms {mx} of {n} terms")
    _, e = np.frexp(mx)  # mx < 2^e
    _, c = np.frexp((n - 1).astype(np.float64))  # n <= 2^c: c = (n - 1).bit_length()
    return (61 - c - e).astype(np.int32)


def fixed_point_sums(terms, rows, n_rows, bound):
    """Each row's sum of its terms (float32 [entries, D], the row of each entry
    in ``rows``), channel by channel, as the gather sums them, with the shift
    of the call's ``bound`` (float32) and the row's count; NaN in every
    element of a row with an entry where the bound is not finite. ->
    [n_rows, D]."""
    terms = np.asarray(terms, F32)
    d = terms.shape[1]
    out = np.zeros((n_rows, d), F32)
    if not len(rows):
        return out
    order = np.argsort(rows, kind="stable")
    rows, terms = rows[order], terms[order]
    first = np.flatnonzero(np.r_[True, rows[1:] != rows[:-1]])
    if not np.isfinite(bound):
        out[rows[first]] = np.nan
        return out
    if bound == 0:
        return out
    n = np.diff(np.r_[first, len(rows)])
    k = dv_shift(np.full(len(n), bound, F32), n)[:, None]
    k_e = np.repeat(k, n, axis=0)
    scaled = np.rint(np.ldexp(terms.astype(np.float64), k_e))
    acc = np.add.reduceat(scaled.astype(np.int64), first, axis=0)
    out[rows[first]] = np.ldexp(acc.astype(F32), -k).astype(F32)
    return out


def gather(offsets, lst, shapes, b, m, terms_of, bound):
    """The gather: each value row (b, s, m) its entries, corner e of the taps of
    the four keys that reach it, summed by ``fixed_point_sums`` with the
    call's ``bound``. ``terms_of(taps, e, lvl)`` gives the entries' float32
    terms [n, D]. -> d_value [b, S, m, D] f32."""
    starts, total = ext_starts(shapes)
    s_all = sum(h * w for h, w in shapes)
    all_rows, all_terms = [], []
    tok0 = 0
    for lvl, (h, w) in enumerate(shapes):
        bb, yy, xx, mm = np.meshgrid(np.arange(b), np.arange(h), np.arange(w), np.arange(m),
                                     indexing="ij")
        row = ((bb * s_all + tok0 + yy * w + xx) * m + mm).reshape(-1)
        for e in range(4):
            pos = starts[lvl] + (yy - (e >> 1) + 1) * (w + 1) + xx - (e & 1) + 1
            key = ((bb * total + pos) * m + mm).reshape(-1)
            lo, cnt = offsets[key], offsets[key + 1] - offsets[key]
            if not cnt.sum():
                continue
            rows = np.repeat(row, cnt)
            idx = np.repeat(lo - np.r_[0, np.cumsum(cnt)[:-1]], cnt) + np.arange(cnt.sum())
            all_rows.append(rows)
            all_terms.append(terms_of(lst[idx], e, lvl))
        tok0 += h * w
    if not all_rows:
        return np.zeros((b, s_all, m, 0), F32)
    d = all_terms[0].shape[1]
    sums = fixed_point_sums(np.concatenate(all_terms), np.concatenate(all_rows), b * s_all * m,
                            bound)
    return sums.reshape(b, s_all, m, d)


def k1_terms(loc, aw, g, shapes):
    """K1-bwd's terms: ``(w_e * a) * g`` of the tap's row (GatherTerm in
    ms_deform_attn_bwd.cu), float32 [n, D]."""
    loc, aw, g = (np.asarray(x, F32) for x in (loc, aw, g))
    b, q, m, n_lvl, p, _ = loc.shape
    lp = n_lvl * p
    locf, awf = loc.reshape(-1, 2), aw.reshape(-1)
    gr = g.reshape(b * q * m, -1)

    def terms_of(taps, e, lvl):
        h, w = shapes[lvl]
        x, y = pixel(locf[taps, 0], w), pixel(locf[taps, 1], h)
        dx, dy = x - np.floor(x), y - np.floor(y)
        one = F32(1)
        fx = dx if e & 1 else one - dx
        fy = dy if e >> 1 else one - dy
        wa = ((fy * fx).astype(F32) * awf[taps]).astype(F32)
        return (gr[taps // lp] * wa[:, None]).astype(F32)

    return terms_of


def k3_terms(loc, aw, g, shapes, bf16):
    """K3-bwd's terms: ``hxw_i * cdt(g * hy_j)`` for corner e = (i, j) =
    (e & 1, e >> 1), hxw_i = cdt(hat(x, x0 + i) * aw) (GatherTerm in
    ms_deform_attn_sep_bwd.cu), float32 [n, D]; ``g`` already in the value's
    dtype."""
    import torch

    loc, aw, g = (np.asarray(x, F32) for x in (loc, aw, g))
    b, q, m, n_lvl, p, _ = loc.shape
    lp = n_lvl * p
    locf, awf = loc.reshape(-1, 2), aw.reshape(-1)
    gr = g.reshape(b * q * m, -1)

    def cdt(x):
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy() if bf16 else x

    def hat(c, i):
        return np.maximum(F32(0), F32(1) - np.abs((c - i).astype(F32))).astype(F32)

    def terms_of(taps, e, lvl):
        h, w = shapes[lvl]
        x, y = pixel(locf[taps, 0], w), pixel(locf[taps, 1], h)
        hxw = cdt((hat(x, np.floor(x) + (e & 1)) * awf[taps]).astype(F32))
        hy = hat(y, np.floor(y) + (e >> 1))
        d_r = cdt((gr[taps // lp] * hy[:, None]).astype(F32))
        return (hxw[:, None] * d_r).astype(F32)

    return terms_of


def factor_bound(loc, aw, shapes, keys, kernel="k1", bf16=False):
    """The largest of the keyed taps' factor bounds (Term::bound in the
    kernels): K1 max_e |w_e a|, K3 max_i |hxw_i| * max_j |hy_j|; float32."""
    import torch

    loc, aw = np.asarray(loc, F32), np.asarray(aw, F32)
    n_lvl, p = loc.shape[3], loc.shape[4]
    lvl = (np.arange(keys.size) // p) % n_lvl
    locf, awf = loc.reshape(-1, 2), aw.reshape(-1)
    out = F32(0)
    for lv_, (h, w) in enumerate(shapes):
        taps = np.flatnonzero((keys >= 0) & (lvl == lv_))
        x, y = pixel(locf[taps, 0], w), pixel(locf[taps, 1], h)
        dx, dy = x - np.floor(x), y - np.floor(y)
        a = awf[taps]
        if kernel == "k1":
            one = F32(1)
            fs = [((fy * fx).astype(F32) * a).astype(F32)
                  for fy in (one - dy, dy) for fx in (one - dx, dx)]
            b = np.max(np.abs(np.stack(fs)), axis=0, initial=F32(0))
        else:
            def hat(c, i):
                return np.maximum(F32(0), F32(1) - np.abs((c - i).astype(F32))).astype(F32)
            x0, y0 = np.floor(x), np.floor(y)
            hxw = [(hat(x, x0 + i) * a).astype(F32) for i in (0, 1)]
            if bf16:
                hxw = [torch.from_numpy(v).to(torch.bfloat16).float().numpy() for v in hxw]
            xin = [x0 >= 0, x0 + 1 < w]
            yin = [y0 >= 0, y0 + 1 < h]
            hx_m = np.maximum(np.where(xin[0], np.abs(hxw[0]), 0), np.where(xin[1], np.abs(hxw[1]), 0))
            hy_m = np.maximum(np.where(yin[0], hat(y, y0), 0), np.where(yin[1], hat(y, y0 + 1), 0))
            b = (hx_m.astype(F32) * hy_m.astype(F32)).astype(F32)
        out = max(out, F32(np.max(b, initial=F32(0))))
    return out


def d_value(loc, aw, g, shapes, value_shape, kernel="k1", bf16=False, order=None):
    """The pass end to end: keys, placement in ``order`` (tap order when None),
    gather. -> d_value [B, S, M, D] in float32 (rounded to bf16 once where
    ``bf16``)."""
    import torch

    b, s, m, d = value_shape
    keys, n_keys = tap_keys(loc, shapes)
    offsets, lst = place(keys, n_keys, np.arange(len(keys)) if order is None else order)
    terms = (k1_terms(loc, aw, g, shapes) if kernel == "k1"
             else k3_terms(loc, aw, g, shapes, bf16))
    g = np.asarray(g, F32)
    if kernel == "k1":  # K1-bwd takes max|g| over the rows (b, q, m) with a keyed tap
        lp = loc.shape[3] * loc.shape[4]
        g = g.reshape(b * loc.shape[1] * m, -1)[(keys.reshape(-1, lp) >= 0).any(1)]
    bound = (np.abs(g).max(initial=F32(0))
             * factor_bound(loc, aw, shapes, keys, kernel, bf16))  # the call's, f32
    out = gather(offsets, lst, shapes, b, m, terms, bound)
    if out.shape[-1] == 0:
        out = np.zeros((b, s, m, d), F32)
    if bf16:
        out = torch.from_numpy(out).to(torch.bfloat16).float().numpy()
    return out
