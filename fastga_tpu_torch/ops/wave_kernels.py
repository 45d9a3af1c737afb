"""The three wave kernels of the paired wave program, each beside its plain
PyTorch version.

Port of fastga_tpu/ops/wave_pallas.py (build_chunk_pallas in MEGA mode,
build_wave0_pallas, build_backtrack_walk).  The plain versions reproduce the
JAX package's XLA/host twins bit for bit:

- ``chunk_plain``  = ops/wave.py build_forward_chunk, run for G waves, with
  the batch-wide recenter gating of the XLA stepper;
- ``wave0_plain``  = ops/wave.py host_wave0 (plus the ``valid`` row mask of
  the Pallas initializer);
- ``walk_plain``   = the lax.scan path walk of WaveEngine._backtrack_fn.

Each wrapper (``wave_chunk``, ``wave0``, ``backtrack_walk``) runs the plain
version for CPU tensors and launches its CUDA kernel (csrc/*.cu, built with
nvcc for sm_90a at first use) for CUDA tensors; there is no fallback between
the two.  ``LAUNCHES`` (ops/cuda_build.py) counts kernel launches.

State layout (the JAX state tuple, 18 entries): V, Thi, Tlo, M int32 [N, W]
(Thi/Tlo carry uint32 bit patterns), then kbase, low, hgh, besta, bestx,
lasta, trima, trimx, trimd, trim_wave, trim_slot int32 [N], alive and
fallback bool [N], dif int32 [N].  Torch's CPU build has no uint32 shifts or
compares, so the plain versions widen the bit patterns to int64 masked to 32
bits; the kernels read them as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_build import (LAUNCHES, build_kernels, check as _check,
                         ptr as _ptr, raise_on as _raise_on,
                         stream as _stream)
from .wave_ref import PATH_LEN, TRIM_MASK, TRIM_MLAG, WAVE_LAG

CH_DIAG, CH_LOW, CH_HIGH, CH_NONE = 0, 1, 2, 3
NSC = 16          # packed scalar columns handed to the kernels
M32 = 0xFFFFFFFF
BIG = 1 << 30

# -- int32 / uint32 helpers for the plain versions ---------------------------

def _w32(t):
    """Wrap int64 values to the int32 range (XLA int32 wraparound)."""
    return ((t + (1 << 31)) & M32) - (1 << 31)


def _u32(t):
    """int32 bit pattern -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & M32


def _i32(t):
    """int64 in [0, 2^32) (or any int64) -> int32 bit pattern."""
    return _w32(t.to(torch.int64)).to(torch.int32)


def _popcount32(v):
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _ctz2(x):
    """#matching leading bases = trailing-zero bits / 2 (16 if equal)."""
    low = x & (-x)
    tz = _popcount32((low - 1) & M32)
    return torch.where(x == 0, 16, tz >> 1)


def _rev2(v):
    """Reverse 2-bit groups within uint32 (int64 carrier)."""
    v = ((v >> 2) & 0x33333333) | ((v & 0x33333333) << 2)
    v = ((v >> 4) & 0x0F0F0F0F) | ((v & 0x0F0F0F0F) << 4)
    v = ((v >> 8) & 0x00FF00FF) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & M32


def _fetch64(pool64, woff, start):
    """Four funnel-shifted 16-base words at base ``start`` of the sequence
    at word offset ``woff``; word reads clamp to [0, P-1] like the host
    mirror (wave.py _np_fetch64)."""
    w = start >> 4
    sh = (start & 15) << 1
    P = pool64.numel()
    ws = [pool64[torch.clamp(woff + w + k, 0, P - 1)] for k in range(5)]
    shl = torch.where(sh > 0, 32 - sh, 0)
    out = []
    for k in range(4):
        hi = torch.where(sh > 0, (ws[k + 1] << shl) & M32, 0)
        out.append((ws[k] >> sh) | hi)
    return out


def _snake_run(pool64, fwd, x, y, aw, alen, bw, blen):
    """One 64-base snake step: the matching run length at (x, y)."""
    if fwd:
        va = torch.clamp(alen - x, 0, 64)
        vb = torch.clamp(blen - y, 0, 64)
        was = _fetch64(pool64, aw, x)
        wbs = _fetch64(pool64, bw, y)
    else:
        va = torch.clamp(x, 0, 64)
        vb = torch.clamp(y, 0, 64)
        was = [_rev2(w) for w in _fetch64(pool64, aw, x - 64)][::-1]
        wbs = [_rev2(w) for w in _fetch64(pool64, bw, y - 64)][::-1]
    mm = [_ctz2(a ^ b) for a, b in zip(was, wbs)]
    run = mm[0]
    full = mm[0] == 16
    for kk in (1, 2, 3):
        run = torch.where(full, 16 * kk + mm[kk], run)
        full = full & (mm[kk] == 16)
    return torch.minimum(torch.minimum(run, va), vb)


def _shift_window(thi, tlo, m, run):
    """Apply a run of matches to the 60-bit window (four <=16 sub-shifts:
    the reference checks bit 60 before each shift, align.c:698-701)."""
    for kk in range(4):
        r = torch.clamp(run - 16 * kk, 0, 16)
        pos = r > 0
        ones = (torch.ones_like(r) << r) - 1
        ob = torch.where(pos, (thi >> (29 - r)) & ones, 0)
        m = m + r - _popcount32(ob)
        nthi = torch.where(pos, ((thi << r) | (tlo >> (32 - r))) & M32, thi)
        tlo = torch.where(pos, ((tlo << r) | ones) & M32, tlo)
        thi = nthi
    return thi, tlo, m


def _snake(pool64, fwd, x, k, aw, alen, bw, blen, act, thi=None, tlo=None,
           m=None):
    """Match extension over the active lanes only (the lane set shrinks
    every 64-base round); identical results to the full-grid device loop.
    With ``thi``/``tlo``/``m`` the match window is carried along."""
    x = x.clone()
    bits = thi is not None
    if bits:
        thi, tlo, m = thi.clone(), tlo.clone(), m.clone()
    idx = torch.nonzero(act.reshape(-1)).reshape(-1)
    W = x.shape[1]
    xf = x.reshape(-1)
    if bits:
        thf, tlf, mf = thi.reshape(-1), tlo.reshape(-1), m.reshape(-1)
    row = idx // W
    xs, ks = xf[idx], k.reshape(-1)[idx]
    a_w, a_l, b_w, b_l = aw[row], alen[row], bw[row], blen[row]
    if bits:
        ths, tls, ms = thf[idx], tlf[idx], mf[idx]
    while idx.numel():
        run = _snake_run(pool64, fwd, xs, _w32(xs - ks), a_w, a_l, b_w, b_l)
        if bits:
            ths, tls, ms = _shift_window(ths, tls, ms, run)
            thf[idx], tlf[idx], mf[idx] = ths, tls, ms
        xs = xs + run if fwd else xs - run
        xf[idx] = xs
        keep = run == 64
        if not bool(keep.all()):
            idx, xs, ks = idx[keep], xs[keep], ks[keep]
            a_w, a_l, b_w, b_l = a_w[keep], a_l[keep], b_w[keep], b_l[keep]
            if bits:
                ths, tls, ms = ths[keep], tls[keep], ms[keep]
    return (x, thi, tlo, m) if bits else x


def _sentinels(fwd, x, k, alen, blen, act):
    y = _w32(x - k)
    if fwd:
        b_sent = (y < 0) | (y >= blen)
        a_sent = ~b_sent & ((x < 0) | (x >= alen))
    else:
        b_sent = (y - 1 < 0) | (y - 1 >= blen)
        a_sent = ~b_sent & ((x - 1 < 0) | (x - 1 >= alen))
    return b_sent & act, a_sent & act


def _first_index(mask):
    """Index of the first True per row (0 when none), like argmax."""
    W = mask.shape[1]
    wix = torch.arange(W, device=mask.device)[None, :]
    return torch.where(mask, wix, W).min(dim=1).values.clamp(max=W - 1)


def _arg_extreme(v, fwd):
    """First index of the row max (fwd) / min (rev): jnp.argmax/argmin."""
    ext = v.max(dim=1).values if fwd else v.min(dim=1).values
    return _first_index(v == ext[:, None])


def _best_block(fwd, BAR, c, in_band, besta):
    """Running-max improver semantics (descending-k in the reference):
    returns (improver mask, row extreme cbest)."""
    N = c.shape[0]
    cm = torch.where(in_band, c, BAR)
    bar = torch.full((N, 1), BAR, dtype=c.dtype, device=c.device)
    if fwd:
        rc = torch.flip(torch.cummax(torch.flip(cm, [1]), 1).values, [1])
        excl = torch.cat([rc[:, 1:], bar], 1)
        improver = in_band & (c > torch.maximum(besta[:, None], excl))
        cbest = rc[:, 0]
    else:
        rc = torch.cummin(cm, 1).values
        excl = torch.cat([bar, rc[:, :-1]], 1)
        improver = in_band & (c < torch.minimum(besta[:, None], excl))
        cbest = rc[:, -1]
    return improver, cbest


def _clip_block(fwd, wix, a_sent, b_sent, low, hgh, besta, bestx, alen,
                blen):
    """Sentinel clipping (align.c:757-782 / mirrored): (more, low, hgh)."""
    hit = (a_sent | b_sent).any(dim=1)
    by = besta - bestx
    if fwd:
        b_in = (by >= 0) & (by < blen)
        a_in = (bestx >= 0) & (bestx < alen)
    else:
        b_in = (by - 1 >= 0) & (by - 1 < blen)
        a_in = (bestx - 1 >= 0) & (bestx - 1 < alen)
    more = ~hit | (b_in & a_in)
    if fwd:
        aclip = torch.where(a_sent, wix, BIG).min(dim=1).values
        bclip = torch.where(b_sent, wix, -BIG).max(dim=1).values
        hgh = torch.where(hit & (hgh >= aclip), aclip - 1, hgh)
        low = torch.where(hit & (low <= bclip), bclip + 1, low)
    else:
        aclip = torch.where(a_sent, wix, -BIG).max(dim=1).values
        bclip = torch.where(b_sent, wix, BIG).min(dim=1).values
        low = torch.where(hit & (low <= aclip), aclip + 1, low)
        hgh = torch.where(hit & (hgh >= bclip), bclip - 1, hgh)
    return more, low, hgh


# -- plain versions -----------------------------------------------------------

def _widen_state(st):
    V, Thi, Tlo, M = st[:4]
    sc = [s.to(torch.int64) for s in st[4:15]]
    return ([V.to(torch.int64), _u32(Thi), _u32(Tlo), M.to(torch.int64)]
            + sc + [st[15].bool(), st[16].bool(), st[17].to(torch.int64)])


def _narrow_state(st):
    V, Thi, Tlo, M = st[:4]
    return ((V.to(torch.int32), _i32(Thi), _i32(Tlo), M.to(torch.int32))
            + tuple(s.to(torch.int32) for s in st[4:15])
            + (st[15].clone(), st[16].clone(), st[17].to(torch.int32)))


def _one_wave(pool64, tg, st, tbl, scr, PA, fwd, W):
    """One wave of build_forward_chunk's one_wave (ops/wave.py:210-429) on
    widened tensors; returns (state, choice row, band row)."""
    (V, Thi, Tlo, M, kbase, low, hgh, besta, bestx, lasta, trima, trimx,
     trimd, trim_wave, trim_slot, alive, fallback, dif) = st
    aw, alen, bw, blen, minp, maxp = tg
    dev = V.device
    N = V.shape[0]
    BAR = -1 if fwd else 0x7FFFFFFF
    wix = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    live = alive[:, None]

    low2 = torch.where(alive & (kbase + low - 1 >= minp), low - 1, low)
    hgh2 = torch.where(alive & (kbase + hgh + 1 <= maxp), hgh + 1, hgh)
    dif2 = torch.where(alive, dif + 1, dif)
    is_new = (((wix == low2[:, None]) & (low2 != low)[:, None])
              | ((wix == hgh2[:, None]) & (hgh2 != hgh)[:, None]))
    V1 = torch.where(is_new & live, BAR, V)
    in_band = (wix >= low2[:, None]) & (wix <= hgh2[:, None]) & live
    Vr = torch.where(in_band, V1, BAR)

    bar = torch.full((N, 1), BAR, dtype=torch.int64, device=dev)
    am = torch.cat([bar, Vr[:, :-1]], 1)
    ac = Vr
    ap = torch.cat([Vr[:, 1:], bar], 1)
    if fwd:
        take_p = ((ac < am) & (am < ap)) | (~(ac < am) & (ac < ap))
        take_m = (ac < am) & ~(am < ap)
        c_pre = torch.where(take_p, ap + 1, torch.where(take_m, am + 1,
                                                        ac + 2))
    else:
        take_m = ((ac > ap) & (ap > am)) | (~(ac > ap) & (ac > am))
        take_p = (ac > ap) & ~(ap > am)
        c_pre = torch.where(take_m, am - 1, torch.where(take_p, ap - 1,
                                                        ac - 2))
    c_pre = _w32(c_pre)
    choice = torch.where(take_p, CH_HIGH, torch.where(take_m, CH_LOW,
                                                      CH_DIAG))
    choice = torch.where(in_band, choice, CH_NONE).to(torch.uint8)

    def pick(A):
        Am = torch.cat([A[:, :1], A[:, :-1]], 1)
        Ap = torch.cat([A[:, 1:], A[:, -1:]], 1)
        return torch.where(take_p, Ap, torch.where(take_m, Am, A))

    thi, tlo, m = pick(Thi), pick(Tlo), pick(M)
    m = m - ((thi >> 28) & 1)
    thi = ((thi << 1) | (tlo >> 31)) & M32
    tlo = (tlo << 1) & M32

    k = _w32(kbase[:, None] + wix)
    x = _w32(c_pre + k) >> 1
    x, thi, tlo, m = _snake(pool64, fwd, x, k, aw, alen, bw, blen, in_band,
                            thi, tlo, m)
    b_sent, a_sent = _sentinels(fwd, x, k, alen[:, None], blen[:, None],
                                in_band)
    c = _w32((x << 1) - k)

    improver, cbest = _best_block(fwd, BAR, c, in_band, besta)
    better = alive & ((cbest > besta) if fwd else (cbest < besta))
    imp_c = torch.where(improver, c, BAR)
    rows = torch.arange(N, device=dev)
    bslot = _arg_extreme(imp_c, fwd)
    besta2 = torch.where(better, cbest, besta)
    bestx2 = torch.where(better, x[rows, bslot], bestx)

    el = improver & (m >= PA)
    el_c = torch.where(el, c, BAR)
    l_val = el_c.max(dim=1).values if fwd else el_c.min(dim=1).values
    l_upd = alive & el.any(dim=1) & ((l_val > besta) if fwd
                                     else (l_val < besta))
    lasta2 = torch.where(l_upd, l_val, lasta)

    b15 = tlo & TRIM_MASK
    b30 = ((tlo >> 15) | (thi << 17)) & TRIM_MASK
    tok = (tbl[b15] >= 0) & (tbl[b30] + scr[b15] >= 0)
    et = el & tok
    et_c = torch.where(et, c, BAR)
    t_val = et_c.max(dim=1).values if fwd else et_c.min(dim=1).values
    t_slot = _arg_extreme(et_c, fwd)
    t_upd = alive & et.any(dim=1) & ((t_val > besta) if fwd
                                     else (t_val < besta))
    trima2 = torch.where(t_upd, t_val, trima)
    trimx2 = torch.where(t_upd, x[rows, t_slot], trimx)
    trimd2 = torch.where(t_upd, dif2, trimd)
    trim_wave2 = torch.where(t_upd, dif2, trim_wave)
    trim_slot2 = torch.where(t_upd, kbase + t_slot, trim_slot)

    V2 = torch.where(in_band, c, V1)
    Thi2 = torch.where(in_band, thi, Thi)
    Tlo2 = torch.where(in_band, tlo, Tlo)
    M2 = torch.where(in_band, m, M)

    more, low3, hgh3 = _clip_block(fwd, wix, a_sent, b_sent, low2, hgh2,
                                   besta2, bestx2, alen, blen)

    if fwd:
        ok = in_band & (V2 >= _w32(besta2 - WAVE_LAG)[:, None])
    else:
        ok = in_band & (V2 <= _w32(besta2 + WAVE_LAG)[:, None])
    ok = ok & (wix >= low3[:, None]) & (wix <= hgh3[:, None])
    anyok = ok.any(dim=1)
    hgh4 = torch.where(ok, wix, -BIG).max(dim=1).values
    low4 = torch.where(ok, wix, BIG).min(dim=1).values
    empty = alive & ~anyok
    hgh4 = torch.where(anyok, hgh4, low3 - 1)
    low4 = torch.where(anyok, low4, low3)

    if fwd:
        going = more & (lasta2 >= _w32(besta2 - TRIM_MLAG))
    else:
        going = more & (lasta2 <= _w32(besta2 + TRIM_MLAG))
    width = hgh4 - low4 + 1
    over = alive & going & (width > W - 4)
    fallback2 = fallback | over | (alive & going & empty)
    alive2 = alive & going & ~over & ~empty

    # batch-wide gated recenter (the XLA stepper's lax.cond)
    kbase2 = kbase
    if bool((alive2 & ((low4 <= 2) | (hgh4 >= W - 3))).any()):
        shift = torch.where(alive2, ((low4 + hgh4) >> 1) - W // 2, 0)
        src = wix + shift[:, None]
        srcc = torch.clamp(src, 0, W - 1)
        inside = (src >= 0) & (src < W)

        def regather(A, fill):
            return torch.where(inside, torch.gather(A, 1, srcc), fill)

        V2, Thi2, Tlo2, M2 = (regather(V2, BAR), regather(Thi2, 0),
                              regather(Tlo2, 0), regather(M2, 0))
        kbase2, low4, hgh4 = kbase + shift, low4 - shift, hgh4 - shift

    st2 = [V2, Thi2, Tlo2, M2, kbase2, low4, hgh4, besta2, bestx2, lasta2,
           trima2, trimx2, trimd2, trim_wave2, trim_slot2, alive2,
           fallback2, dif2]
    band = torch.stack([low2, hgh2, kbase, dif2], 1)
    return st2, choice, band


def chunk_plain(pool, targs, st, spec, direction, G):
    """G waves of the XLA chunk stepper.  ``pool`` int32 [P] (uint32 bit
    patterns), ``targs`` 6 int32 [N] (aw, alen, bw, blen, minp, maxp).
    Returns (state, choice log uint8 [G, N, W], band log int32 [G, N, 4]
    with columns low, hgh, kbase, dif)."""
    fwd = direction > 0
    W = st[0].shape[1]
    dev = st[0].device
    pool64 = _u32(pool)
    tg = [t.to(torch.int64) for t in targs]
    tbl = torch.as_tensor(np.asarray(spec.table, np.int64), device=dev)
    scr = torch.as_tensor(np.asarray(spec.score, np.int64), device=dev)
    s = _widen_state(st)
    chs, bands = [], []
    for _ in range(G):
        s, ch, band = _one_wave(pool64, tg, s, tbl, scr, spec.ave_path, fwd,
                                W)
        chs.append(ch)
        bands.append(band)
    N = st[0].shape[0]
    ch = (torch.stack(chs) if chs
          else torch.zeros((0, N, W), dtype=torch.uint8, device=dev))
    band = (torch.stack(bands).to(torch.int32) if bands
            else torch.zeros((0, N, 4), dtype=torch.int32, device=dev))
    return _narrow_state(s), ch, band


def wave0_plain(pool, targs, dgmin, dgmax, anti, valid, W, direction):
    """host_wave0 (ops/wave.py:607) in torch; rows with valid == 0 come
    out dead with an empty band (build_wave0_pallas semantics)."""
    fwd = direction > 0
    dev = pool.device
    BAR = -1 if fwd else 0x7FFFFFFF
    pool64 = _u32(pool)
    aw, alen, bw, blen, minp, maxp = [t.to(torch.int64) for t in targs]
    dgmin, dgmax, anti = (t.to(torch.int64) for t in (dgmin, dgmax, anti))
    valid = valid.bool()
    N = aw.shape[0]
    wix = torch.arange(W, device=dev, dtype=torch.int64)[None, :]

    kbase = dgmin + ((dgmax - dgmin) >> 1) - W // 2
    low = dgmin - kbase
    hgh = dgmax - kbase
    k = _w32(kbase[:, None] + wix)
    in_band = (wix >= low[:, None]) & (wix <= hgh[:, None]) & valid[:, None]
    x = _w32(anti[:, None] + k) >> 1
    x = _snake(pool64, fwd, x, k, aw, alen, bw, blen, in_band)
    b_sent, a_sent = _sentinels(fwd, x, k, alen[:, None], blen[:, None],
                                in_band)
    c = _w32((x << 1) - k)

    besta0 = anti
    bestx0 = _w32(anti + kbase + hgh) >> 1
    improver, cbest = _best_block(fwd, BAR, c, in_band, besta0)
    better = (cbest > besta0) if fwd else (cbest < besta0)
    bslot = _arg_extreme(torch.where(improver, c, BAR), fwd)
    rows = torch.arange(N, device=dev)
    besta = torch.where(better, cbest, besta0)
    bestx = torch.where(better, x[rows, bslot], bestx0)
    trim_slot = torch.where(better, kbase + bslot, kbase + hgh)
    more, low2, hgh2 = _clip_block(fwd, wix, a_sent, b_sent, low, hgh,
                                   besta, bestx, alen, blen)
    z = torch.zeros(N, dtype=torch.int64, device=dev)
    V = torch.where(in_band, c, BAR)
    Thi = torch.where(in_band, (1 << 28) - 1, 0)
    Tlo = torch.where(in_band, M32, 0)
    M = torch.where(in_band, PATH_LEN, 0)
    st = [V, Thi, Tlo, M, kbase, low2, hgh2, besta, bestx, besta, besta,
          bestx, z, z, trim_slot, more & valid,
          torch.zeros(N, dtype=torch.bool, device=dev), z]
    return _narrow_state(st)


def walk_plain(ch, kb, trim_diag, trim_wave):
    """Path walk of WaveEngine._backtrack_fn (ops/wave.py:1008-1029):
    from (trim_diag, trim_wave), follow the choice log down to wave 0.
    Returns (d0 [N], D [G, N]) with D[w] = path diagonal at wave w+1."""
    G, N, W = ch.shape
    dev = ch.device
    rows = torch.arange(N, device=dev)
    diag = trim_diag.to(torch.int64).clone()
    tw = trim_wave.to(torch.int64)
    kb64 = kb.to(torch.int64)
    D = torch.empty((G, N), dtype=torch.int32, device=dev)
    for w in range(G - 1, -1, -1):
        D[w] = diag.to(torch.int32)
        active = (w + 1) <= tw
        slot = torch.clamp(diag - kb64[w], 0, W - 1)
        cc = ch[w, rows, slot]
        diag = torch.where(active & (cc == CH_LOW), diag - 1,
                           torch.where(active & (cc == CH_HIGH), diag + 1,
                                       diag))
    return diag.to(torch.int32), D


# -- canonical form -----------------------------------------------------------

_SC_NAMES = ("besta", "bestx", "lasta", "trima", "trimx", "trimd",
             "trim_wave", "trim_slot", "alive", "fallback", "dif")


def canon_state(state, logs=None, W=None):
    """Slot-space independent form of a state (and its logs), for holding
    states that were recentered differently against each other.

    Per tube: V/Thi/Tlo/M over the in-band slots [low, hgh] shifted to
    start at 0 (zero elsewhere); kbase+low and kbase+hgh as diagonals
    (``lowd``/``hghd``); every other scalar column as is.  ``logs`` =
    (choice [G, N, W], kbase [G, N]): each row is shifted so its first
    in-band slot lands at 0 (``ch``), with that slot's diagonal in
    ``chd``; rows beyond a tube's last live wave (dif) are zeroed.
    Returns a dict of numpy arrays."""
    st = [t.detach().cpu() for t in state]
    W = W if W is not None else st[0].shape[1]
    kbase, low, hgh = (st[4].to(torch.int64), st[5].to(torch.int64),
                       st[6].to(torch.int64))
    N = kbase.shape[0]
    wix = torch.arange(W)[None, :]
    src = wix + low[:, None]
    inside = (src <= hgh[:, None]) & (src >= 0) & (src < W)
    srcc = src.clamp(0, W - 1)
    out = {}
    for name, A in zip(("V", "Thi", "Tlo", "M"), st[:4]):
        out[name] = torch.where(inside, torch.gather(A, 1, srcc),
                                torch.zeros_like(A)).numpy()
    out["lowd"] = (kbase + low).numpy()
    out["hghd"] = (kbase + hgh).numpy()
    for name, v in zip(_SC_NAMES, st[7:]):
        out[name] = v.numpy()
    if logs is not None:
        ch, kb = (t.detach().cpu() for t in logs)
        G = ch.shape[0]
        live = (torch.arange(G)[:, None]
                < st[17].to(torch.int64)[None, :])   # [G, N]
        first = torch.where(ch != CH_NONE, wix[None], W).min(2).values
        src = (first.clamp(max=W - 1)[:, :, None] + wix[None])
        row = torch.where(src < W, torch.gather(
            ch, 2, src.clamp(max=W - 1)), torch.full_like(ch, CH_NONE))
        out["ch"] = torch.where(live[:, :, None], row,
                                torch.zeros_like(row)).numpy()
        out["chd"] = torch.where(live, kb.to(torch.int64) + first,
                                 torch.zeros_like(first)).numpy()
    return out


# -- kernel launch (build and helpers: ops/cuda_build.py) ---------------------

def pack_scalars(st):
    """State scalar columns -> int32 [N, 16] (the kernels' layout)."""
    cols = list(st[4:15]) + [st[15].to(torch.int32), st[16].to(torch.int32),
                             st[17]]
    z = torch.zeros_like(st[4])
    return torch.stack([c.to(torch.int32) for c in cols] + [z, z],
                       1).contiguous()


def unpack_scalars(sc):
    return (tuple(sc[:, j] for j in range(11))
            + (sc[:, 11] > 0, sc[:, 12] > 0, sc[:, 13]))


def wave_chunk(pool, targs, st, spec, direction, G, logs=None):
    """Up to G waves from state ``st`` (MEGA semantics: a tube stops at its
    last live wave).  Returns (state, choice log uint8 [G, N, W], kbase log
    int32 [G, N]).  Log rows beyond a tube's last live wave are unwritten
    on CUDA; the walk masks them by trim_wave.  ``logs``: optional
    preallocated (choice, kbase) buffers of at least G rows (CUDA)."""
    if pool.device.type == "cpu":
        st2, ch, band = chunk_plain(pool, targs, st, spec, direction, G)
        return st2, ch, band[:, :, 2].contiguous()
    N, W = st[0].shape
    if W > 2048 or W % 32:
        raise ValueError(f"wave_chunk: W={W} must be a multiple of 32 "
                         f"and at most 2048")
    tg = torch.stack([t.to(torch.int32) for t in targs]).contiguous()
    sc = pack_scalars(st)
    _check(pool, torch.int32, (pool.numel(),), "pool")
    for t, nm in zip(st[:4], ("V", "Thi", "Tlo", "M")):
        _check(t, torch.int32, (N, W), nm)
    if logs is None:
        ch = torch.empty((G, N, W), dtype=torch.uint8, device=pool.device)
        kb = torch.empty((G, N), dtype=torch.int32, device=pool.device)
    else:
        ch, kb = logs[0][:G], logs[1][:G]
        _check(ch, torch.uint8, (G, N, W), "choice log")
        _check(kb, torch.int32, (G, N), "kbase log")
    if ch.data_ptr() % 16:
        raise ValueError("wave_chunk: the choice log must be 16-byte "
                         "aligned (the kernel stores 16-byte words)")
    out = [torch.empty_like(st[j]) for j in range(4)]
    sco = torch.empty_like(sc)
    lib = build_kernels()["wave_chunk"]
    rc = lib.wave_chunk_launch(
        _ptr(pool), pool.numel(), _ptr(tg),
        *[_ptr(t) for t in st[:4]], _ptr(sc),
        *[_ptr(t) for t in out], _ptr(sco), _ptr(ch), _ptr(kb),
        N, W, G, int(direction > 0), int(spec.ave_path), int(spec.mscore),
        int(spec.dscore), _stream())
    _raise_on(rc, "wave_chunk")
    LAUNCHES["wave_chunk"] += 1
    return tuple(out) + unpack_scalars(sco), ch, kb


def wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction):
    """Wave-0 state of each tube (host_wave0 semantics)."""
    if pool.device.type == "cpu":
        return wave0_plain(pool, targs, dgmin, dgmax, anti, valid, W,
                           direction)
    N = targs[0].shape[0]
    if W > 2048 or W % 32:
        raise ValueError(f"wave0: W={W} must be a multiple of 32 and at "
                         f"most 2048")
    # aw, alen, bw, blen, dgmin, dgmax, anti, valid (minp/maxp: not read)
    cols = [t.to(torch.int32) for t in
            list(targs[:4]) + [dgmin, dgmax, anti, valid]]
    for t, nm in zip(cols, ("aw", "alen", "bw", "blen", "dgmin", "dgmax",
                            "anti", "valid")):
        _check(t, torch.int32, (N,), nm)
    _check(pool, torch.int32, (pool.numel(),), "pool")
    out = torch.empty((4, N, W), dtype=torch.int32, device=pool.device)
    sco = torch.empty((N, NSC), dtype=torch.int32, device=pool.device)
    lib = build_kernels()["wave0"]
    rc = lib.wave0_launch(_ptr(pool), pool.numel(), *[_ptr(t) for t in cols],
                          _ptr(out), _ptr(sco), N, W, int(direction > 0),
                          _stream())
    _raise_on(rc, "wave0")
    LAUNCHES["wave0"] += 1
    return tuple(out) + unpack_scalars(sco)


def backtrack_walk(ch, kb, trim_diag, trim_wave):
    """(d0 [N], D [G, N]) path diagonals from the choice/kbase logs."""
    if ch.device.type == "cpu":
        return walk_plain(ch, kb, trim_diag, trim_wave)
    G, N, W = ch.shape
    _check(ch, torch.uint8, (G, N, W), "choice log")
    _check(kb, torch.int32, (G, N), "kbase log")
    td = trim_diag.to(torch.int32).contiguous()
    tw = trim_wave.to(torch.int32).contiguous()
    _check(td, torch.int32, (N,), "trim_diag")
    _check(tw, torch.int32, (N,), "trim_wave")
    d0 = torch.empty(N, dtype=torch.int32, device=ch.device)
    D = torch.empty((G, N), dtype=torch.int32, device=ch.device)
    lib = build_kernels()["backtrack_walk"]
    rc = lib.backtrack_walk_launch(_ptr(ch), _ptr(kb), _ptr(td), _ptr(tw),
                                   _ptr(d0), _ptr(D), G, N, W, _stream())
    _raise_on(rc, "backtrack_walk")
    LAUNCHES["backtrack_walk"] += 1
    return d0, D
