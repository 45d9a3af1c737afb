# Copied from fastga_tpu/ops/wave_replay.py; imports point at fastga_tpu_torch.
"""Host-side exact trace reconstruction from device wave results.

The device kernel (ops/wave.py) logs per-wave predecessor choices and
walks them back ON DEVICE (WaveEngine._backtrack_fn), shipping only the
per-wave path diagonal to the host.  Given a tube's diagonal sequence,
the final path is recovered by re-extending snakes forward on the host to
obtain the exact per-wave furthest-reach positions; trace points are the
grid crossings of that path (the reference's pebble chains,
align.c:805-870 forward / 1325-1414 reverse, reproduced without
device-side pebbles).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from .wave_ref import Path, _snake_fwd, _snake_rev


_I8P = ctypes.POINTER(ctypes.c_int8)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _i8view(A) -> np.ndarray:
    """Zero-copy int8 view of a uint8 code array (values 0..3)."""
    A = np.asarray(A)
    if A.dtype == np.uint8 and A.flags.c_contiguous:
        return A.view(np.int8)
    return np.ascontiguousarray(A, np.int8)


def _native_reach(A, B, anti: int, diags, trimx: int, direction: int):
    """Per-wave furthest-reach positions via the C snake loop (the hot
    part of replay); None -> pure-Python fallback."""
    from .. import native
    lib = native.get_tracerec()
    if lib is None:
        return None
    A8 = _i8view(A)
    B8 = _i8view(B)
    d32 = np.ascontiguousarray(np.asarray(diags, np.int32))
    ntw = len(d32) - 1
    xs = np.empty(ntw + 1, np.int64)
    rc = lib.trw_path_reach(
        A8.ctypes.data_as(_I8P), len(A8),
        B8.ctypes.data_as(_I8P), len(B8),
        int(anti),
        d32.ctypes.data_as(_I32P), ntw,
        int(trimx), direction,
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise AssertionError((int(xs[ntw]), trimx))
    return xs


class _TraceBuf:
    """Reusable int32 output buffer for the C replay calls."""
    __slots__ = ("arr",)

    def __init__(self):
        self.arr = np.empty(4096, np.int32)

    def fit(self, pairs: int) -> np.ndarray:
        if self.arr.shape[0] < 2 * pairs:
            self.arr = np.empty(
                max(2 * pairs, 2 * self.arr.shape[0]), np.int32)
        return self.arr


_tbuf = _TraceBuf()


def _native_replay_fwd(A, B, anti, aoff, diags, trima, trimx, trimd,
                       path, tspace):
    """One-call C replay (reach + crossings + assembly); returns the
    seam diagonal, or None when the native library is unavailable."""
    from .. import native
    lib = native.get_tracerec()
    if lib is None or getattr(lib, "trw_replay_fwd", None) is None:
        return None
    A8 = _i8view(A)
    B8 = _i8view(B)
    d32 = np.ascontiguousarray(np.asarray(diags, np.int32))
    ntw = len(d32) - 1
    cap = len(A8) // tspace + ntw + 16
    tr = _tbuf.fit(cap)
    ntr = np.zeros(1, np.int32)
    rc = lib.trw_replay_fwd(
        A8.ctypes.data_as(_I8P), len(A8),
        B8.ctypes.data_as(_I8P), len(B8),
        int(anti), d32.ctypes.data_as(_I32P), ntw,
        int(trima), int(trimx), int(trimd), int(aoff), int(tspace),
        tr.ctypes.data_as(_I32P), cap, ntr.ctypes.data_as(_I32P))
    if rc == -1:
        raise AssertionError(("fwd reach short", trimx))
    if rc != 0:
        return None
    n = int(ntr[0])
    path.trace.extend(map(tuple, tr[:2 * n].reshape(n, 2).tolist()))
    path.aepos = trimx
    path.bepos = trima - trimx
    path.diffs = trimd
    return int(d32[0])


def _native_replay_rev(A, B, anti, aoff, diags, trima, trimx, trimd,
                       path, tspace):
    from .. import native
    lib = native.get_tracerec()
    if lib is None or getattr(lib, "trw_replay_rev", None) is None:
        return None
    A8 = _i8view(A)
    B8 = _i8view(B)
    d32 = np.ascontiguousarray(np.asarray(diags, np.int32))
    ntw = len(d32) - 1
    cap = len(A8) // tspace + ntw + 16
    pre = _tbuf.fit(cap)
    npre = np.zeros(1, np.int32)
    fdd = np.zeros(1, np.int32)
    fdb = np.zeros(1, np.int32)
    fmod = ctypes.c_int(0)
    rc = lib.trw_replay_rev(
        A8.ctypes.data_as(_I8P), len(A8),
        B8.ctypes.data_as(_I8P), len(B8),
        int(anti), d32.ctypes.data_as(_I32P), ntw,
        int(trima), int(trimx), int(trimd), int(aoff), int(tspace),
        1 if path.tlen else 0,
        pre.ctypes.data_as(_I32P), cap, npre.ctypes.data_as(_I32P),
        fdd.ctypes.data_as(_I32P), fdb.ctypes.data_as(_I32P),
        ctypes.byref(fmod))
    if rc == -1:
        raise AssertionError(("rev reach short", trimx))
    if rc != 0:
        return None
    if fmod.value:
        de, ab = path.trace[0]
        path.trace[0] = (de + int(fdd[0]), ab + int(fdb[0]))
    n = int(npre[0])
    if n:
        path.trace[:0] = map(
            tuple, pre[:2 * n].reshape(n, 2)[::-1].tolist())
    path.abpos = trimx
    path.bbpos = trima - trimx
    path.diffs += trimd
    return True


def _marks_between(last: int, upto: int, tspace: int, aoff: int,
                   descending: bool = False) -> List[int]:
    """Grid marks (≡ aoff mod tspace) in (last, upto] ascending, or
    [upto, last) descending for the reverse wave."""
    out = []
    if not descending:
        m = last + tspace
        while m <= upto:
            out.append(m)
            m += tspace
    else:
        m = last - tspace
        while m >= upto:
            out.append(m)
            m -= tspace
    return out


def replay_forward(A, B, anti: int, aoff: int, diags, trima: int,
                   trimx: int, trimd: int, path: Path,
                   tspace: int = 100) -> int:
    """Rebuild the forward trace from the per-wave path diagonals
    (diags[w] for w = 0..trim_wave); appends to path, returns the seam
    diagonal."""
    trim_wave = len(diags) - 1

    # one-call C replay (reach + crossings + assembly)
    seam = _native_replay_fwd(A, B, anti, aoff, diags, trima, trimx,
                              trimd, path, tspace)
    if seam is not None:
        return seam

    # pure-Python mirror (and the C reach-only fast path)
    d0 = int(diags[0])
    na0 = (((anti + d0) >> 1) + (tspace - aoff)) // tspace * tspace \
        - tspace + aoff
    xs = _native_reach(A, B, anti, diags, trimx, +1)
    if xs is None:
        x = (anti + d0) >> 1
        x, _, _ = _snake_fwd(A, B, x, d0)
        xs = [x]
        for w in range(1, trim_wave + 1):
            dcur, dprev = int(diags[w]), int(diags[w - 1])
            vprev = 2 * xs[-1] - dprev
            c_pre = vprev + (2 if dcur == dprev else 1)
            xp = (c_pre + dcur) >> 1
            xp, _, _ = _snake_fwd(A, B, xp, dcur)
            xs.append(xp)
        assert xs[-1] >= trimx, (xs[-1], trimx)

    # crossings: (diag, mark, wave)
    crossings: List[Tuple[int, int, int]] = []
    last = na0
    for w in range(0, trim_wave + 1):
        for m in _marks_between(last, xs[w], tspace, aoff):
            crossings.append((int(diags[w]), m, w))
            last = m

    # assemble (align.c:805-870)
    trimy = trima - trimx
    k = d0
    b = (anti - d0) >> 1
    e = 0
    for (kc, mark, d) in crossings:
        a = mark - kc
        path.trace.append((d - e, a - b))
        b, e = a, d
        k = kc
    if b + k != trimx:
        path.trace.append((trimd - e, trimy - b))
    elif b != trimy:
        de, ab = path.trace[-1]
        path.trace[-1] = (de + (trimd - e), ab + (trimy - b))
    path.aepos = trimx
    path.bepos = trimy
    path.diffs = trimd
    return d0


def replay_reverse(A, B, anti: int, aoff: int, diags, trima: int,
                   trimx: int, trimd: int, path: Path,
                   tspace: int = 100):
    """Rebuild the reverse trace; prepends to path (align.c:1325-1414)."""
    trim_wave = len(diags) - 1

    if _native_replay_rev(A, B, anti, aoff, diags, trima, trimx,
                          trimd, path, tspace) is not None:
        return

    d0 = int(diags[0])
    x0 = (anti + d0) >> 1
    na0 = ((x0 + (tspace - aoff) - 1) // tspace - 1) * tspace + aoff
    xs = _native_reach(A, B, anti, diags, trimx, -1)
    if xs is None:
        x, _, _ = _snake_rev(A, B, x0, d0)
        xs = [x]
        for w in range(1, trim_wave + 1):
            dcur, dprev = int(diags[w]), int(diags[w - 1])
            vprev = 2 * xs[-1] - dprev
            c_pre = vprev - (2 if dcur == dprev else 1)
            xp = (c_pre + dcur) >> 1
            xp, _, _ = _snake_rev(A, B, xp, dcur)
            xs.append(xp)
        assert xs[-1] <= trimx, (xs[-1], trimx)

    # pebble 0 of the reverse wave records mark = x0 (pre-snake); the first
    # crossing candidate is na0 itself (align.c:1003: `while (x <= na)`
    # without a prior decrement)
    pebbles: List[Tuple[int, int, int]] = [(d0, x0, 0)]
    last = na0 + tspace
    for w in range(0, trim_wave + 1):
        for m in _marks_between(last, xs[w], tspace, aoff, descending=True):
            pebbles.append((int(diags[w]), m, w))
            last = m

    trimy = trima - trimx
    pre: List[Tuple[int, int]] = []
    k, mark0, _ = pebbles[0]
    b = mark0 - k
    e = 0
    i = 0
    if (b + k) % tspace != aoff:
        i = 1
        if i >= len(pebbles):
            a, d = trimy, trimd
        else:
            kc, mc, d = pebbles[i]
            a = mc - kc
        if path.tlen == 0:
            pre.append((d - e, b - a))
        else:
            de, ab = path.trace[0]
            path.trace[0] = (de + (d - e), ab + (b - a))
        b, e = a, d
        if i >= len(pebbles):
            pebbles = []
        else:
            pebbles = pebbles[i:]
            k = pebbles[0][0]
    if pebbles:
        for (kc, mc, d) in pebbles[1:]:
            a = mc - kc
            pre.append((d - e, b - a))
            b, e = a, d
            k = kc
        if b + k != trimx:
            pre.append((trimd - e, b - trimy))
        elif b != trimy:
            if pre:
                de, ab = pre[-1]
                pre[-1] = (de + (trimd - e), ab + (b - trimy))
            else:
                de, ab = path.trace[0]
                path.trace[0] = (de + (trimd - e), ab + (b - trimy))

    path.trace[:0] = pre[::-1]
    path.abpos = trimx
    path.bbpos = trimy
    path.diffs += trimd


def replay_pair_batch(seqs_a, seqs_b, antis, aoffs, tspace,
                      diags_f, ntw_f, trima_f, trimx_f, trimd_f,
                      diags_r, ntw_r, trima_r, trimx_r, trimd_r,
                      skip):
    """Batched fwd+rev replay with seam merge: ONE C call per device
    batch (trw_replay_pair_batch) instead of 2n wrapper calls — the
    per-call ctypes/numpy glue (~22 us) dominated host replay time on
    the single-core box.

    ``seqs_a``/``seqs_b``: per-item uint8 code arrays (kept alive for
    the call).  ``diags_f``/``diags_r``: the engine's [G+1, N] diagonal
    blocks (column i = item i).  Returns (tr, troff, stats, rcs) or
    None when the native library is unavailable; stats[i] = (abpos,
    bbpos, aepos, bepos, diffs, seam), rcs[i]: 0 ok, -1/-2 reach short
    (fwd/rev), -3 capacity (retry that item per-call)."""
    from .. import native
    lib = native.get_tracerec()
    if lib is None or getattr(lib, "trw_replay_pair_batch", None) is None:
        return None
    n = len(seqs_a)
    a8 = [_i8view(a) for a in seqs_a]
    b8 = [_i8view(b) for b in seqs_b]
    ap = np.array([a.ctypes.data for a in a8], np.uint64)
    bp = np.array([b.ctypes.data for b in b8], np.uint64)
    alens = np.array([len(a) for a in a8], np.int64)
    blens = np.array([len(b) for b in b8], np.int64)
    df = np.ascontiguousarray(diags_f, np.int32)
    dr = np.ascontiguousarray(diags_r, np.int32)
    ldf, ldr = df.shape[1], dr.shape[1]

    def i64(x):
        return np.ascontiguousarray(x, np.int64)

    ntwf = np.ascontiguousarray(ntw_f, np.int32)
    ntwr = np.ascontiguousarray(ntw_r, np.int32)
    cap = int((alens // tspace).sum()
              + ntwf.astype(np.int64).sum() + ntwr.astype(np.int64).sum()
              + 32 * n)
    tr = np.empty(2 * cap, np.int32)
    troff = np.empty(n + 1, np.int64)
    stats = np.zeros(6 * n, np.int64)
    rcs = np.empty(n, np.int32)
    sk = np.ascontiguousarray(skip, np.uint8)
    # bind every array for the call's duration (data_as pointers do not
    # themselves keep the temporaries alive across all numpy versions)
    keep = (antis, aoffs, trima_f, trimx_f, trimd_f,
            trima_r, trimx_r, trimd_r) = (
        i64(antis), i64(aoffs), i64(trima_f), i64(trimx_f),
        i64(trimd_f), i64(trima_r), i64(trimx_r), i64(trimd_r))
    _PP = ctypes.POINTER(ctypes.c_void_p)
    _I64 = ctypes.POINTER(ctypes.c_int64)
    lib.trw_replay_pair_batch(
        ap.ctypes.data_as(_PP), alens.ctypes.data_as(_I64),
        bp.ctypes.data_as(_PP), blens.ctypes.data_as(_I64),
        antis.ctypes.data_as(_I64),
        aoffs.ctypes.data_as(_I64), int(tspace),
        df.ctypes.data_as(_I32P), ldf, ntwf.ctypes.data_as(_I32P),
        trima_f.ctypes.data_as(_I64),
        trimx_f.ctypes.data_as(_I64),
        trimd_f.ctypes.data_as(_I64),
        dr.ctypes.data_as(_I32P), ldr, ntwr.ctypes.data_as(_I32P),
        trima_r.ctypes.data_as(_I64),
        trimx_r.ctypes.data_as(_I64),
        trimd_r.ctypes.data_as(_I64),
        sk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        tr.ctypes.data_as(_I32P), cap,
        troff.ctypes.data_as(_I64), stats.ctypes.data_as(_I64),
        rcs.ctypes.data_as(_I32P))
    del keep, a8, b8
    return tr, troff, stats.reshape(n, 6), rcs




