# Copied from fastga_tpu/ops/tracerec.py; imports point at fastga_tpu_torch.
"""Exact alignment reconstruction between trace points (host oracle).

Trace-point encoded alignments (the .1aln payload) store only per-100bp
(diffs, b-advance) pairs; the exact base-level alignment is recomputed on
demand.  This module is the exact scalar reconstruction engine used by the
converters (PAF CIGAR/CS, PSL, alignment displays) and as the verification
oracle for the batched device path (ops/tracerec_batch.py).

Behavioral contract (reference: align.c iter_np 5584-5903, Compute_Trace_PTS
6171-6308, Gap_Improver 6714-7133 — bit-exact reproduction of outputs is a
test requirement, the implementation is fresh):

* ``iter_np``: banded O(nd) furthest-reach wave between two trace points
  where D counts substitutions (cost 1) plus indel *pairs* beyond the
  unavoidable ``|M-N|`` (cost 2, hence the band widens only every other
  wave).  Tie preference on equal furthest reach: the same-wave gap move
  toward the main diagonal, then the substitution, then the 2-back gap move.
  The emitted trace is a list of signed ints: ``-(a+1)`` = one base of A
  (0-based position ``a``) deleted (gap in B), ``+(b+1)`` = one base of B
  inserted (gap in A before B position ``b``), in path order.
* ``compute_trace_pts``: runs iter_np per trace interval and concatenates.
* ``gap_improver``: clusters same-sign gaps separated by < LONG_SNAKE=50
  matching columns, and within each cluster re-optimizes with an
  affine-style objective (a run of adjacent gap columns costs one "wave"
  regardless of length) so scattered 1bp indels consolidate; endpoints,
  total indel count per cluster, and alignment length are preserved; only
  substitution counts (path->diffs) can change.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

GREEDIEST = 0
UPPERMOST = 1
LOWERMOST = 2

LONG_SNAKE = 50

# traceback edge codes (see align.c FS_MOVE / the e>1 h-=3 decode):
#   4: from k+1, same wave      2: from k-1, same wave
#   0: from k,   wave-1 (substitution)
#  -1: from k-1, wave-2         1: from k+1, wave-2
_ORIGIN = 3


class TraceError(Exception):
    pass


# ---- native fast path (native/tracerec.c via ctypes) ----------

_nat_tls = threading.local()


def _get_work(lib):
    """Per-thread native Work handle: converter threads reconstruct
    records concurrently (the C call drops the GIL), mirroring the
    reference's per-thread Work_Data (ALNtoPAF.c:165-171)."""
    w = getattr(_nat_tls, "work", None)
    if w is None:
        w = lib.trw_new()
        _nat_tls.work = w
    return w


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def _native_compute(A, B, abpos, aepos, bbpos, bepos, tpoints, tspace,
                    mode, selfie) -> Optional[Tuple[List[int], int]]:
    """C implementation of the default (band-free) compute_trace_pts
    path; None means "use the Python implementation" (unavailable, or the
    C core reported an error the Python path diagnoses properly)."""
    from .. import native
    lib = native.get_tracerec()
    if lib is None or len(tpoints) == 0:
        return None
    A8 = np.ascontiguousarray(np.asarray(A, np.int8))
    B8 = np.ascontiguousarray(np.asarray(B, np.int8))
    tp = np.ascontiguousarray(np.asarray(tpoints, np.int64)
                              .astype(np.int32).reshape(-1))
    w = _get_work(lib)
    d = lib.trw_compute_trace_pts(
        w, _i8p(A8), len(A8), _i8p(B8), len(B8),
        int(abpos), int(aepos), int(bbpos), int(bepos),
        tp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(tpoints), int(tspace), int(mode), int(bool(selfie)))
    if d < 0:
        return None
    n = lib.trw_trace_len(w)
    if n:
        tr = np.ctypeslib.as_array(lib.trw_trace(w),
                                   shape=(n,)).tolist()
    else:
        tr = []
    return tr, d


def _native_gap(A, B, abpos, bbpos, aepos, alen, blen,
                trace) -> Optional[Tuple[List[int], int]]:
    from .. import native
    lib = native.get_tracerec()
    if lib is None:
        return None
    A8 = np.ascontiguousarray(np.asarray(A, np.int8))
    B8 = np.ascontiguousarray(np.asarray(B, np.int8))
    t32 = np.ascontiguousarray(np.asarray(trace, np.int64)
                               .astype(np.int32))
    w = _get_work(lib)
    cd = lib.trw_gap_improver(
        w, _i8p(A8), int(alen), _i8p(B8), int(blen),
        int(abpos), int(bbpos), int(aepos),
        t32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(t32))
    if cd == -(1 << 31):
        return None
    return t32.tolist(), cd


def _pad(seq: np.ndarray) -> np.ndarray:
    """Two leading and one trailing sentinel (code 4) so indices as low as
    -2 (the wave's unreached markers) and one-past-the-end resolve without
    wrapping, matching the reference's contig buffers."""
    out = np.empty(len(seq) + 3, np.int8)
    out[0] = out[1] = out[-1] = 4
    out[2:-1] = seq
    return out


def iter_np(Ap: np.ndarray, Bp: np.ndarray, aoff: int, boff: int,
            M: int, N: int, dmax: int, posl: int, posh: int,
            mode: int = GREEDIEST) -> Tuple[List[int], int]:
    """One trace interval: align A[aoff:aoff+M] to B[boff:boff+N].

    Ap/Bp are _pad()ed full sequences; aoff/boff are 0-based positions in
    the unpadded arrays.  Returns (trace, diffs).
    """
    delv = M - N
    if delv >= 0:
        low, hgh = 0, delv
    else:
        low, hgh = delv, 0

    half = dmax // 2 + 2
    kmin = low - half
    W = (hgh - low) + 2 * half + 3
    koff = 1 - kmin
    # wave d lives at row d+2; rows -2,-1 are the two seeding pseudo-waves
    PVF = np.full((dmax + 3, W), -2, np.int64)
    PHF = np.zeros((dmax + 3, W), np.int8)
    PVF[1][0 + koff] = -1

    # base pointers into the padded arrays (+2 for the two lead sentinels)
    ab = aoff + 2
    bb = boff + 2

    low += 1
    hgh -= 1

    D = 0
    while True:
        if D > dmax:
            raise TraceError("trace point out of bounds (likely bad .1aln)")
        F2 = PVF[D]
        F1 = PVF[D + 1]
        F0 = PVF[D + 2]
        HF = PHF[D + 2]
        if (D & 1) == 0:
            if low > posl:
                low -= 1
            if hgh < posh:
                hgh += 1
        F0[hgh + 1 + koff] = F0[low - 1 + koff] = -2

        def fs_move(k, am, ac, ap, mdir, pdir):
            if ac < am:
                if ap < am:
                    HF[k + koff] = mdir
                    j = am
                else:
                    HF[k + koff] = pdir
                    j = ap
            else:
                if ap < ac:
                    HF[k + koff] = 0
                    j = ac
                else:
                    HF[k + koff] = pdir
                    j = ap
            lim = N if N < M - k else M - k
            while j < lim and Bp[bb + j] == Ap[ab + k + j]:
                j += 1
            F0[k + koff] = j
            return j

        j = -2
        for k in range(hgh, delv, -1):
            ap = j + 1
            am = F2[k - 1 + koff]
            ac = F1[k + koff] + 1
            j = fs_move(k, am, ac, ap, -1, 4)

        j = -2
        for k in range(low, delv):
            ap = F2[k + 1 + koff] + 1
            am = j
            ac = F1[k + koff] + 1
            j = fs_move(k, am, ac, ap, 2, 1)

        ap = F0[delv + 1 + koff] + 1
        am = j
        ac = F1[delv + koff] + 1
        j = fs_move(delv, am, ac, ap, 2, 4)

        if F0[delv + koff] >= N:
            break
        D += 1

    # ---- traceback: reverse the predecessor chain in place --------------
    PHF[2][0 + koff] = _ORIGIN
    c = N
    k = delv
    d = D
    e = int(PHF[d + 2][k + koff])
    PHF[d + 2][k + koff] = _ORIGIN

    if mode == UPPERMOST:
        while e != _ORIGIN:
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                d -= 1
            else:
                d -= 2
            if h < k:  # e == -1 or 2: slide the gap upward if possible
                m = -k if k < 0 else 0
                if PVF[d + 2][h + koff] <= c:
                    c = PVF[d + 2][h + koff] - 1
                while c >= m and Ap[ab + k + c] == Bp[bb + c]:
                    c -= 1
                if e == -1:
                    if c <= PVF[d + 4][k + 1 + koff]:
                        e = 4
                        h = k + 1
                        d = d + 2
                    elif c == PVF[d + 3][k + koff]:
                        e = 0
                        h = k
                        d = d + 1
                    else:
                        PVF[d + 2][h + koff] = c + 1
                else:
                    m2 = d if k == delv else d - 2
                    if c <= PVF[m2 + 2][k + 1 + koff]:
                        e = 4 if k == delv else 1
                        h = k + 1
                        d = m2
                    elif c == PVF[d + 1][k + koff]:
                        e = 0
                        h = k
                        d = d - 1
                    else:
                        PVF[d + 2][h + koff] = c + 1
            m = int(PHF[d + 2][h + koff])
            PHF[d + 2][h + koff] = e
            e = m
            k = h
    elif mode == LOWERMOST:
        while e != _ORIGIN:
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                d -= 1
            else:
                d -= 2
            if h > k:  # e == 1 or 4: slide the gap downward if possible
                m = -k if k < 0 else 0
                if PVF[d + 2][h + koff] < c:
                    c = PVF[d + 2][h + koff]
                while c >= m and Ap[ab + k + c] == Bp[bb + c]:
                    c -= 1
                if e == 1:
                    if c < PVF[d + 4][k - 1 + koff]:
                        e = 2
                        h = k - 1
                        d = d + 2
                    elif c == PVF[d + 3][k + koff]:
                        e = 0
                        h = k
                        d = d + 1
                    else:
                        PVF[d + 2][h + koff] = c
                        c -= 1
                else:
                    m2 = d if k == delv else d - 2
                    if c < PVF[m2 + 2][k - 1 + koff]:
                        e = 2 if k == delv else -1
                        h = k - 1
                        d = m2
                    elif c == PVF[d + 1][k + koff]:
                        e = 0
                        h = k
                        d = d - 1
                    else:
                        PVF[d + 2][h + koff] = c
                        c -= 1
            m = int(PHF[d + 2][h + koff])
            PHF[d + 2][h + koff] = e
            e = m
            k = h
    else:  # GREEDIEST
        while e != _ORIGIN:
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                d -= 1
            else:
                d -= 2
            m = int(PHF[d + 2][h + koff])
            PHF[d + 2][h + koff] = e
            e = m
            k = h

    # ---- forward walk: emit signed indel positions ----------------------
    trace: List[int] = []
    ap_base = -aoff - 1     # (Aabs - A) - 1 with A = Aabs + aoff
    bp_base = boff + 1      # (B - Babs) + 1
    k = 0
    d = 0
    e = int(PHF[2][0 + koff])
    while e != _ORIGIN:
        h = k - e
        c = int(PVF[d + 2][k + koff])
        if e > 1:
            h += 3
        elif e == 0:
            d += 1
        else:
            d += 2
        if h > k:
            trace.append(bp_base + c)
        elif h < k:
            trace.append(ap_base - (c + k))
        k = h
        e = int(PHF[d + 2][h + koff])

    return trace, D + abs(delv)


def middle_np(Ap: np.ndarray, Bp: np.ndarray, aoff: int, boff: int,
              M: int, N: int, dmax: int, posl: int, posh: int,
              mode: int = GREEDIEST) -> Tuple[int, int]:
    """Mid-point of the optimal path for one interval (align.c middle_np
    5905-6168): runs the same forward wave as iter_np then backtracks
    only half the edit units (with the UPPERMOST/LOWERMOST gap-sliding
    adjustments) and returns the absolute (mida, midb)."""
    delv = M - N
    if delv >= 0:
        low, hgh = 0, delv
    else:
        low, hgh = delv, 0

    half = dmax // 2 + 2
    kmin = low - half
    W = (hgh - low) + 2 * half + 3
    koff = 1 - kmin
    PVF = np.full((dmax + 3, W), -2, np.int64)
    PHF = np.zeros((dmax + 3, W), np.int8)
    PVF[1][0 + koff] = -1

    ab = aoff + 2
    bb = boff + 2

    low += 1
    hgh -= 1

    D = 0
    while True:
        if D > dmax:
            raise TraceError("trace point out of bounds (likely bad .1aln)")
        F2 = PVF[D]
        F1 = PVF[D + 1]
        F0 = PVF[D + 2]
        HF = PHF[D + 2]
        if (D & 1) == 0:
            if low > posl:
                low -= 1
            if hgh < posh:
                hgh += 1
        F0[hgh + 1 + koff] = F0[low - 1 + koff] = -2

        def fs_move(k, am, ac, ap, mdir, pdir):
            if ac < am:
                if ap < am:
                    HF[k + koff] = mdir
                    j = am
                else:
                    HF[k + koff] = pdir
                    j = ap
            else:
                if ap < ac:
                    HF[k + koff] = 0
                    j = ac
                else:
                    HF[k + koff] = pdir
                    j = ap
            lim = N if N < M - k else M - k
            while j < lim and Bp[bb + j] == Ap[ab + k + j]:
                j += 1
            F0[k + koff] = j
            return j

        j = -2
        for k in range(hgh, delv, -1):
            ap = j + 1
            am = F2[k - 1 + koff]
            ac = F1[k + koff] + 1
            j = fs_move(k, am, ac, ap, -1, 4)

        j = -2
        for k in range(low, delv):
            ap = F2[k + 1 + koff] + 1
            am = j
            ac = F1[k + koff] + 1
            j = fs_move(k, am, ac, ap, 2, 1)

        ap = F0[delv + 1 + koff] + 1
        am = j
        ac = F1[delv + koff] + 1
        fs_move(delv, am, ac, ap, 2, 4)

        if F0[delv + koff] >= N:
            break
        D += 1

    # ---- backtrack half the edit units -----------------------------------
    d = D + abs(delv)
    c = N
    k = delv
    f = d // 2
    if mode == UPPERMOST:
        while d > f:
            e = int(PHF[D + 2][k + koff])
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                D -= 1
            else:
                D -= 2
            if h < k:
                m = -k if k < 0 else 0
                if PVF[D + 2][h + koff] <= c:
                    c = PVF[D + 2][h + koff] - 1
                while c >= m and Ap[ab + k + c] == Bp[bb + c]:
                    c -= 1
                if e == -1:
                    if c <= PVF[D + 4][k + 1 + koff]:
                        e = 4
                        h = k + 1
                        D = D + 2
                    elif c == PVF[D + 3][k + koff]:
                        e = 0
                        h = k
                        D = D + 1
                    else:
                        PVF[D + 2][h + koff] = c + 1
                else:
                    m2 = D if k == delv else D - 2
                    if c <= PVF[m2 + 2][k + 1 + koff]:
                        e = 4 if k == delv else 1
                        h = k + 1
                        D = m2
                    elif c == PVF[D + 1][k + koff]:
                        e = 0
                        h = k
                        D = D - 1
                    else:
                        PVF[D + 2][h + koff] = c + 1
            k = h
            d -= 1
    elif mode == LOWERMOST:
        while d > f:
            e = int(PHF[D + 2][k + koff])
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                D -= 1
            else:
                D -= 2
            if h > k:
                m = -k if k < 0 else 0
                if PVF[D + 2][h + koff] < c:
                    c = PVF[D + 2][h + koff]
                while c >= m and Ap[ab + k + c] == Bp[bb + c]:
                    c -= 1
                if e == 1:
                    if c < PVF[D + 4][k - 1 + koff]:
                        e = 2
                        h = k - 1
                        D = D + 2
                    elif c == PVF[D + 3][k + koff]:
                        e = 0
                        h = k
                        D = D + 1
                    else:
                        PVF[D + 2][h + koff] = c
                        c -= 1
                else:
                    m2 = D if k == delv else D - 2
                    if c < PVF[m2 + 2][k - 1 + koff]:
                        e = 2 if k == delv else -1
                        h = k - 1
                        D = m2
                    elif c == PVF[D + 1][k + koff]:
                        e = 0
                        h = k
                        D = D - 1
                    else:
                        PVF[D + 2][h + koff] = c
                        c -= 1
            k = h
            d -= 1
    else:
        while d > f:
            e = int(PHF[D + 2][k + koff])
            h = k + e
            if e > 1:
                h -= 3
            elif e == 0:
                D -= 1
            else:
                D -= 2
            k = h
            d -= 1

    pv = int(PVF[D + 2][k + koff])
    return aoff + int(k) + pv, boff + pv


def compute_trace_mid(A: np.ndarray, B: np.ndarray, abpos: int, aepos: int,
                      bbpos: int, bepos: int,
                      tpoints: Sequence[Tuple[int, int]], tspace: int,
                      mode: int = GREEDIEST,
                      dlow: int = 1, dhgh: int = -1,
                      selfie: bool = False) -> Tuple[List[int], int]:
    """Compute_Trace_MID (align.c:6310-6470): exact alignment stitched at
    per-interval path mid-points — ~2x slower than compute_trace_pts but
    nearer-optimal.  Mirrors the reference exactly, including its tail
    diff accounting (the middle segment's diff count is added twice,
    align.c:6455-6462).  Returns (signed indel trace, diffs)."""
    Ap = _pad(np.asarray(A, np.int8))
    Bp = _pad(np.asarray(B, np.int8))
    alen, blen = len(A), len(B)

    dmax = 0
    for dcnt, _ in tpoints:
        if dcnt > dmax:
            dmax = dcnt
    if dmax & 1:
        dmax += 1

    db = abpos - bbpos
    de = aepos - bepos
    if dlow <= dhgh:
        if db < dlow or db > dhgh or de < dlow or de > dhgh:
            raise TraceError("alignment endpoints not in band")
    else:
        dlow = -0x3FFFFFFF
        dhgh = 0x3FFFFFFF
        if selfie:
            if db == 0 or de == 0 or (db > 0) != (de > 0):
                raise TraceError("self comparison crosses main diagonal")
            elif db < 0:
                dhgh = -1
            else:
                dlow = 1

    trace: List[int] = []
    diffs = 0
    ab = as_ = abpos
    ae = (ab // tspace) * tspace
    bb = bs = bbpos
    db = ds = ab - bb
    for dcnt, badv in tpoints[:-1]:
        ae = ae + tspace
        be = bb + badv
        if ae > alen or be > blen:
            raise TraceError("trace point out of bounds")
        af, bf = middle_np(Ap, Bp, ab, bb, ae - ab, be - bb, dmax,
                           dlow - db, dhgh - db, mode)
        t, d = iter_np(Ap, Bp, as_, bs, af - as_, bf - bs, dmax,
                       dlow - ds, dhgh - ds, mode)
        trace.extend(t)
        diffs += d
        ab, bb = ae, be
        as_, bs = af, bf
        db = ab - bb
        ds = as_ - bs

    ae, be = aepos, bepos
    if ae > alen or be > blen:
        raise TraceError("trace point out of bounds")
    af, bf = middle_np(Ap, Bp, ab, bb, ae - ab, be - bb, dmax,
                       dlow - db, dhgh - db, mode)
    t, d = iter_np(Ap, Bp, as_, bs, af - as_, bf - bs, dmax,
                   dlow - ds, dhgh - ds, mode)
    trace.extend(t)
    diffs += d
    as_, bs = af, bf
    ds = as_ - bs
    t, d2 = iter_np(Ap, Bp, af, bf, ae - as_, be - bs, dmax,
                    dlow - ds, dhgh - ds, mode)
    trace.extend(t)
    diffs += d + d2       # reference adds the mid segment's count twice
    return trace, diffs


def compute_trace_pts(A: np.ndarray, B: np.ndarray, abpos: int, aepos: int,
                      bbpos: int, bepos: int,
                      tpoints: Sequence[Tuple[int, int]], tspace: int,
                      mode: int = GREEDIEST,
                      dlow: int = 1, dhgh: int = -1,
                      selfie: bool = False) -> Tuple[List[int], int]:
    """Exact alignment across all trace intervals (Compute_Trace_PTS).

    ``A``/``B`` are full numeric (0..3) contig sequences in alignment
    orientation (B already complemented for R records, coords in complement
    space).  ``tpoints`` = [(diffs, b-advance), ...].  Returns
    (signed indel trace, recomputed diffs).
    """
    if dlow > dhgh and mode in (GREEDIEST, UPPERMOST, LOWERMOST):
        res = _native_compute(A, B, abpos, aepos, bbpos, bepos, tpoints,
                              tspace, mode, selfie)
        if res is not None:
            return res
    Ap = _pad(np.asarray(A, np.int8))
    Bp = _pad(np.asarray(B, np.int8))
    alen, blen = len(A), len(B)

    dmax = 0
    for dcnt, _ in tpoints:
        if dcnt > dmax:
            dmax = dcnt
    if dmax & 1:
        dmax += 1

    db = abpos - bbpos
    de = aepos - bepos
    if dlow <= dhgh:
        if db < dlow or db > dhgh or de < dlow or de > dhgh:
            raise TraceError("alignment endpoints not in band")
    else:
        dlow = -0x3FFFFFFF
        dhgh = 0x3FFFFFFF
        if selfie:
            if db == 0 or de == 0 or (db > 0) != (de > 0):
                raise TraceError("self comparison crosses main diagonal")
            elif db < 0:
                dhgh = -1
            else:
                dlow = 1

    trace: List[int] = []
    diffs = 0
    ab = abpos
    ae = (ab // tspace) * tspace
    bb = bbpos
    n = len(tpoints)
    for i in range(n - 1):
        ae = ae + tspace
        be = bb + tpoints[i][1]
        if ae > alen or be > blen:
            raise TraceError("trace point out of bounds")
        db = ab - bb
        t, d = iter_np(Ap, Bp, ab, bb, ae - ab, be - bb, dmax,
                       dlow - db, dhgh - db, mode)
        trace.extend(t)
        diffs += d
        ab, bb = ae, be
    ae, be = aepos, bepos
    if ae > alen or be > blen:
        raise TraceError("trace point out of bounds")
    db = ab - bb
    t, d = iter_np(Ap, Bp, ab, bb, ae - ab, be - bb, dmax,
                   dlow - db, dhgh - db, mode)
    trace.extend(t)
    diffs += d
    return trace, diffs


# ---------------------------------------------------------------------------
# Gap consolidation (Gap_Improver)
# ---------------------------------------------------------------------------


def compute_trace_irr(A: np.ndarray, B: np.ndarray, abpos: int,
                      aepos: int, bbpos: int, bepos: int,
                      tpoints: Sequence[Tuple[int, int]],
                      mode: int = GREEDIEST,
                      dlow: int = 1, dhgh: int = -1,
                      selfie: bool = False) -> Tuple[List[int], int]:
    """Compute_Trace_IRR (align.c:6472-6610): exact trace for trace
    points with irregular spacing — each pair is (a-advance, b-advance)
    rather than (diffs, b-advance).  dmax = min(max a-adv, max b-adv)
    per the reference's band sizing.  Returns (trace, diffs)."""
    Ap = _pad(np.asarray(A, np.int8))
    Bp = _pad(np.asarray(B, np.int8))
    alen, blen = len(A), len(B)

    mmax = nmax = 0
    for aadv, badv in tpoints:
        mmax = max(mmax, aadv)
        nmax = max(nmax, badv)
    if len(tpoints) == 0:
        mmax = aepos - abpos
        nmax = bepos - bbpos
    dmax = min(mmax, nmax)

    db = abpos - bbpos
    de = aepos - bepos
    if dlow <= dhgh:
        if db < dlow or db > dhgh or de < dlow or de > dhgh:
            raise TraceError("alignment endpoints not in band")
    else:
        dlow = -0x3FFFFFFF
        dhgh = 0x3FFFFFFF
        if selfie:
            if db == 0 or de == 0 or (db > 0) != (de > 0):
                raise TraceError("self comparison crosses main diagonal")
            elif db < 0:
                dhgh = -1
            else:
                dlow = 1

    trace: List[int] = []
    diffs = 0
    ab, bb = abpos, bbpos
    db = ab - bb
    for aadv, badv in tpoints:
        ae = ab + aadv
        be = bb + badv
        if ae > alen or be > blen:
            raise TraceError("trace point out of bounds")
        t, d = iter_np(Ap, Bp, ab, bb, ae - ab, be - bb, dmax,
                       dlow - db, dhgh - db, mode)
        trace.extend(t)
        diffs += d
        ab, bb = ae, be
        db = ab - bb
    return trace, diffs


def _hamming(Ap, ai, Bp, bi, n) -> int:
    """Mismatch count over n columns; sentinel (4) on either side ends the
    scan (reference hamming align.c:6621-6638).  ai/bi are 1-based."""
    h = 0
    for i in range(n):
        x = Ap[ai + 1 + i]
        if x == 4:
            break
        y = Bp[bi + 1 + i]
        if x != y:
            if y == 4:
                break
            h += 1
    return h


def _snake(Ap, ai, Bp, bi) -> int:
    """Forward match run length from 1-based positions ai/bi (exclusive);
    A-side sentinel ends it, a B sentinel mismatches normally."""
    i = 0
    while True:
        x = Ap[ai + 1 + i]
        if x == 4 or x != Bp[bi + 1 + i]:
            break
        i += 1
    return i


def _rsnake(Ap, ai, Bp, bi) -> int:
    """Backward match run length ending just before 1-based ai/bi."""
    i = 0
    while True:
        x = Ap[ai - i]
        if x == 4 or x != Bp[bi - i]:
            break
        i += 1
    return i


def gap_improver(A: np.ndarray, B: np.ndarray, abpos: int, bbpos: int,
                 aepos: int, alen: int, blen: int,
                 trace: List[int], diffs: int) -> Tuple[List[int], int]:
    """Consolidate nearby gaps in a signed-indel trace (Gap_Improver).

    Works in 1-based coordinates like the reference (A = aseq-1).  Returns
    (modified trace, adjusted diffs).  The trace is modified in place and
    also returned.
    """
    res = _native_gap(A, B, abpos, bbpos, aepos, alen, blen, trace)
    if res is not None:
        t2, cdiff = res
        return t2, diffs + cdiff
    Ap = _pad(np.asarray(A, np.int8))
    Bp = _pad(np.asarray(B, np.int8))
    # 1-based access: element i (1-based) of A is Ap[i+1]
    t = trace
    T = len(t)
    cdiff = 0
    d = abpos - bbpos
    if T == 0:
        return t, diffs
    q = t[0]
    x = 0
    while x < T:
        p = q
        m = x
        Fdag = d
        Fpos = p
        Hamm = 0
        Gaps = 1
        while True:
            x += 1
            q = 0
            if x >= T or (q := t[x]) != p:
                m = x - m
                if p < 0:
                    d -= m
                    if q >= 0:
                        break
                    if p - q >= LONG_SNAKE:
                        break
                    Hamm += _hamming(Ap, -p, Bp, -(d + p), p - q)
                else:
                    d += m
                    if q <= 0:
                        break
                    if q - p >= LONG_SNAKE:
                        break
                    Hamm += _hamming(Ap, p + d, Bp, p, q - p)
                Gaps += 1
                p = q
                m = x
        if Gaps == 1:
            continue
        Lpos = p
        Diag = abs(Fdag - d) + 1

        if Fpos < 0:
            # gaps in B: positions are A coordinates, diagonals Fdag..d desc
            Fpos = -Fpos
            Lpos = -Lpos
            if x < Diag:
                p = 0
            else:
                mm = t[x - Diag]
                p = -mm if mm < 0 else mm + Fdag
            while (Ap[Fpos] != Bp[Fpos - Fdag] and Ap[Fpos] != 4
                   and Bp[Fpos - Fdag] != 4):
                if Fpos <= p:
                    break
                Fpos -= 1
            if x >= T:
                p = alen
            else:
                mm = t[x]
                p = -mm if mm < 0 else mm + d
            while (Ap[Lpos + 1] != Bp[Lpos - d + 1] and Ap[Lpos + 1] != 4
                   and Bp[Lpos - d + 1] != 4):
                if Lpos >= p:
                    break
                Lpos += 1

            F = [0] * Diag
            F[0] = Fpos + _snake(Ap, Fpos, Bp, Fpos - Fdag)
            for i in range(1, Diag):
                F[i] = Fpos - 2
            G = [0] * Diag
            H: List[int] = []
            passes = 0
            pcur = Fpos
            while pcur < Lpos:
                b = Fpos
                c = 0
                u = 0x7FFFFFFF
                fi = 0
                for mdiag in range(Fdag, d - 1, -1):
                    n = F[fi]
                    if n >= b:
                        pcur = n + 1
                        H.append(0)
                        if n > b:
                            c = 0
                            u = G[fi] + 1
                            b = n
                        else:
                            if G[fi] + 1 < u:
                                c = 0
                                u = G[fi] + 1
                            else:
                                c += 1
                    else:
                        n += 1
                        pcur = b
                        c += 1
                        if n == b:
                            if G[fi] < u:
                                H.append(0)
                            else:
                                H.append(c)
                                G[fi] = u
                        else:
                            H.append(c)
                            G[fi] = u
                    pcur += _snake(Ap, pcur, Bp, pcur - mdiag)
                    F[fi] = pcur
                    fi += 1
                passes += 1

            if passes < Gaps + Hamm:
                pcur = Lpos
                mdiag = d
                y = x
                nham = 0
                hrow = len(H)
                while hrow > 0:
                    pcur -= _rsnake(Ap, pcur, Bp, pcur - mdiag)
                    if pcur < Fpos:
                        pcur = Fpos
                    hrow -= Diag
                    k = H[hrow + (Fdag - mdiag)]
                    if k == 0:
                        pcur -= 1
                        nham += 1
                    else:
                        mdiag += k
                        for _ in range(k):
                            y -= 1
                            t[y] = -pcur
                cdiff += nham - Hamm
        else:
            # gaps in A: positions are B coordinates, diagonals Fdag..d asc
            if x < Diag:
                p = 0
            else:
                mm = t[x - Diag]
                p = -(mm + Fdag) if mm < 0 else mm
            while (Bp[Fpos] != Ap[Fpos + Fdag] and Bp[Fpos] != 4
                   and Ap[Fpos + Fdag] != 4):
                if Fpos <= p:
                    break
                Fpos -= 1
            if x >= T:
                p = blen
            else:
                mm = t[x]
                p = -(mm + d) if mm < 0 else mm
            while (Bp[Lpos + 1] != Ap[Lpos + d + 1] and Bp[Lpos + 1] != 4
                   and Ap[Lpos + d + 1] != 4):
                if Lpos >= p:
                    break
                Lpos += 1

            F = [0] * Diag
            F[0] = Fpos + _snake(Ap, Fpos + Fdag, Bp, Fpos)
            for i in range(1, Diag):
                F[i] = Fpos - 2
            G = [0] * Diag
            H = []
            passes = 0
            pcur = Fpos
            while pcur < Lpos:
                b = Fpos
                c = 0
                u = 0x7FFFFFFF
                fi = 0
                for mdiag in range(Fdag, d + 1):
                    n = F[fi]
                    if n >= b:
                        pcur = n + 1
                        H.append(0)
                        if n > b:
                            c = 0
                            u = G[fi] + 1
                            b = n
                        else:
                            if G[fi] + 1 < u:
                                c = 0
                                u = G[fi] + 1
                            else:
                                c += 1
                    else:
                        n += 1
                        pcur = b
                        c += 1
                        if n == b:
                            if G[fi] < u:
                                H.append(0)
                            else:
                                H.append(c)
                                G[fi] = u
                        else:
                            H.append(c)
                            G[fi] = u
                    pcur += _snake(Ap, mdiag + pcur, Bp, pcur)
                    F[fi] = pcur
                    fi += 1
                passes += 1

            if passes < Gaps + Hamm:
                pcur = Lpos
                mdiag = d
                y = x
                nham = 0
                hrow = len(H)
                while hrow > 0:
                    pcur -= _rsnake(Ap, pcur + mdiag, Bp, pcur)
                    if pcur < Fpos:
                        pcur = Fpos
                    hrow -= Diag
                    k = H[hrow + (mdiag - Fdag)]
                    if k == 0:
                        pcur -= 1
                        nham += 1
                    else:
                        mdiag -= k
                        for _ in range(k):
                            y -= 1
                            t[y] = pcur
                cdiff += nham - Hamm

    return t, diffs + cdiff


# ---------------------------------------------------------------------------
# Presentation: CIGAR / CS / per-block decompositions from a signed trace
# ---------------------------------------------------------------------------


def cigar_m(trace: List[int], abpos: int, aepos: int,
            bbpos: int) -> Tuple[List[Tuple[str, int]], int]:
    """(op, len) list in M/I/D ops + total deleted (ALNtoPAF.c:284-340).

    Ops are relative to A as the query: I = extra base in A, D = base of B
    missing from A.
    """
    cig: List[Tuple[str, int]] = []
    dele = 0
    ilen = dlen = 0
    k = abpos + 1
    h = bbpos + 1
    for p in trace:
        if p < 0:
            blen = -(p + k)
            k += blen
            h += blen + 1
            if dlen > 0:
                cig.append(("I", dlen))
            dlen = 0
            if blen == 0:
                ilen += 1
            else:
                if ilen > 0:
                    cig.append(("D", ilen))
                    dele += ilen
                cig.append(("M", blen))
                ilen = 1
        else:
            blen = p - h
            k += blen + 1
            h += blen
            if ilen > 0:
                cig.append(("D", ilen))
                dele += ilen
            ilen = 0
            if blen == 0:
                dlen += 1
            else:
                if dlen > 0:
                    cig.append(("I", dlen))
                cig.append(("M", blen))
                dlen = 1
    if dlen > 0:
        cig.append(("I", dlen))
    if ilen > 0:
        cig.append(("D", ilen))
        dele += ilen
    blen = (aepos - k) + 1
    if blen > 0:
        cig.append(("M", blen))
    return cig, dele


def cigar_x(trace: List[int], A: np.ndarray, B: np.ndarray,
            abpos: int, aepos: int,
            bbpos: int) -> Tuple[List[Tuple[str, int]], int]:
    """(op, len) list in =/X/I/D ops (ALNtoPAF.c:343-455)."""
    cig: List[Tuple[str, int]] = []

    def match_run(k, h, blen):
        elen = xlen = 0
        for _ in range(blen):
            if A[k - 1] == B[h - 1]:
                if xlen > 0:
                    cig.append(("X", xlen))
                xlen = 0
                elen += 1
            else:
                if elen > 0:
                    cig.append(("=", elen))
                elen = 0
                xlen += 1
            k += 1
            h += 1
        if xlen > 0:
            cig.append(("X", xlen))
        if elen > 0:
            cig.append(("=", elen))

    dele = 0
    ilen = dlen = 0
    k = abpos + 1
    h = bbpos + 1
    for p in trace:
        if p < 0:
            blen = -(p + k)
            if dlen > 0:
                cig.append(("I", dlen))
            dlen = 0
            if blen == 0:
                ilen += 1
            else:
                if ilen > 0:
                    cig.append(("D", ilen))
                    dele += ilen
                match_run(k, h, blen)
                k += blen
                h += blen
                ilen = 1
            h += 1
        else:
            blen = p - h
            if ilen > 0:
                cig.append(("D", ilen))
                dele += ilen
            ilen = 0
            if blen == 0:
                dlen += 1
            else:
                if dlen > 0:
                    cig.append(("I", dlen))
                match_run(k, h, blen)
                k += blen
                h += blen
                dlen = 1
            k += 1
    if dlen > 0:
        cig.append(("I", dlen))
    if ilen > 0:
        cig.append(("D", ilen))
        dele += ilen
    blen = (aepos - k) + 1
    if blen > 0:
        match_run(k, h, blen)
    return cig, dele


def check_trace_points(abpos: int, aepos: int, bbpos: int, bepos: int,
                       tpoints: Sequence[Tuple[int, int]],
                       tspace: int) -> bool:
    """Trace-point consistency check (align.c Check_Trace_Points
    3962-4004): right point count for the spacing and b-advances summing
    to the aligned B interval.  With tspace == 0 the pairs are
    (a-advance, b-advance) and both sums are checked."""
    if tspace != 0:
        if ((aepos - 1) // tspace - abpos // tspace + 1) != len(tpoints):
            return False
        p = bbpos
        for _, badv in tpoints:
            p += badv
        return p == bepos
    p, q = bbpos, abpos
    for aadv, badv in tpoints:
        q += aadv
        p += badv
    return p == bepos and q == aepos


def flip_alignment(abpos: int, aepos: int, bbpos: int, bepos: int,
                   alen: int, blen: int, comp: bool,
                   trace: Optional[List[int]] = None):
    """Swap the roles of A and B (align.c Flip_Alignment 4007-4060).

    For comp alignments the coordinates reflect through the complement;
    a full signed-indel trace (if given) is remapped and, for comp,
    reversed.  Returns (abpos, aepos, bbpos, bepos, alen, blen, trace).
    """
    t = list(trace) if trace is not None else None
    if comp:
        nab, nbe = blen - bepos, alen - abpos
        nae, nbb = blen - bbpos, alen - aepos
        abpos, aepos, bbpos, bepos = nab, nae, nbb, nbe
        if t is not None:
            al2, bl2 = alen + 2, blen + 2
            t = [(al2 + p) if p < 0 else (p - bl2) for p in t][::-1]
    else:
        abpos, bbpos = bbpos, abpos
        aepos, bepos = bepos, aepos
        if t is not None:
            t = [-p for p in t]
    return abpos, aepos, bbpos, bepos, blen, alen, t
