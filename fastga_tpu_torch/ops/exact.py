# Copied from fastga_tpu/ops/exact.py; imports point at fastga_tpu_torch.
"""Exact O(nd) divide-and-conquer aligner (align.c Compute_Alignment).

Port of the reference's split_nd / trace_nd / dandc_nd machinery
(align.c:5046-5583): a Myers bidirectional D&C that computes the OPTIMAL
difference count and, on request, either an exact signed-indel trace or a
trace-point pair list.  Used when trace points are absent or when the
optimal (rather than trace-point-stitched) alignment is wanted.

Tasks mirror align.h:292-297: DIFF_ONLY computes diffs and the optimal
mid-point; the PLUS variants reuse that mid-point; the DIFF variants
recompute from scratch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

PLUS_ALIGN = 0
PLUS_TRACE = 1
DIFF_ONLY = 2
DIFF_ALIGN = 3
DIFF_TRACE = 4


def _scan_fwd(A, B, y, k, lim):
    """while (y < lim && B[y] == A[y+k]) y += 1  — guarded at 0."""
    if y < 0:
        return y
    lo = max(y, -k if k < 0 else 0)
    if lo > y:
        return y
    if y >= lim:
        return y
    bx = B[y:lim]
    ax = A[y + k:lim + k]
    neq = bx != ax
    if not neq.any():
        return lim
    return y + int(np.argmax(neq))


def _scan_rev(A, B, y, k, lo):
    """while (y >= lo && B[y] == A[y+k]) y -= 1  — guarded at bounds."""
    lo = max(lo, 0, -k)
    if y < lo:
        return y
    hi = min(y, len(B) - 1, len(A) - 1 - k)
    if hi < y:
        return y
    bx = B[lo:y + 1][::-1]
    ax = A[lo + k:y + 1 + k][::-1]
    neq = bx != ax
    if not neq.any():
        return lo - 1
    return y - int(np.argmax(neq))


def split_nd(A: np.ndarray, B: np.ndarray) -> Tuple[int, int, int]:
    """Optimal split: returns (D, x, y) where the optimal path from (0,0)
    to (M,N) passes through (x, y) with D total differences
    (align.c:5046-5205)."""
    M, N = len(A), len(B)
    VF = {}
    VB = {}

    y = _scan_fwd(A, B, 0, 0, min(M, N))
    if y >= M and N == M:
        return 0, M, M
    flow = 0
    VF[0] = y
    VF[-1] = -2

    xd = N - M
    y = _scan_rev(A, B, N - 1, -xd, xd if N > M else 0)
    blow = bhgh = -xd
    VB[blow] = y
    VB[blow - 1] = N + 1

    D = 1
    while True:
        # forward wave
        flow -= 1
        am = ac = -2
        VF[flow - 1] = -2
        for k in range(D, flow - 1, -1):
            ap = ac
            ac = am + 1
            am = VF.get(k - 1, -2)
            if ac < am:
                y = am if ap < am else ap
            else:
                y = ac if ap < ac else ap
            if blow <= k <= bhgh:
                r = VB[k]
                if y > r:
                    D = (D << 1) - 1
                    if ap > r:
                        y = ap
                    elif ac > r:
                        y = ac
                    else:
                        y = r + 1
                    return D, k + y, y
            xlim = M - k
            y = _scan_fwd(A, B, y, k, N if N < xlim else xlim)
            VF[k] = y

        # reverse wave
        bhgh += 1
        blow -= 1
        am = ac = N + 1
        VB[blow - 1] = N + 1
        for k in range(bhgh, blow - 1, -1):
            ap = ac + 1
            ac = am
            am = VB.get(k - 1, N + 1)
            if ac > am:
                y = am if ap > am else ap
            else:
                y = ac if ap > ac else ap
            if flow <= k <= D:
                r = VF[k]
                if y <= r:
                    D = D << 1
                    if ap <= r:
                        y = ap
                    elif ac <= r:
                        y = ac
                    else:
                        y = r
                    return D, k + y, y
            y -= 1
            y = _scan_rev(A, B, y, k, -k if -k > 0 else 0)
            VB[k] = y

        D += 1


def dandc_nd(A, B, aoff: int, boff: int, out: List[int]) -> int:
    """Exact signed-indel trace via D&C (align.c:5355-5424).  aoff/boff
    are the absolute offsets of A/B within the full sequences; emits
    -(apos+1) per insert-in-B / (bpos+1) per delete as the reference's
    Stop stream.  Returns the difference count."""
    M, N = len(A), len(B)
    if M <= 0:
        x = -aoff - 1
        out.extend([x] * N)
        return N
    if N <= 0:
        y = boff + 1
        out.extend([y] * M)
        return M
    D, x, y = split_nd(A, B)
    if D > 1:
        dandc_nd(A[:x], B[:y], aoff, boff, out)
        dandc_nd(A[x:], B[y:], aoff + x, boff + y, out)
    elif D == 1:
        if M > N:
            out.append(boff + y + 1)
        elif M < N:
            out.append(-(aoff + x) - 1)
    return D


def trace_nd(A, B, aoff: int, trace: np.ndarray, tspace: int) -> int:
    """Accumulate (diffs, b-advance) pairs per tspace panel of A
    (align.c:5207-5353).  ``trace`` is the flat uint accumulation array
    indexed 2*(apos/tspace) relative to the path start (the caller
    pre-offsets).  Returns the difference count."""
    M, N = len(A), len(B)
    if M <= 0:
        y = (aoff // tspace) << 1
        trace[y] += N
        trace[y + 1] += N
        return N
    if N <= 0:
        x = aoff
        y = x // tspace
        x = (y + 1) * tspace - x
        y <<= 1
        s = M
        while s > 0:
            if x > s:
                x = s
            trace[y] += x
            y += 2
            s -= x
            x = tspace
        return M
    D, x, y = split_nd(A, B)
    if D > 1:
        s = aoff
        if (s // tspace + 1) * tspace - s >= x:
            s = (s // tspace) << 1
            trace[s] += (D + 1) // 2
            trace[s + 1] += y
        else:
            trace_nd(A[:x], B[:y], aoff, trace, tspace)
        s = aoff + x
        if (s // tspace + 1) * tspace - s >= M - x:
            s = (s // tspace) << 1
            trace[s] += D // 2
            trace[s + 1] += N - y
        else:
            trace_nd(A[x:], B[y:], aoff + x, trace, tspace)
    else:
        s = x if (D == 0 or M < N) else x - 1
        if s > 0:
            u = aoff
            v = u // tspace
            u = (v + 1) * tspace - u
            v <<= 1
            while s > 0:
                if u > s:
                    u = s
                trace[v + 1] += u
                v += 2
                s -= u
                u = tspace
        if D == 0:
            return D
        if M < N:
            yv = ((aoff + x) // tspace) << 1
        else:
            yv = ((aoff + (x - 1)) // tspace) << 1
        trace[yv] += 1
        if M <= N:
            trace[yv + 1] += 1
        s = M - x
        if s > 0:
            u = aoff + x
            v = u // tspace
            u = (v + 1) * tspace - u
            v <<= 1
            while s > 0:
                if u > s:
                    u = s
                trace[v + 1] += u
                v += 2
                s -= u
                u = tspace
    return D


def compute_alignment(A: np.ndarray, B: np.ndarray, abpos: int, aepos: int,
                      bbpos: int, bepos: int, task: int, tspace: int,
                      mid: Optional[Tuple[int, int]] = None):
    """Compute_Alignment (align.c:5426-5583).

    A/B are full numeric sequences.  Returns per task:
    - DIFF_ONLY:  (diffs, (mida, midb)) — midpoint relative to the
      subproblem, reusable by the PLUS tasks;
    - DIFF_ALIGN/PLUS_ALIGN: (diffs-or-None, signed indel trace list);
    - DIFF_TRACE/PLUS_TRACE: (diffs-or-None, [(diffs, badv), ...]).
    PLUS tasks require the ``mid`` from an immediately preceding
    DIFF_ONLY on the same subproblem and return diffs=None (the
    reference leaves path->diffs untouched there).
    """
    asub = aepos - abpos
    bsub = bepos - bbpos
    Asub = np.asarray(A)[abpos:aepos]
    Bsub = np.asarray(B)[bbpos:bepos]

    if task == DIFF_ONLY:
        if asub <= 0:
            return bsub, (-1, -1)
        if bsub <= 0:
            return asub, (-1, -1)
        D, x, y = split_nd(Asub, Bsub)
        return D, (x, y)

    def _align(parts):
        out: List[int] = []
        for a0, a1, b0, b1 in parts:
            dandc_nd(np.asarray(A)[a0:a1], np.asarray(B)[b0:b1],
                     a0, b0, out)
        return out

    def _tracepts(parts):
        n = 2 * (((aepos + (tspace - 1)) // tspace
                  - abpos // tspace) + 1)
        buf = np.zeros(n, np.int64)
        d = 0

        class _Shift:
            """trace_nd indexes by absolute apos//tspace; the reference
            offsets its pointer (wave.Trace = strace - 2*(abpos/tspace),
            align.c:5505)."""
            def __getitem__(self, i):
                return buf[i - 2 * (abpos // tspace)]

            def __setitem__(self, i, v):
                buf[i - 2 * (abpos // tspace)] = v

        sh = _Shift()
        for a0, a1, b0, b1 in parts:
            d += trace_nd(np.asarray(A)[a0:a1], np.asarray(B)[b0:b1],
                          a0, sh, tspace)
        if buf[n - 1] != 0:  # boundary-insert overflow cell
            buf[n - 3] += buf[n - 1]
            buf[n - 4] += buf[n - 2]
        pairs = [(int(buf[i]), int(buf[i + 1])) for i in range(0, n - 2, 2)]
        return d, pairs

    if task in (PLUS_ALIGN, PLUS_TRACE):
        if mid is None:
            raise ValueError("PLUS tasks need the DIFF_ONLY midpoint")
        x, y = mid
        parts = [(abpos, abpos + x, bbpos, bbpos + y),
                 (abpos + x, aepos, bbpos + y, bepos)]
    else:
        parts = [(abpos, aepos, bbpos, bepos)]

    if task in (PLUS_ALIGN, DIFF_ALIGN):
        out: List[int] = []
        d = 0
        for a0, a1, b0, b1 in parts:
            d += dandc_nd(np.asarray(A)[a0:a1], np.asarray(B)[b0:b1],
                          a0, b0, out)
        return (d if task == DIFF_ALIGN else None), out

    d, pairs = _tracepts(parts)
    return (d if task == DIFF_TRACE else None), pairs
