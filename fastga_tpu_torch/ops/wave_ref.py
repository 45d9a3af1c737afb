# Copied from fastga_tpu/ops/wave_ref.py; imports point at fastga_tpu_torch.
"""Scalar reference implementation of the O(nd) bidirectional wave aligner.

This is the *oracle* for the batched device kernel (ops/wave.py): a faithful
re-expression of the reference's adaptive-wave local aligner semantics
(align.c: forward_wave 352-874, reverse_wave 878-1421, Local_Alignment
1423-1576), structured for clarity rather than speed.

Model: diagonals k = x - y, anti-diagonal c = x + y.  Per live diagonal the
wave keeps the furthest-reaching anti V[k], a 60-bit match-history bitvector
T[k] with popcount M[k] (PATH_LEN window), a trace-point pebble chain HA[k]
laid every `tspace` columns of A, and NA[k] = next A-column mark.  Waves
expand the band by 1/side, prune to within WAVE_LAG of the best reach, stop
when the best has not improved with sufficient match density for TRIM_MLAG
anti-units, and report the *trim point*: the last best point whose trailing
2*TRIM_LEN edit columns are suffix-positive under the bias-corrected score
tables (set_table align.c:207-218, New_Align_Spec 222-268).

Sequences are numeric uint8 arrays; index -1 and len are sentinels (value 4),
mirroring the reference's in-buffer sentinel convention.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

TRIM_LEN = 15
DUB_TRIM = 45
PATH_LEN = 60
PATH_TOP = 1 << PATH_LEN
PATH_INT = PATH_TOP - 1
TRIM_MASK = (1 << TRIM_LEN) - 1
TRIM_MLAG = 250
WAVE_LAG = 70
FRACTION = 1000
U64 = (1 << 64) - 1
INT32_MAX = 0x7FFFFFFF

BIAS_FACTOR = [0.690, 0.690, 0.690, 0.690, 0.780,
               0.850, 0.900, 0.933, 0.966, 1.000]


@dataclass
class AlignSpec:
    """Bias-corrected trim tables (New_Align_Spec align.c:222-268)."""
    ave_corr: float
    trace_space: int = 100
    reach: bool = False
    freq: Tuple[float, float, float, float] = (0.25, 0.25, 0.25, 0.25)
    ave_path: int = field(init=False)
    table: np.ndarray = field(init=False)
    score: np.ndarray = field(init=False)

    def __post_init__(self):
        match = self.freq[0] + self.freq[3]
        if not (match > 0.0) and not (match <= 0.0):
            match = 0.5
        if match > 0.5:
            match = 1.0 - match
        bias = int((match + 0.025) * 20.0 - 1.0)
        if match < 0.2:
            bias = 3
        bf = BIAS_FACTOR[bias]
        self.ave_path = int(PATH_LEN * (1.0 - bf * (1.0 - self.ave_corr)))
        mscore = int(FRACTION * bf * (1.0 - self.ave_corr))
        dscore = FRACTION - mscore
        self.mscore = mscore
        self.dscore = dscore
        table = np.zeros(TRIM_MASK + 1, dtype=np.int16)
        score = np.zeros(TRIM_MASK + 1, dtype=np.int16)
        # iterative version of the reference's set_table recursion:
        # bit 0 processed first lands at the index MSB
        for prefix in range(TRIM_MASK + 1):
            s = 0
            mx = 0
            for bit in range(TRIM_LEN):
                if s > mx:
                    mx = s
                if (prefix >> (TRIM_LEN - 1 - bit)) & 1:
                    s += mscore
                else:
                    s -= dscore
            table[prefix] = s - mx
            score[prefix] = s
        self.table = table
        self.score = score


@dataclass
class Path:
    abpos: int = 0
    bbpos: int = 0
    aepos: int = 0
    bepos: int = 0
    diffs: int = 0
    trace: List[int] = field(default_factory=list)  # (diff-delta, b-delta)*

    @property
    def tlen(self):
        return len(self.trace)


class _Pebbles:
    __slots__ = ("ptr", "diag", "diff", "mark")

    def __init__(self):
        self.ptr: List[int] = []
        self.diag: List[int] = []
        self.diff: List[int] = []
        self.mark: List[int] = []

    def push(self, ptr, diag, diff, mark) -> int:
        self.ptr.append(ptr)
        self.diag.append(diag)
        self.diff.append(diff)
        self.mark.append(mark)
        return len(self.ptr) - 1


def _get(seq: np.ndarray, i: int) -> int:
    """Sentinel-padded access: out-of-range reads return 4."""
    if 0 <= i < len(seq):
        return int(seq[i])
    return 4


def _snake_fwd(A, B, x, k):
    """Extend matches forward from column x on diagonal k; returns new x and
    the terminating characters (bchar, achar)."""
    # vectorized: compare until first mismatch or sentinel
    la, lb = len(A), len(B)
    while True:
        y = x - k
        if y < 0 or y >= lb:
            return x, 4, _get(A, x)
        if x < 0 or x >= la:
            return x, int(B[y]), 4
        lim = min(la - x, lb - y)
        ax = A[x : x + lim]
        bx = B[y : y + lim]
        neq = ax != bx
        if neq.any():
            j = int(np.argmax(neq))
            return x + j, int(bx[j]), int(ax[j])
        x += lim


def _snake_rev(A, B, x, k):
    """Extend matches backward: compares A[x-1] vs B[x-k-1] style."""
    while True:
        xi = x - 1
        yi = x - k - 1
        if yi < 0 or yi >= len(B):
            return x, 4, _get(A, xi)
        if xi < 0 or xi >= len(A):
            return x, int(B[yi]), 4
        lim = min(xi, yi) + 1
        ax = A[xi - lim + 1 : xi + 1][::-1]
        bx = B[yi - lim + 1 : yi + 1][::-1]
        neq = ax != bx
        if neq.any():
            j = int(np.argmax(neq))
            return x - j, int(bx[j]), int(ax[j])
        x -= lim


def forward_wave(spec: AlignSpec, A, B, low, hgh, mida, minp, maxp, aoff,
                 path: Path) -> int:
    """Forward pass; extends path (aepos/bepos/diffs/trace appended).
    Returns the seam diagonal (the reference's ``*mind`` output)."""
    tspace = spec.trace_space
    TABLE, SCORE, PATH_AVE = spec.table, spec.score, spec.ave_path
    REACH = spec.reach

    V, T, M, HA, NA = {}, {}, {}, {}, {}
    cells = _Pebbles()

    more = True
    aclip, bclip = INT32_MAX, -INT32_MAX
    besta = trima = morea = lasta = mida
    bestx = trimx = morex = (mida + hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    morem = -1
    dif = 0

    # wave 0
    for k in range(hgh, low - 1, -1):
        x = (mida + k) >> 1
        na = ((x + (tspace - aoff)) // tspace - 1) * tspace + aoff
        ha = cells.push(-1, k, 0, na)
        na += tspace
        x, bc, ac_ = _snake_fwd(A, B, x, k)
        if bc == 4:
            more = False
            if bclip < k:
                bclip = k
        elif ac_ == 4:
            more = False
            aclip = k
        c = (x << 1) - k
        while x >= na:
            ha = cells.push(ha, k, 0, na)
            na += tspace
        if c > besta:
            besta = trima = lasta = c
            bestx = trimx = x
            trimha = ha
        V[k], T[k], M[k], HA[k], NA[k] = c, PATH_INT, PATH_LEN, ha, na

    if not more:
        if _get(B, besta - bestx) != 4 and _get(A, bestx) != 4:
            more = True
        if hgh >= aclip:
            hgh = aclip - 1
            if morem <= M[aclip]:
                morem, morea = M[aclip], V[aclip]
                morex = (morea + aclip) >> 1
                moreha = HA[aclip]
        if low <= bclip:
            low = bclip + 1
            if morem <= M[bclip]:
                morem, morea = M[bclip], V[bclip]
                morex = (morea + bclip) >> 1
                moreha = HA[bclip]
        aclip, bclip = INT32_MAX, -INT32_MAX

    while more and lasta >= besta - TRIM_MLAG:
        low -= 1
        hgh += 1
        if low >= minp:
            NA[low] = NA[low + 1]
            V[low] = -1
        else:
            low += 1
        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            V[hgh] = am = -1
        else:
            hgh -= 1
            am = V[hgh]
        dif += 1

        ac = -1  # V[hgh+1] barrier
        t, n, ua = PATH_INT, PATH_LEN, -1
        for k in range(hgh, low - 1, -1):
            ap = ac
            ac = am
            d = k - 1
            am = V[d] if d >= low else -1

            if ac < am:
                if am < ap:
                    c, m, b, ha = ap + 1, n, t, ua
                else:
                    c, m, b, ha = am + 1, M[d], T[d], HA[d]
            else:
                if ac < ap:
                    c, m, b, ha = ap + 1, n, t, ua
                else:
                    c, m, b, ha = (ac + 2, M.get(k, PATH_LEN),
                                   T.get(k, PATH_INT), HA.get(k, -1))

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & U64

            x = (c + k) >> 1
            x2, bc, ac_ = _snake_fwd(A, B, x, k)
            # replay bit effects of the matched run
            for _ in range(x2 - x):
                if not (b & PATH_TOP):
                    m += 1
                b = ((b << 1) | 1) & U64
            x = x2
            if bc == 4:
                more = False
                if bclip < k:
                    bclip = k
            elif ac_ == 4:
                more = False
                aclip = k
            c = (x << 1) - k

            while x >= NA[k]:
                if cells.mark[ha] < NA[k]:
                    ha = cells.push(ha, k, dif, NA[k])
                NA[k] += tspace

            if c > besta:
                besta, bestx = c, x
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + \
                       SCORE[b & TRIM_MASK] >= 0:
                        trima, trimx, trimd, trimha = c, x, dif, ha

            # fresh band-edge cells may be read-but-never-used
            # (the reference reads stale memory here, align.c:745-749)
            t = T.get(k, PATH_INT)
            n = M.get(k, PATH_LEN)
            ua = HA.get(k, -1)
            V[k], T[k], M[k], HA[k] = c, b, m, ha

        if not more:
            if _get(B, besta - bestx) != 4 and _get(A, bestx) != 4:
                more = True
            if hgh >= aclip:
                hgh = aclip - 1
                if morem <= M[aclip]:
                    morem, morea = M[aclip], V[aclip]
                    morex = (morea + aclip) >> 1
                    mored = dif
                    moreha = HA[aclip]
            if low <= bclip:
                low = bclip + 1
                if morem <= M[bclip]:
                    morem, morea = M[bclip], V[bclip]
                    morex = (morea + bclip) >> 1
                    mored = dif
                    moreha = HA[bclip]
            aclip, bclip = INT32_MAX, -INT32_MAX

        nthr = besta - WAVE_LAG
        while hgh >= low:
            if V[hgh] < nthr:
                hgh -= 1
            else:
                while V[low] < nthr:
                    low += 1
                break

    # trace assembly (align.c:805-870)
    if morem >= 0 and REACH:
        trimx, trimy, trimd, trimha = morex, morea - morex, mored, moreha
    else:
        trimy = trima - trimx

    chain = []
    h = trimha
    while h >= 0:
        chain.append(h)
        h = cells.ptr[h]
    chain.reverse()

    h = chain[0]
    k = cells.diag[h]
    b = (mida - k) >> 1
    e = 0
    seam = k
    for h in chain[1:]:
        k = cells.diag[h]
        a = cells.mark[h] - k
        d = cells.diff[h]
        path.trace.append((d - e, a - b))
        b, e = a, d
    if b + k != trimx:
        path.trace.append((trimd - e, trimy - b))
    elif b != trimy:
        de, ab = path.trace[-1]
        path.trace[-1] = (de + (trimd - e), ab + (trimy - b))

    path.aepos = trimx
    path.bepos = trimy
    path.diffs = trimd
    return seam


def reverse_wave(spec: AlignSpec, A, B, mind, maxd, mida, minp, maxp, aoff,
                 path: Path):
    """Reverse pass; sets abpos/bbpos, prepends trace, adds diffs."""
    tspace = spec.trace_space
    TABLE, SCORE, PATH_AVE = spec.table, spec.score, spec.ave_path
    REACH = spec.reach

    V, T, M, HA, NA = {}, {}, {}, {}, {}
    cells = _Pebbles()

    low, hgh = mind, maxd
    more = True
    aclip, bclip = -INT32_MAX, INT32_MAX
    besta = trima = morea = lasta = mida
    bestx = trimx = morex = (mida + hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    morem = -1
    dif = 0

    for k in range(low, hgh + 1):
        x = (mida + k) >> 1
        na = ((x + (tspace - aoff) - 1) // tspace - 1) * tspace + aoff
        ha = cells.push(-1, k, 0, x)
        x, bc, ac_ = _snake_rev(A, B, x, k)
        if bc == 4:
            more = False
            if bclip > k:
                bclip = k
        elif ac_ == 4:
            more = False
            aclip = k
        c = (x << 1) - k
        while x <= na:
            ha = cells.push(ha, k, 0, na)
            na -= tspace
        if c < besta:
            besta = trima = lasta = c
            bestx = trimx = x
            trimha = ha
        V[k], T[k], M[k], HA[k], NA[k] = c, PATH_INT, PATH_LEN, ha, na

    if not more:
        if _get(B, besta - bestx - 1) != 4 and _get(A, bestx - 1) != 4:
            more = True
        if low <= aclip:
            low = aclip + 1
            if morem <= M[aclip]:
                morem, morea = M[aclip], V[aclip]
                morex = (morea + aclip) >> 1
                moreha = HA[aclip]
        if hgh >= bclip:
            hgh = bclip - 1
            if morem <= M[bclip]:
                morem, morea = M[bclip], V[bclip]
                morex = (morea + bclip) >> 1
                moreha = HA[bclip]
        aclip, bclip = -INT32_MAX, INT32_MAX

    while more and lasta <= besta + TRIM_MLAG:
        low -= 1
        hgh += 1
        if low >= minp:
            NA[low] = NA[low + 1]
            V[low] = ap = INT32_MAX
        else:
            low += 1
            ap = V[low]
        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            V[hgh] = INT32_MAX
        else:
            hgh -= 1
        dif += 1

        ac = INT32_MAX  # V[low-1] barrier
        t, n, ua = PATH_INT, PATH_LEN, -1
        for k in range(low, hgh + 1):
            am = ac
            ac = ap
            d = k + 1
            ap = V[d] if d <= hgh else INT32_MAX

            if ac > ap:
                if ap > am:
                    c, m, b, ha = am - 1, n, t, ua
                else:
                    c, m, b, ha = ap - 1, M[d], T[d], HA[d]
            else:
                if ac > am:
                    c, m, b, ha = am - 1, n, t, ua
                else:
                    c, m, b, ha = (ac - 2, M.get(k, PATH_LEN),
                                   T.get(k, PATH_INT), HA.get(k, -1))

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & U64

            x = (c + k) >> 1
            x2, bc, ac_ = _snake_rev(A, B, x, k)
            for _ in range(x - x2):
                if not (b & PATH_TOP):
                    m += 1
                b = ((b << 1) | 1) & U64
            x = x2
            if bc == 4:
                more = False
                if bclip > k:
                    bclip = k
            elif ac_ == 4:
                more = False
                aclip = k
            c = (x << 1) - k

            while x <= NA[k]:
                if cells.mark[ha] > NA[k]:
                    ha = cells.push(ha, k, dif, NA[k])
                NA[k] -= tspace

            if c < besta:
                besta, bestx = c, x
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + \
                       SCORE[b & TRIM_MASK] >= 0:
                        trima, trimx, trimd, trimha = c, x, dif, ha

            # fresh band-edge cells may be read-but-never-used
            # (the reference reads stale memory here, align.c:745-749)
            t = T.get(k, PATH_INT)
            n = M.get(k, PATH_LEN)
            ua = HA.get(k, -1)
            V[k], T[k], M[k], HA[k] = c, b, m, ha

        if not more:
            if _get(B, besta - bestx - 1) != 4 and _get(A, bestx - 1) != 4:
                more = True
            if low <= aclip:
                low = aclip + 1
                if morem <= M[aclip]:
                    morem, morea = M[aclip], V[aclip]
                    morex = (morea + aclip) >> 1
                    mored = dif
                    moreha = HA[aclip]
            if hgh >= bclip:
                hgh = bclip - 1
                if morem <= M[bclip]:
                    morem, morea = M[bclip], V[bclip]
                    morex = (morea + bclip) >> 1
                    mored = dif
                    moreha = HA[bclip]
            aclip, bclip = -INT32_MAX, INT32_MAX

        nthr = besta + WAVE_LAG
        while hgh >= low:
            if V[hgh] > nthr:
                hgh -= 1
            else:
                while V[low] > nthr:
                    low += 1
                break

    # trace assembly (align.c:1325-1414); prepends to path.trace
    if morem >= 0 and REACH:
        trimx, trimy, trimd, trimha = morex, morea - morex, mored, moreha
    else:
        trimy = trima - trimx

    chain = []
    h = trimha
    while h >= 0:
        chain.append(h)
        h = cells.ptr[h]
    chain.reverse()

    pre = []
    hpos = 0
    h = chain[hpos]
    k = cells.diag[h]
    b = cells.mark[h] - k
    e = 0
    if (b + k) % tspace != aoff:
        hpos += 1
        if hpos >= len(chain):
            a, d = trimy, trimd
            hh = -1
        else:
            hh = chain[hpos]
            k = cells.diag[hh]
            a = cells.mark[hh] - k
            d = cells.diff[hh]
        if path.tlen == 0:
            pre.append((d - e, b - a))
        else:
            de, ab = path.trace[0]
            path.trace[0] = (de + (d - e), ab + (b - a))
        b, e = a, d
        if hpos >= len(chain):
            chain = []
        else:
            chain = chain[hpos:]
    if chain:
        for h in chain[1:]:
            k = cells.diag[h]
            a = cells.mark[h] - k
            d = cells.diff[h]
            pre.append((d - e, b - a))
            b, e = a, d
        if b + k != trimx:
            pre.append((trimd - e, b - trimy))
        elif b != trimy:
            de, ab = pre[-1] if pre else path.trace[0]
            if pre:
                pre[-1] = (de + (trimd - e), ab + (b - trimy))
            else:
                path.trace[0] = (de + (trimd - e), ab + (b - trimy))

    # pre was built walking *backward* in A; prepend reversed
    path.trace[:0] = pre[::-1]
    path.abpos = trimx
    path.bbpos = trimy
    path.diffs += trimd


def local_alignment(spec: AlignSpec, A, B, low, hgh, anti,
                    lbord: int = -1, hbord: int = -1,
                    selfie: bool = False, acomp: bool = False,
                    alen: Optional[int] = None,
                    blen: Optional[int] = None) -> Path:
    """Local_Alignment (align.c:1423-1576): bidirectional wave from the
    anti-diagonal ``anti`` between diagonals [low, hgh]."""
    alen = len(A) if alen is None else alen
    blen = len(B) if blen is None else blen
    path = Path()

    while ((anti - hgh) >> 1) < 0:
        hgh -= 1

    if lbord < 0:
        minp = 1 if (selfie and low >= 0) else -INT32_MAX
    else:
        minp = low - lbord
    if hbord < 0:
        maxp = -1 if (selfie and hgh <= 0) else INT32_MAX
    else:
        maxp = hgh + hbord

    aoff = alen % spec.trace_space if acomp else 0

    seam = forward_wave(spec, A, B, low, hgh, anti, minp, maxp, aoff, path)
    fshort = (path.aepos + path.bepos) - anti < DUB_TRIM

    reverse_wave(spec, A, B, seam, seam, anti, minp, maxp, aoff, path)
    rshort = anti - (path.abpos + path.bbpos) < DUB_TRIM

    if fshort:
        if rshort:
            path.aepos = path.abpos = (path.abpos + path.aepos) >> 1
            path.bepos = path.bbpos = (path.bbpos + path.bepos) >> 1
            path.trace = []
        else:
            low2 = path.abpos - path.bbpos
            anti2 = path.abpos + path.bbpos
            path.trace = []
            forward_wave(spec, A, B, low2, low2, anti2, minp, maxp, aoff,
                         path)
    else:
        if rshort:
            low2 = path.aepos - path.bepos
            anti2 = path.aepos + path.bepos
            path.trace = []
            path.diffs = 0
            reverse_wave(spec, A, B, low2, low2, anti2, minp, maxp, aoff,
                         path)

    if acomp:
        i = path.abpos
        path.abpos = alen - path.aepos
        path.aepos = alen - i
        i = path.bbpos
        path.bbpos = blen - path.bepos
        path.bepos = blen - i
        path.trace.reverse()

    return path


def find_extension(spec: AlignSpec, A, B, diag: int, anti: int,
                   lbord: int = -1, hbord: int = -1,
                   prefix: bool = False) -> Path:
    """Find_Extension (align.c:3774-3858): one-sided local alignment
    from the point ((anti+diag)/2, (anti-diag)/2).

    ``prefix`` extends left (reverse wave) and fills abpos/bbpos; else
    right (forward wave) filling aepos/bepos.  The reference's
    forward/reverse_extend are forward/reverse_wave specialised to a
    single start diagonal, aoff=0, and reach-mode on (align.c diff
    2714-3233 vs 352-877), so this delegates to those.
    """
    rspec = spec if spec.reach else AlignSpec(
        spec.ave_corr, spec.trace_space, True, spec.freq)
    minp = -INT32_MAX if lbord < 0 else diag - lbord
    maxp = INT32_MAX if hbord < 0 else diag + hbord
    path = Path()
    if prefix:
        reverse_wave(rspec, A, B, diag, diag, anti, minp, maxp, 0, path)
        path.aepos = (anti + diag) >> 1
        path.bepos = (anti - diag) >> 1
    else:
        forward_wave(rspec, A, B, diag, diag, anti, minp, maxp, 0, path)
        path.abpos = (anti + diag) >> 1
        path.bbpos = (anti - diag) >> 1
    return path


# ---------------------------------------------------------------------------
# Wrap-around alignment (align.c:1585-2712): align B against A* = A
# repeated with period P (FasTAN tandem-repeat support)
# ---------------------------------------------------------------------------


def _ctrunc_div(x: int, P: int) -> int:
    """C-style truncating division (reference uses int division on
    possibly negative wrap coordinates)."""
    q = abs(x) // P
    return q if x >= 0 else -q


def _cmod(x: int, P: int) -> int:
    return x % P if x >= 0 else -((-x) % P)


def _snake_fwd_wrap(A, B, x, k, P):
    """Forward match run of B[x-k..] against A* (A wrapped with period
    P, align.c:1690-1706).  For x < 0 the reference's C trunc-mod makes
    aseq[p] read the leading pad byte (4), which matches B's own pad —
    the same boundary quirk as the reverse direction."""
    lb = len(B)
    while True:
        y = x - k
        if x < 0 or y < 0 or y >= lb:
            bchar = _get(B, y)
            achar = _get(A, _cmod(x, P)) if x < 0 else int(A[x % P])
            if achar != bchar:
                return x, bchar
            x += 1
            continue
        p = x % P
        lim = min(P - p, lb - y)
        ax = A[p:p + lim]
        bx = B[y:y + lim]
        neq = ax != bx
        if neq.any():
            j = int(np.argmax(neq))
            return x + j, int(bx[j])
        x += lim


def _snake_rev_wrap(A, B, x, k, P):
    """Backward match run against periodic A*.  Mirrors the reference's
    cyclic index walk (align.c:2100-2115) including its boundary quirk:
    aseq is shifted by one, so p == 0 compares A's leading pad byte (4)
    — which MATCHES B's own pad (4 == 4) and lets the alignment step one
    column past the B start, exactly as the reference does with its
    sentinel-padded contig buffers."""
    p = x % P              # floor mod: cyclic walk continues below 0
    while True:
        bchar = _get(B, x - k - 1)
        if _get(A, p - 1) != bchar:
            return x, bchar
        x -= 1
        if p == 0:
            p = P
        p -= 1


def forward_wrap(spec: AlignSpec, A, B, low, hgh, mida, minp, maxp, P,
                 path: Path) -> int:
    """Wrap-around forward pass: B against A*=A repeated with period P
    (align.c forward_wrap 1585-2078; trace marks every P).  Returns the
    seam diagonal."""
    tspace = P
    TABLE, SCORE, PATH_AVE = spec.table, spec.score, spec.ave_path
    REACH = spec.reach

    V, T, M, HA, NA = {}, {}, {}, {}, {}
    cells = _Pebbles()

    more = True
    aclip, bclip = INT32_MAX, -INT32_MAX
    besta = trima = morea = lasta = mida
    bestx = trimx = morex = (mida + hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    morem = -1
    dif = 0

    # wave 0
    for k in range(hgh, low - 1, -1):
        x = (mida + k) >> 1
        na = _ctrunc_div(x, P) * P
        ha = cells.push(-1, k, 0, na)
        na += tspace
        x, bc = _snake_fwd_wrap(A, B, x, k, P)
        ac_ = 0
        if bc == 4:
            more = False
            if bclip < k:
                bclip = k
        elif ac_ == 4:
            more = False
            aclip = k
        c = (x << 1) - k
        while x >= na:
            ha = cells.push(ha, k, 0, na)
            na += tspace
        if c > besta:
            besta = trima = lasta = c
            bestx = trimx = x
            trimha = ha
        V[k], T[k], M[k], HA[k], NA[k] = c, PATH_INT, PATH_LEN, ha, na

    if not more:
        more = _get(B, besta - bestx) != 4
        if low <= bclip:
            low = bclip + 1
            if morem <= M[bclip]:
                morem, morea = M[bclip], V[bclip]
                morex = (morea + bclip) >> 1
                moreha = HA[bclip]
        aclip, bclip = INT32_MAX, -INT32_MAX

    while more and lasta >= besta - TRIM_MLAG:
        low -= 1
        hgh += 1
        if low >= minp:
            NA[low] = NA[low + 1]
            V[low] = -1
        else:
            low += 1
        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            V[hgh] = am = -1
        else:
            hgh -= 1
            am = V[hgh]
        dif += 1

        ac = -1  # V[hgh+1] barrier
        t, n, ua = PATH_INT, PATH_LEN, -1
        for k in range(hgh, low - 1, -1):
            ap = ac
            ac = am
            d = k - 1
            am = V[d] if d >= low else -1

            if ac < am:
                if am < ap:
                    c, m, b, ha = ap + 1, n, t, ua
                else:
                    c, m, b, ha = am + 1, M[d], T[d], HA[d]
            else:
                if ac < ap:
                    c, m, b, ha = ap + 1, n, t, ua
                else:
                    c, m, b, ha = (ac + 2, M.get(k, PATH_LEN),
                                   T.get(k, PATH_INT), HA.get(k, -1))

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & U64

            x = (c + k) >> 1
            x2, bc = _snake_fwd_wrap(A, B, x, k, P)
            ac_ = 0
            # replay bit effects of the matched run
            for _ in range(x2 - x):
                if not (b & PATH_TOP):
                    m += 1
                b = ((b << 1) | 1) & U64
            x = x2
            if bc == 4:
                more = False
                if bclip < k:
                    bclip = k
            elif ac_ == 4:
                more = False
                aclip = k
            c = (x << 1) - k

            while x >= NA[k]:
                if cells.mark[ha] < NA[k]:
                    ha = cells.push(ha, k, dif, NA[k])
                NA[k] += tspace

            if c > besta:
                besta, bestx = c, x
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + \
                       SCORE[b & TRIM_MASK] >= 0:
                        trima, trimx, trimd, trimha = c, x, dif, ha

            # fresh band-edge cells may be read-but-never-used
            # (the reference reads stale memory here, align.c:745-749)
            t = T.get(k, PATH_INT)
            n = M.get(k, PATH_LEN)
            ua = HA.get(k, -1)
            V[k], T[k], M[k], HA[k] = c, b, m, ha

        if not more:
            more = _get(B, besta - bestx) != 4
            if low <= bclip:
                low = bclip + 1
                if morem <= M[bclip]:
                    morem, morea = M[bclip], V[bclip]
                    morex = (morea + bclip) >> 1
                    mored = dif
                    moreha = HA[bclip]
            aclip, bclip = INT32_MAX, -INT32_MAX

        nthr = besta - WAVE_LAG
        while hgh >= low:
            if V[hgh] < nthr:
                hgh -= 1
            else:
                while V[low] < nthr:
                    low += 1
                break

    # trace assembly (align.c:805-870)
    if morem >= 0:
        trimx, trimy, trimd, trimha = morex, morea - morex, mored, moreha
    else:
        trimy = trima - trimx

    chain = []
    h = trimha
    while h >= 0:
        chain.append(h)
        h = cells.ptr[h]
    chain.reverse()

    h = chain[0]
    k = cells.diag[h]
    b = (mida - k) >> 1
    e = 0
    seam = k
    for h in chain[1:]:
        k = cells.diag[h]
        a = cells.mark[h] - k
        d = cells.diff[h]
        path.trace.append((d - e, a - b))
        b, e = a, d
    if b + k != trimx:
        path.trace.append((trimd - e, trimy - b))
    elif b != trimy:
        de, ab = path.trace[-1]
        path.trace[-1] = (de + (trimd - e), ab + (trimy - b))

    path.aepos = trimx
    path.bepos = trimy
    path.diffs = trimd
    return seam


def reverse_wrap(spec: AlignSpec, A, B, mind, maxd, mida, minp, maxp, P,
                 path: Path):
    """Wrap-around reverse pass (align.c reverse_wrap 2079-2593)."""
    tspace = P
    TABLE, SCORE, PATH_AVE = spec.table, spec.score, spec.ave_path
    REACH = spec.reach

    V, T, M, HA, NA = {}, {}, {}, {}, {}
    cells = _Pebbles()

    low, hgh = mind, maxd
    more = True
    aclip, bclip = -INT32_MAX, INT32_MAX
    besta = trima = morea = lasta = mida
    bestx = trimx = morex = (mida + hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    morem = -1
    dif = 0

    for k in range(low, hgh + 1):
        x = (mida + k) >> 1
        na = _ctrunc_div(x, P) * P
        ha = cells.push(-1, k, 0, x)
        x, bc = _snake_rev_wrap(A, B, x, k, P)
        ac_ = 0
        if bc == 4:
            more = False
            if bclip > k:
                bclip = k
        elif ac_ == 4:
            more = False
            aclip = k
        c = (x << 1) - k
        while x <= na:
            ha = cells.push(ha, k, 0, na)
            na -= tspace
        if c < besta:
            besta = trima = lasta = c
            bestx = trimx = x
            trimha = ha
        V[k], T[k], M[k], HA[k], NA[k] = c, PATH_INT, PATH_LEN, ha, na

    if not more:
        more = _get(B, besta - bestx - 1) != 4
        if hgh >= bclip:
            hgh = bclip - 1
            if morem <= M[bclip]:
                morem, morea = M[bclip], V[bclip]
                morex = (morea + bclip) >> 1
                moreha = HA[bclip]
        aclip, bclip = -INT32_MAX, INT32_MAX

    while more and lasta <= besta + TRIM_MLAG:
        low -= 1
        hgh += 1
        if low >= minp:
            NA[low] = NA[low + 1]
            V[low] = ap = INT32_MAX
        else:
            low += 1
            ap = V[low]
        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            V[hgh] = INT32_MAX
        else:
            hgh -= 1
        dif += 1

        ac = INT32_MAX  # V[low-1] barrier
        t, n, ua = PATH_INT, PATH_LEN, -1
        for k in range(low, hgh + 1):
            am = ac
            ac = ap
            d = k + 1
            ap = V[d] if d <= hgh else INT32_MAX

            if ac > ap:
                if ap > am:
                    c, m, b, ha = am - 1, n, t, ua
                else:
                    c, m, b, ha = ap - 1, M[d], T[d], HA[d]
            else:
                if ac > am:
                    c, m, b, ha = am - 1, n, t, ua
                else:
                    c, m, b, ha = (ac - 2, M.get(k, PATH_LEN),
                                   T.get(k, PATH_INT), HA.get(k, -1))

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & U64

            x = (c + k) >> 1
            x2, bc = _snake_rev_wrap(A, B, x, k, P)
            ac_ = 0
            for _ in range(x - x2):
                if not (b & PATH_TOP):
                    m += 1
                b = ((b << 1) | 1) & U64
            x = x2
            if bc == 4:
                more = False
                if bclip > k:
                    bclip = k
            elif ac_ == 4:
                more = False
                aclip = k
            c = (x << 1) - k

            while x <= NA[k]:
                if cells.mark[ha] > NA[k]:
                    ha = cells.push(ha, k, dif, NA[k])
                NA[k] -= tspace

            if c < besta:
                besta, bestx = c, x
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + \
                       SCORE[b & TRIM_MASK] >= 0:
                        trima, trimx, trimd, trimha = c, x, dif, ha

            # fresh band-edge cells may be read-but-never-used
            # (the reference reads stale memory here, align.c:745-749)
            t = T.get(k, PATH_INT)
            n = M.get(k, PATH_LEN)
            ua = HA.get(k, -1)
            V[k], T[k], M[k], HA[k] = c, b, m, ha

        if not more:
            more = _get(B, besta - bestx - 1) != 4
            if hgh >= bclip:
                hgh = bclip - 1
                if morem <= M[bclip]:
                    morem, morea = M[bclip], V[bclip]
                    morex = (morea + bclip) >> 1
                    mored = dif
                    moreha = HA[bclip]
            aclip, bclip = -INT32_MAX, INT32_MAX

        nthr = besta + WAVE_LAG
        while hgh >= low:
            if V[hgh] > nthr:
                hgh -= 1
            else:
                while V[low] > nthr:
                    low += 1
                break

    # trace assembly (align.c:1325-1414); prepends to path.trace
    if morem >= 0:
        trimx, trimy, trimd, trimha = morex, morea - morex, mored, moreha
    else:
        trimy = trima - trimx

    chain = []
    h = trimha
    while h >= 0:
        chain.append(h)
        h = cells.ptr[h]
    chain.reverse()

    pre = []
    hpos = 0
    h = chain[hpos]
    k = cells.diag[h]
    b = cells.mark[h] - k
    e = 0
    if (b + k) % tspace != 0:
        hpos += 1
        if hpos >= len(chain):
            a, d = trimy, trimd
            hh = -1
        else:
            hh = chain[hpos]
            k = cells.diag[hh]
            a = cells.mark[hh] - k
            d = cells.diff[hh]
        if path.tlen == 0:
            pre.append((d - e, b - a))
        else:
            de, ab = path.trace[0]
            path.trace[0] = (de + (d - e), ab + (b - a))
        b, e = a, d
        if hpos >= len(chain):
            chain = []
        else:
            chain = chain[hpos:]
    if chain:
        for h in chain[1:]:
            k = cells.diag[h]
            a = cells.mark[h] - k
            d = cells.diff[h]
            pre.append((d - e, b - a))
            b, e = a, d
        if b + k != trimx:
            pre.append((trimd - e, b - trimy))
        elif b != trimy:
            de, ab = pre[-1] if pre else path.trace[0]
            if pre:
                pre[-1] = (de + (trimd - e), ab + (b - trimy))
            else:
                path.trace[0] = (de + (trimd - e), ab + (b - trimy))

    # pre was built walking *backward* in A; prepend reversed
    path.trace[:0] = pre[::-1]
    path.abpos = trimx
    path.bbpos = trimy
    path.diffs += trimd




def wrap_around_alignment(spec: AlignSpec, A, B, low, hgh, anti,
                          lbord: int = -1, hbord: int = -1) -> Path:
    """Wrap_Around_Alignment (align.c:2594-2712): local alignment of B
    against A-wrapped (tandem array), same interface/return conventions
    as local_alignment; path A coordinates live in A* space (may exceed
    len(A))."""
    alen = len(A)
    path = Path()

    while ((anti - hgh) >> 1) < 0:
        hgh -= 1

    minp = -INT32_MAX if lbord < 0 else low - lbord
    maxp = INT32_MAX if hbord < 0 else hgh + hbord

    seam = forward_wrap(spec, A, B, low, hgh, anti, minp, maxp, alen, path)
    fshort = (path.aepos + path.bepos) - anti < DUB_TRIM

    reverse_wrap(spec, A, B, seam, seam, anti, minp, maxp, alen, path)
    rshort = anti - (path.abpos + path.bbpos) < DUB_TRIM

    if fshort:
        if rshort:
            path.aepos = path.abpos = (path.abpos + path.aepos) >> 1
            path.bepos = path.bbpos = (path.bbpos + path.bepos) >> 1
            path.trace = []
        else:
            low2 = path.abpos - path.bbpos
            anti2 = path.abpos + path.bbpos
            path.trace = []
            forward_wrap(spec, A, B, low2, low2, anti2, minp, maxp, alen,
                         path)
    else:
        if rshort:
            low2 = path.aepos - path.bepos
            anti2 = path.aepos + path.bepos
            path.trace = []
            path.diffs = 0
            reverse_wrap(spec, A, B, low2, low2, anti2, minp, maxp, alen,
                         path)

    return path
