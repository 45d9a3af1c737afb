# Copied from fastga_tpu/ops/merge.py; imports point at fastga_tpu_torch.
"""Adaptamer seed merge: two sorted GIX tables -> seed pairs, as array ops.

Clean-room re-formulation of the reference's cache-walking automaton
(new_merge_thread FastGA.c:610-1025).  Derived spec:

For each *forward* entry x of T1 (A-strand restricted to forward because
canonical k-mers appear in both orientations, FastGA.c:916-928):

  plen(x) = max over T2 entries y of lcp(x, y)   [in bases, <= KMER]
  M(x)    = { y : lcp(x, y) == plen(x) }          (contiguous in sorted T2)

- If the two tables share no 24-bit prefix panel at x, x yields nothing
  (the automaton skips whole panels, FastGA.c:726-737).
- If |M(x)| >= FREQ the k-mer is too frequent: no seeds (FastGA.c:796-823,
  ``hgh >= top`` with top = low + FREQ entries).
- x is skipped when its masked-prefix byte >= mlen; members y of M(x)
  with mask byte >= mlen are skipped individually (FastGA.c:824-832,
  860-863).  mlen = KMER+1 normally, plen(x) under soft-mask mode.
- Each surviving (x, y) emits seed (plen, A-post/cont, B-post/cont, bcomp).

Vector formulation: a single lexsort ranks T1-forward entries into T2
(insertion points), plen comes from the two nearest T2 neighbours, and the
run M(x) is recovered from T2's adjacent-LCP array with cumulative ANDs over
a +-FREQ window (|M| >= FREQ is skipped anyway, so the window is bounded).
This maps 1:1 onto the TPU pipeline (sort + gather + segment ops).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..io.gix import GixTable
from .constants import LCPB


@dataclass
class SeedBatch:
    """Seed pairs between genome A (GIX 1) and genome B (GIX 2).

    Posts/conts use GIX conventions: cont = descending-length rank;
    post = k-mer start for forward entries, exclusive end for rc entries.
    The A side is always forward.
    """
    plen: np.ndarray    # uint8 — adaptamer match length in bases
    acont: np.ndarray   # int32
    apost: np.ndarray   # int32
    bcont: np.ndarray   # int32
    bpost: np.ndarray   # int32
    bcomp: np.ndarray   # bool — B entry is reverse-complement

    @property
    def n(self) -> int:
        return len(self.plen)

    def __len__(self):
        return self.n


def _row_lcp(a: np.ndarray, b: np.ndarray, kmer: int) -> np.ndarray:
    """Base-level LCP between paired rows of k-mer byte matrices."""
    n = len(a)
    if n == 0:
        return np.zeros(0, dtype=np.int32)
    neq = a != b
    anydiff = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    r = np.arange(n)
    xorb = a[r, first] ^ b[r, first]
    return np.where(anydiff, 4 * first + LCPB[xorb], kmer).astype(np.int32)


def adaptamer_seeds(t1: GixTable, t2: GixTable, freq: int = 10,
                    soft_mask: bool = False,
                    chunk: int = 1 << 20) -> SeedBatch:
    """Compute all adaptamer seeds between two GIX tables (host numpy)."""
    kmer = t1.kmer
    assert t2.kmer == kmer

    fwd_idx = np.flatnonzero(~t1.comp)
    out = []
    for lo in range(0, len(fwd_idx), chunk):
        sel = fwd_idx[lo : lo + chunk]
        out.append(_merge_chunk(t1, t2, sel, freq, soft_mask))
    if not out:
        z = np.zeros(0, dtype=np.int32)
        return SeedBatch(z.astype(np.uint8), z, z, z, z, z.astype(bool))
    return SeedBatch(*[np.concatenate([o[k] for o in out])
                       for k in range(6)])


def _merge_chunk(t1: GixTable, t2: GixTable, sel: np.ndarray,
                 freq: int, soft_mask: bool):
    kmer = t1.kmer
    n2 = t2.n
    k1 = t1.kbytes[sel]

    # insertion points of k1 rows into t2's sorted k-mers: binary search
    # over cached 80-bit complex keys for both tables
    if t1.kbytes.shape[1] <= 10:
        ins = np.searchsorted(_table_halves(t2), _table_halves(t1)[sel],
                              side="left").astype(np.int64)
    else:
        ins = _rank_into(k1, t2.kbytes, _table_halves(t2))

    # nearest-neighbour lcps
    pred_ok = ins > 0
    succ_ok = ins < n2
    pred_rows = t2.kbytes[np.clip(ins - 1, 0, max(n2 - 1, 0))]
    succ_rows = t2.kbytes[np.clip(ins, 0, max(n2 - 1, 0))]
    lcp_pred = np.where(pred_ok, _row_lcp(k1, pred_rows, kmer), -1)
    lcp_succ = np.where(succ_ok, _row_lcp(k1, succ_rows, kmer), -1)
    plen = np.maximum(lcp_pred, lcp_succ)

    # panels with no 12-base (24-bit prefix) overlap produce nothing
    alive = plen >= 12

    # run extents via T2 adjacent-lcp window, capped at freq each side
    F = freq
    m = len(sel)
    l2 = np.minimum(t2.lcp.astype(np.int32), kmer)  # 40 marker == kmer

    # upward: y = ins + u shares plen iff lcp_succ >= plen and
    #         l2[ins+1 .. ins+u] all >= plen
    up_ok = np.zeros((m, F), dtype=bool)
    if n2:
        cond = lcp_succ >= plen
        up_ok[:, 0] = cond & succ_ok & alive
        for u in range(1, F):
            j = ins + u
            okj = j < n2
            lj = l2[np.clip(j, 0, n2 - 1)]
            up_ok[:, u] = up_ok[:, u - 1] & okj & (lj >= plen)
    # downward: y = ins-1-d
    down_ok = np.zeros((m, F), dtype=bool)
    if n2:
        cond = lcp_pred >= plen
        down_ok[:, 0] = cond & pred_ok & alive
        for d in range(1, F):
            j = ins - d  # l2[j] = lcp(T2[j-1], T2[j]) gates step to ins-1-d
            okj = j - 1 >= 0
            lj = l2[np.clip(j, 0, n2 - 1)]
            down_ok[:, d] = down_ok[:, d - 1] & okj & (lj >= plen)

    count = up_ok.sum(axis=1) + down_ok.sum(axis=1)
    # the window caps at F per side; if either side is saturated the run may
    # extend further, but then count >= F already -> skipped either way
    alive &= count < freq
    # overflow check: if both sides saturated we'd undercount, but
    # F + F >= freq always holds since F == freq

    mlen = np.where(soft_mask, plen, kmer + 1)
    alive &= t1.maskb[sel] < mlen

    emit_up = up_ok & alive[:, None]
    emit_dn = down_ok & alive[:, None]
    y_up = ins[:, None] + np.arange(F)[None, :]
    y_dn = ins[:, None] - 1 - np.arange(F)[None, :]

    ys = np.concatenate([y_up[emit_up], y_dn[emit_dn]])
    xs = np.concatenate([
        np.broadcast_to(sel[:, None], (m, F))[emit_up],
        np.broadcast_to(sel[:, None], (m, F))[emit_dn]])
    pl = np.concatenate([
        np.broadcast_to(plen[:, None], (m, F))[emit_up],
        np.broadcast_to(plen[:, None], (m, F))[emit_dn]])

    # per-y mask filter (does not affect the freq test)
    mlen_y = np.where(soft_mask, pl, kmer + 1)
    keep = t2.maskb[ys] < mlen_y
    xs, ys, pl = xs[keep], ys[keep], pl[keep]

    # deterministic order: by (x, y)
    o = np.lexsort((ys, xs))
    xs, ys, pl = xs[o], ys[o], pl[o]

    return (pl.astype(np.uint8),
            t1.cont[xs], t1.post[xs],
            t2.cont[ys], t2.post[ys],
            t2.comp[ys])


def self_adaptamer_seeds(t1: GixTable, freq: int = 10,
                         soft_mask: bool = False,
                         chunk: int = 1 << 20) -> SeedBatch:
    """All self-comparison adaptamer seeds within one GIX
    (new_self_merge_thread FastGA.c:1616-1905).

    Every entry x (either orientation) pairs with every *other* entry of
    its adaptamer group M(x) = the maximal run of entries sharing x's
    longest prefix shared with any neighbour; groups of size >= freq
    (including x) are skipped.  Relative strand = sign(x) XOR sign(y);
    both (x,y) and (y,x) are emitted, which yields the symmetric record
    set the reference produces for `FastGA A`.
    """
    kmer = t1.kmer
    n = t1.n
    if n == 0:
        z = np.zeros(0, dtype=np.int32)
        return SeedBatch(z.astype(np.uint8), z, z, z, z, z.astype(bool))
    # adjacent lcp in bases; adj[i] = lcp(entry i-1, entry i), adj[0]=adj[n]=0
    adj = np.zeros(n + 1, np.int32)
    adj[1:n] = np.minimum(t1.lcp[1:].astype(np.int32), kmer)
    out = []
    for lo in range(0, n, chunk):
        sel = np.arange(lo, min(lo + chunk, n))
        out.append(_self_chunk(t1, sel, adj, freq, soft_mask))
    return SeedBatch(*[np.concatenate([o[k] for o in out])
                       for k in range(6)])


def _self_chunk(t1: GixTable, sel: np.ndarray, adj: np.ndarray,
                freq: int, soft_mask: bool):
    kmer = t1.kmer
    n = t1.n
    m = len(sel)
    F = freq
    plen = np.maximum(adj[sel], adj[sel + 1])

    # extend the group window up/down while internal adjacent lcps >= plen
    up_ok = np.zeros((m, F), dtype=bool)
    down_ok = np.zeros((m, F), dtype=bool)
    up_ok[:, 0] = adj[sel + 1] >= plen
    down_ok[:, 0] = adj[sel] >= plen
    for u in range(1, F):
        j = sel + 1 + u
        up_ok[:, u] = up_ok[:, u - 1] & (j <= n) \
            & (adj[np.minimum(j, n)] >= plen)
        j2 = sel - u
        down_ok[:, u] = down_ok[:, u - 1] & (j2 >= 0) \
            & (adj[np.maximum(j2, 0)] >= plen)

    count = 1 + up_ok.sum(axis=1) + down_ok.sum(axis=1)
    alive = (count < freq) & (plen >= 12)
    mlen = np.where(soft_mask, plen, kmer + 1)
    alive &= t1.maskb[sel] < mlen

    emit_up = up_ok & alive[:, None]
    emit_dn = down_ok & alive[:, None]
    y_up = sel[:, None] + 1 + np.arange(F)[None, :]
    y_dn = sel[:, None] - 1 - np.arange(F)[None, :]

    ys = np.concatenate([y_up[emit_up], y_dn[emit_dn]])
    xs = np.concatenate([
        np.broadcast_to(sel[:, None], (m, F))[emit_up],
        np.broadcast_to(sel[:, None], (m, F))[emit_dn]])
    pl = np.concatenate([
        np.broadcast_to(plen[:, None], (m, F))[emit_up],
        np.broadcast_to(plen[:, None], (m, F))[emit_dn]])

    mlen_y = np.where(soft_mask, pl, kmer + 1)
    keep = t1.maskb[ys] < mlen_y
    xs, ys, pl = xs[keep], ys[keep], pl[keep]

    o = np.lexsort((ys, xs))
    xs, ys, pl = xs[o], ys[o], pl[o]

    return (pl.astype(np.uint8),
            t1.cont[xs], t1.post[xs],
            t1.cont[ys], t1.post[ys],
            t1.comp[xs] != t1.comp[ys])


def adaptamer_seeds_flip(t1: GixTable, t2: GixTable, freq: int = 10,
                         soft_mask: bool = False,
                         chunk: int = 1 << 20) -> SeedBatch:
    """The -S symmetric second pass: T2 entries drive the adaptamer
    grouping, matched T1 members (forward only) become the A side
    (new_merge_thread flip branch FastGA.c:833-913).  Catches seeds
    whose k-mer is unique in G2 but repetitive in G1."""
    kmer = t1.kmer
    idx = np.arange(t2.n)
    out = []
    for lo in range(0, len(idx), chunk):
        sel = idx[lo : lo + chunk]
        out.append(_flip_chunk(t1, t2, sel, freq, soft_mask))
    if not out:
        z = np.zeros(0, dtype=np.int32)
        return SeedBatch(z.astype(np.uint8), z, z, z, z, z.astype(bool))
    return SeedBatch(*[np.concatenate([o[k] for o in out])
                       for k in range(6)])


def _flip_chunk(t1: GixTable, t2: GixTable, sel: np.ndarray,
                freq: int, soft_mask: bool):
    """Like _merge_chunk with roles swapped: driver entries are t2's (any
    orientation); group members come from t1; emitted pairs are
    (A = t1 member if forward, B = t2 driver)."""
    kmer = t2.kmer
    n1 = t1.n
    k2 = t2.kbytes[sel]
    ins = _rank_into(k2, t1.kbytes)

    pred_ok = ins > 0
    succ_ok = ins < n1
    pred_rows = t1.kbytes[np.clip(ins - 1, 0, max(n1 - 1, 0))]
    succ_rows = t1.kbytes[np.clip(ins, 0, max(n1 - 1, 0))]
    lcp_pred = np.where(pred_ok, _row_lcp(k2, pred_rows, kmer), -1)
    lcp_succ = np.where(succ_ok, _row_lcp(k2, succ_rows, kmer), -1)
    plen = np.maximum(lcp_pred, lcp_succ)
    alive = plen >= 12

    F = freq
    m = len(sel)
    l1 = np.minimum(t1.lcp.astype(np.int32), kmer)
    up_ok = np.zeros((m, F), dtype=bool)
    down_ok = np.zeros((m, F), dtype=bool)
    if n1:
        up_ok[:, 0] = (lcp_succ >= plen) & succ_ok & alive
        for u in range(1, F):
            j = ins + u
            up_ok[:, u] = up_ok[:, u - 1] & (j < n1) \
                & (l1[np.clip(j, 0, n1 - 1)] >= plen)
        down_ok[:, 0] = (lcp_pred >= plen) & pred_ok & alive
        for d in range(1, F):
            j = ins - d
            down_ok[:, d] = down_ok[:, d - 1] & (j - 1 >= 0) \
                & (l1[np.clip(j, 0, n1 - 1)] >= plen)

    count = up_ok.sum(axis=1) + down_ok.sum(axis=1)
    alive &= count < freq
    mlen = np.where(soft_mask, plen, kmer + 1)
    alive &= t2.maskb[sel] < mlen

    emit_up = up_ok & alive[:, None]
    emit_dn = down_ok & alive[:, None]
    y_up = ins[:, None] + np.arange(F)[None, :]
    y_dn = ins[:, None] - 1 - np.arange(F)[None, :]

    ys = np.concatenate([y_up[emit_up], y_dn[emit_dn]])   # t1 members
    xs = np.concatenate([
        np.broadcast_to(sel[:, None], (m, F))[emit_up],
        np.broadcast_to(sel[:, None], (m, F))[emit_dn]])  # t2 drivers
    pl = np.concatenate([
        np.broadcast_to(plen[:, None], (m, F))[emit_up],
        np.broadcast_to(plen[:, None], (m, F))[emit_dn]])

    mlen_y = np.where(soft_mask, pl, kmer + 1)
    keep = (t1.maskb[ys] < mlen_y) & ~t1.comp[ys]   # A side forward only
    xs, ys, pl = xs[keep], ys[keep], pl[keep]

    o = np.lexsort((xs, ys))
    xs, ys, pl = xs[o], ys[o], pl[o]

    return (pl.astype(np.uint8),
            t1.cont[ys], t1.post[ys],
            t2.cont[xs], t2.post[xs],
            t2.comp[xs])


def _halves(k: np.ndarray) -> np.ndarray:
    """Rows of <=10 key bytes -> complex128 (hi 5 bytes, lo 5 bytes).
    40-bit halves are float64-exact, and numpy compares complex
    lexicographically (real then imag), so searchsorted over these keys
    is an exact 80-bit comparison."""
    n, kb = k.shape
    hi = np.zeros(n, np.int64)
    lo = np.zeros(n, np.int64)
    for i in range(min(kb, 5)):
        hi <<= 8
        hi |= k[:, i]
    hi <<= 8 * max(0, 5 - kb)
    for i in range(5, min(kb, 10)):
        lo <<= 8
        lo |= k[:, i]
    lo <<= 8 * max(0, 10 - max(kb, 5))
    out = np.empty(n, np.complex128)
    out.real = hi
    out.imag = lo
    return out


def _table_halves(t: GixTable) -> np.ndarray:
    """Cached complex128 keys for a table's (sorted) k-mer rows."""
    h = getattr(t, "_khalves", None)
    if h is None:
        h = _halves(t.kbytes)
        try:
            t._khalves = h
        except Exception:
            pass
    return h


def _rank_into(k1: np.ndarray, k2: np.ndarray,
               k2_halves: Optional[np.ndarray] = None) -> np.ndarray:
    """For each row of k1: number of rows of (sorted) k2 strictly below it
    ('left' insertion index)."""
    m, kb = k1.shape
    n2 = len(k2)
    if n2 == 0:
        return np.zeros(m, dtype=np.int64)
    if kb <= 10:
        # exact 80-bit complex keys: one binary search instead of a
        # (kb+1)-pass lexsort over the concatenation
        h2 = k2_halves if k2_halves is not None else _halves(k2)
        return np.searchsorted(h2, _halves(k1),
                               side="left").astype(np.int64)
    allk = np.concatenate([k1, k2])
    src = np.concatenate([np.zeros(m, np.uint8), np.ones(n2, np.uint8)])
    keys = tuple([src] + [allk[:, c] for c in range(kb - 1, -1, -1)])
    order = np.lexsort(keys)
    is2 = src[order] == 1
    n2_before = np.cumsum(is2) - is2  # T2 entries strictly before slot
    ins = np.empty(m + n2, dtype=np.int64)
    ins[order] = n2_before
    return ins[:m]


def adaptamer_kstats(t1: GixTable, t2: GixTable, want_bytes: bool = False):
    """FastKS statistics: for every T1 index entry, the adaptamer length
    (longest prefix match into T2's sorted k-mers) plus unique-mer and
    adapt-mer histograms.

    Semantics follow the reference's intent (FastKS.c:255-346): entries
    whose 12-base prefix panel is absent from T2 are skipped
    (FastKS.c:233-243); `histl[p]` counts entries with adaptamer length
    p; `histu[p]` counts those that are additionally unique on both
    sides (exactly one T2 position shares the adaptamer, and the T1
    entry's neighbours share less, FastKS.c:326-345).

    NOTE the reference binary itself mis-strides the current .gix entry
    layout: Open_Kmer_Stream(<gix>, 2) derives pbyte = kbyte-ibyte+csize
    = 9 while GIX post entries are 12 bytes (suffix 7 + post 3 + cnt 1 +
    lcp 1), so its suffix reads drift 3 bytes per entry and its output
    histograms do not describe the genomes.  This implementation computes
    the documented statistics from the correctly parsed table; no byte
    parity with the broken tool is attempted.

    Returns (histu, histl, plen_bytes-or-None); histograms are int64
    arrays indexed 0..kmer.
    """
    kmer = t1.kmer
    histu = np.zeros(kmer + 1, np.int64)
    histl = np.zeros(kmer + 1, np.int64)
    chunks: list = [] if want_bytes else None
    n1, n2 = t1.n, t2.n
    if n1 == 0 or n2 == 0:
        return histu, histl, (b"" if want_bytes else None)
    l1 = np.minimum(t1.lcp.astype(np.int32), kmer)
    l2 = np.minimum(t2.lcp.astype(np.int32), kmer)
    h2 = _table_halves(t2)
    CH = 1 << 22
    for lo in range(0, n1, CH):
        hi_ = min(lo + CH, n1)
        k1 = t1.kbytes[lo:hi_]
        m = len(k1)
        ins = np.searchsorted(h2, _halves(k1), side="left").astype(np.int64)
        pred_ok = ins > 0
        succ_ok = ins < n2
        lcp_pred = np.where(
            pred_ok, _row_lcp(k1, t2.kbytes[np.clip(ins - 1, 0, n2 - 1)],
                              kmer), -1)
        lcp_succ = np.where(
            succ_ok, _row_lcp(k1, t2.kbytes[np.clip(ins, 0, n2 - 1)],
                              kmer), -1)
        plen = np.maximum(lcp_pred, lcp_succ)
        keep = plen >= 12          # 12-base panel present in T2
        pk = plen[keep]
        histl += np.bincount(pk, minlength=kmer + 1)[:kmer + 1]
        if chunks is not None:
            chunks.append(pk.astype(np.uint8).tobytes())
        # two-sided uniqueness: window of T2 entries sharing plen has
        # size exactly 1, and the T1 entry's neighbours share < plen
        downc = pred_ok & (lcp_pred >= plen)
        upc = succ_ok & (lcp_succ >= plen)
        more_down = (ins - 1 >= 1) & (
            l2[np.clip(ins - 1, 0, n2 - 1)] >= plen)
        more_up = (ins + 1 < n2) & (
            l2[np.clip(ins + 1, 0, n2 - 1)] >= plen)
        uniq2 = ((downc & ~upc & ~more_down)
                 | (upc & ~downc & ~more_up))
        li = l1[lo:hi_]
        lnext = np.zeros(m, np.int32)
        tail = min(hi_ + 1, n1) - (lo + 1)
        lnext[:tail] = l1[lo + 1:min(hi_ + 1, n1)]
        uniq1 = (li < plen) & (lnext < plen)
        hu = plen[keep & uniq2 & uniq1]
        histu += np.bincount(hu, minlength=kmer + 1)[:kmer + 1]
    return histu, histl, (b"".join(chunks) if chunks is not None else None)
