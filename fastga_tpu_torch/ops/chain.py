# Copied from fastga_tpu/ops/chain.py; imports point at fastga_tpu_torch.
"""Seed chaining: (diag,anti) transform, bucket-pair sweep, tube emission.

Clean-room re-formulation of FastGA's seed geometry and chain detection
(reimport_thread FastGA.c:2641-2747, align_contigs sweep FastGA.c:3040-3180):

Geometry (A post `ip`, B post `jp`, with AMXPOS/BMXPOS = max contig length of
each genome and MAXDAG = AMXPOS + BMXPOS):

    B forward:  diag = BMXPOS + (ip - jp)      anti = ip + jp
    B reverse:  diag = MAXDAG - (ip + jp)      anti = AMXPOS - (ip - jp)

(the reverse case reflects A into complement coordinates so one wave kernel
handles both strands).  Seeds fall into 64-wide diagonal buckets
(BUCK_SHIFT=6); for every bucket d the sweep walks the anti-ordered merge of
buckets d and d+1 (lower entries first on anti ties) and accumulates chains:

  - an entry extends the chain while anti < ahgh + CHAIN_BREAK, where
    ahgh is the running max of cps = anti + 2*plen;
  - coverage accumulates the novel part of [anti, cps) against ahgh;
  - on a gap >= CHAIN_BREAK (or stream end) the chain yields a *tube*
    iff cov >= CHAIN_MIN and it is not a pure-lower-bucket chain already
    covered by the (d-1, d) pairing (the mix/new rule FastGA.c:3139-3160);
  - pairing (d, d+1) is examined iff d is nonempty and (d-1 empty or d+1
    nonempty) (the new/aux outer loop FastGA.c:3040-3056, 3380-3397).

Tube coordinates are converted to contig space on emission
(FastGA.c:3186-3200): dg += d<<6, then comp ? (dg += alen-MAXDAG,
anti += alen-AMXPOS) : (dg -= BMXPOS).

The sweep is vectorized with a two-sided break test: since anti is sorted
and 24 <= cps - anti <= 80, a gap >= CHAIN_BREAK+80 always breaks and a gap
< CHAIN_BREAK+24 never does; only the rare in-between gaps are resolved
against the exact running chain max.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .merge import SeedBatch

BUCK_SHIFT = 6
BUCK_WIDTH = 1 << BUCK_SHIFT   # 64
BUCK_ANTI = 128                # anti-diagonal tube tile (FastGA.c:52-55)


@dataclass
class TubeBatch:
    """Alignment tubes in contig coordinates (A complemented when comp).

    One row per above-threshold chain; group keys identify the
    (A contig, B contig, strand) pair (contig ids are length ranks) and
    ``pairing`` the diagonal bucket pair, for `alast` blocking order.
    """
    acont: np.ndarray   # int32
    bcont: np.ndarray   # int32
    comp: np.ndarray    # bool
    dgmin: np.ndarray   # int32 — diagonal range (contig coords)
    dgmax: np.ndarray   # int32
    alow: np.ndarray    # int64 — anti range (contig coords)
    ahgh: np.ndarray    # int64
    pairing: np.ndarray  # int64 — diagonal bucket d of the (d,d+1) sweep
    cov: np.ndarray     # int64 — chain seed coverage (anti units); the
    # wave scheduler's death predictor (uncovered extent ~ error count)

    @property
    def n(self) -> int:
        return len(self.acont)

    def __len__(self):
        return self.n


def seed_geometry(seeds: SeedBatch, amax: int, bmax: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(diag, anti, dbuck) per seed in reflected max-length coordinates."""
    ip = seeds.apost.astype(np.int64)
    jp = seeds.bpost.astype(np.int64)
    maxdag = amax + bmax
    diag = np.where(seeds.bcomp, maxdag - (ip + jp), bmax + (ip - jp))
    anti = np.where(seeds.bcomp, amax - (ip - jp), ip + jp)
    dbuck = diag >> BUCK_SHIFT
    return diag, anti, dbuck


def chain_tubes(seeds: SeedBatch, amax: int, bmax: int,
                alens_by_rank: np.ndarray,
                chain_break: int = 2000, chain_min: int = 170,
                group_cap: int = 32 << 20) -> TubeBatch:
    """Run the bucket-pair chain sweep over all seeds; emit tubes.

    ``alens_by_rank``: A-contig length per length-rank (for the comp
    reflection offsets).  ``chain_break``/``chain_min`` are the doubled
    anti-diagonal-unit values (-s and -c after FastGA.c:4495-4507).

    Beyond ``group_cap`` seeds the sweep runs per A-contig batch (the
    reference's contig-panel streaming, P10): chains never cross an
    A-contig, the sweep's primary sort key is the A-contig, and the
    stable pre-partition preserves tie order — so batched output is
    bit-identical to the monolithic sweep while the doubled-stream
    temporaries stay bounded.
    """
    n = seeds.n
    if n > group_cap:
        order = np.argsort(seeds.acont, kind="stable")
        ac_sorted = seeds.acont[order]
        bounds = [0]
        pos = 0
        while pos < n:
            end = min(pos + group_cap, n)
            if end < n:       # never split an A-contig across batches
                end = int(np.searchsorted(ac_sorted, ac_sorted[end - 1],
                                          side="right"))
            bounds.append(end)
            pos = end
        parts = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sel = order[lo:hi]
            sub = SeedBatch(*[getattr(seeds, f)[sel]
                              for f in ("plen", "acont", "apost",
                                        "bcont", "bpost", "bcomp")])
            parts.append(chain_tubes(sub, amax, bmax, alens_by_rank,
                                     chain_break, chain_min,
                                     group_cap=n + 1))
        return TubeBatch(*[np.concatenate(
            [getattr(p, f) for p in parts])
            for f in ("acont", "bcont", "comp", "dgmin", "dgmax",
                      "alow", "ahgh", "pairing", "cov")])
    ztube = lambda: TubeBatch(*[np.zeros(0, dt) for dt in
                                (np.int32, np.int32, bool, np.int32,
                                 np.int32, np.int64, np.int64, np.int64,
                                 np.int64)])
    if n == 0:
        return ztube()

    diag, anti, dbuck = seed_geometry(seeds, amax, bmax)
    drem = (diag - (dbuck << BUCK_SHIFT)).astype(np.int64)
    lcp2 = (seeds.plen.astype(np.int64) << 1)

    # duplicate each seed into its two pairings: as lower of (d, d+1) and
    # as upper of (d-1, d) with dg biased by BUCK_WIDTH
    gkey_a = np.concatenate([seeds.acont, seeds.acont]).astype(np.int64)
    gkey_b = np.concatenate([seeds.bcont, seeds.bcont]).astype(np.int64)
    gkey_c = np.concatenate([seeds.bcomp, seeds.bcomp]).astype(np.int64)
    pairing = np.concatenate([dbuck, dbuck - 1])
    tag = np.concatenate([np.zeros(n, np.int8), np.ones(n, np.int8)])
    dg = np.concatenate([drem, drem + BUCK_WIDTH])
    aa = np.concatenate([anti, anti])
    ll = np.concatenate([lcp2, lcp2])

    # one stable argsort over exact composite keys when ranges permit
    # (the 6-key lexsort is 6 stable passes over the doubled stream)
    pmin = int(pairing.min())
    npair = int(pairing.max()) - pmin + 1
    na = int(gkey_a.max()) + 1
    nb = int(gkey_b.max()) + 1
    hi_range = na * nb * 2 * npair
    lo_max = int(aa.max()) * 2 + 2 if len(aa) else 1
    if hi_range < (1 << 62) // lo_max and int(aa.min()) >= 0:
        # one int64 composite key: (a, b, c, pairing, aa, tag)
        hi = ((gkey_a * nb + gkey_b) * 2 + gkey_c) * npair \
            + (pairing - pmin)
        order = np.argsort(hi * lo_max + (aa * 2 + tag), kind="stable")
    elif hi_range < (1 << 52) and lo_max < (1 << 52) \
            and int(aa.min()) >= 0:
        hi = (((gkey_a * nb + gkey_b) * 2 + gkey_c) * npair
              + (pairing - pmin)).astype(np.float64)
        lo = (aa * 2 + tag).astype(np.float64)
        order = np.argsort(hi + 1j * lo, kind="stable")
    else:
        order = np.lexsort((tag, aa, pairing, gkey_c, gkey_b, gkey_a))
    gkey_a, gkey_b, gkey_c = gkey_a[order], gkey_b[order], gkey_c[order]
    pairing, tag, dg, aa, ll = (pairing[order], tag[order], dg[order],
                                aa[order], ll[order])
    m = len(aa)

    # segment starts: new (group, pairing)
    seg = np.ones(m, dtype=bool)
    seg[1:] = ((gkey_a[1:] != gkey_a[:-1]) | (gkey_b[1:] != gkey_b[:-1])
               | (gkey_c[1:] != gkey_c[:-1]) | (pairing[1:] != pairing[:-1]))

    # pairing validity: examine (d,d+1) iff d nonempty AND (d-1 empty or
    # d+1 nonempty).  In the duplicated stream: pairing p has lower entries
    # (tag 0, from bucket p) and upper entries (tag 1, from bucket p+1).
    seg_id = np.cumsum(seg) - 1
    nseg = seg_id[-1] + 1
    has_lower = np.zeros(nseg, dtype=bool)
    has_upper = np.zeros(nseg, dtype=bool)
    np.logical_or.at(has_lower, seg_id, tag == 0)
    np.logical_or.at(has_upper, seg_id, tag == 1)
    # "prev pairing is (d-1,d) of same group" <=> segment p-1 exists with
    # pairing-1 and same group AND that segment had this bucket as upper,
    # i.e. bucket d-1 nonempty = previous segment has a lower entry.
    seg_first = np.flatnonzero(seg)
    prev_adjacent = np.zeros(nseg, dtype=bool)
    if nseg > 1:
        i = seg_first[1:]
        same = ((gkey_a[i] == gkey_a[i - 1]) & (gkey_b[i] == gkey_b[i - 1])
                & (gkey_c[i] == gkey_c[i - 1])
                & (pairing[i] == pairing[i - 1] + 1))
        # adjacent previous pairing must itself contain bucket d-1 entries
        prev_adjacent[1:] = same & has_lower[seg_id[i - 1]]
    examine = has_lower & (~prev_adjacent | has_upper)
    new_flag = ~prev_adjacent  # 'new' per segment (pure-lower chains allowed)

    keep_entry = examine[seg_id]
    if not keep_entry.any():
        return ztube()
    gkey_a, gkey_b, gkey_c = (gkey_a[keep_entry], gkey_b[keep_entry],
                              gkey_c[keep_entry])
    pairing, tag, dg, aa, ll = (pairing[keep_entry], tag[keep_entry],
                                dg[keep_entry], aa[keep_entry],
                                ll[keep_entry])
    seg = seg[keep_entry].copy()
    seg_id_old = seg_id[keep_entry]
    seg[0] = True
    # recompute segment ids over the filtered stream
    seg_id = np.cumsum(seg) - 1
    new_per_seg = new_flag[seg_id_old[np.flatnonzero(seg)]]
    m = len(aa)

    # ---- chain segmentation (vectorized with ambiguous-gap resolution) ----
    cps = aa + ll
    # prefix max of cps within each (group,pairing) segment
    M = _segmented_cummax(cps, seg)
    brk = np.zeros(m, dtype=bool)
    brk |= seg  # segment start always starts a chain
    inner = ~seg
    inner_idx = np.flatnonzero(inner)
    if len(inner_idx):
        i = inner_idx
        definite = aa[i] >= M[i - 1] + chain_break
        never = aa[i] < cps[i - 1] + chain_break
        brk[i[definite]] = True
        amb = i[~definite & ~never]
        if len(amb):
            _resolve_ambiguous(brk, aa, cps, seg, amb, chain_break)

    # ---- per-chain reductions ----
    cid = np.cumsum(brk) - 1
    nch = cid[-1] + 1
    # running ahgh within chain and coverage
    ahgh_run = _segmented_cummax(cps, brk)
    prev_ahgh = np.empty(m, dtype=np.int64)
    prev_ahgh[0] = 0
    prev_ahgh[1:] = ahgh_run[:-1]
    novel = np.where(brk, ll,
                     np.maximum(np.minimum(cps - prev_ahgh, ll), 0))
    first = np.flatnonzero(brk)
    # cid is nondecreasing: per-chain reductions via reduceat (the
    # ufunc.at scatter forms are ~20x slower)
    cov = np.add.reduceat(novel, first)
    ch_dgmin = np.minimum.reduceat(dg, first)
    ch_dgmax = np.maximum.reduceat(dg, first)
    ch_alow = aa[first]
    ch_ahgh = np.maximum.reduceat(cps, first)
    ch_mix_l = np.maximum.reduceat((tag == 0).astype(np.int8), first) != 0
    ch_mix_u = np.maximum.reduceat((tag == 1).astype(np.int8), first) != 0
    ch_ga = gkey_a[first]
    ch_gb = gkey_b[first]
    ch_gc = gkey_c[first] != 0
    ch_pair = pairing[first]
    ch_new = new_per_seg[seg_id[first]]

    keep = (cov >= chain_min) & (~(ch_mix_l & ~ch_mix_u) | ch_new)

    # ---- coordinate conversion to contig space ----
    alen = alens_by_rank[ch_ga]
    dgmin = ch_dgmin + (ch_pair << BUCK_SHIFT)
    dgmax = ch_dgmax + (ch_pair << BUCK_SHIFT)
    alow = ch_alow.copy()
    ahgh = ch_ahgh.copy()
    maxdag = amax + bmax
    is_c = ch_gc
    dgmin = np.where(is_c, dgmin + (alen - maxdag), dgmin - bmax)
    dgmax = np.where(is_c, dgmax + (alen - maxdag), dgmax - bmax)
    alow = np.where(is_c, alow + (alen - amax), alow)
    ahgh = np.where(is_c, ahgh + (alen - amax), ahgh)

    k = np.flatnonzero(keep)
    return TubeBatch(
        acont=ch_ga[k].astype(np.int32), bcont=ch_gb[k].astype(np.int32),
        comp=ch_gc[k], dgmin=dgmin[k].astype(np.int32),
        dgmax=dgmax[k].astype(np.int32), alow=alow[k], ahgh=ahgh[k],
        pairing=ch_pair[k], cov=cov[k].astype(np.int64))


def _segmented_cummax(x: np.ndarray, seg_start: np.ndarray) -> np.ndarray:
    """Cumulative max of x resetting at True positions of seg_start."""
    n = len(x)
    gid = np.cumsum(seg_start) - 1
    # offset trick: subtract a huge ramp per segment so cummax never leaks
    big = (x.max() - x.min() + 1) if n else 1
    shifted = x + gid * big
    cm = np.maximum.accumulate(shifted)
    return cm - gid * big


def _resolve_ambiguous(brk, aa, cps, seg, amb, chain_break):
    """Exactly resolve gaps in [K+2*minlcp, K+2*maxlcp): walk each ambiguous
    position against the true running chain max (rare; sequential)."""
    # process in order; track chain starts implied by resolved breaks
    for i in amb:
        # find current chain start: last break at or before i-1
        j = i - 1
        # scan back to nearest known break (bounded: chain spans are short
        # relative to ambiguity rarity; exactness matters, speed doesn't)
        start = j
        while not brk[start] and not seg[start]:
            start -= 1
        ahgh = cps[start : i].max()
        if aa[i] >= ahgh + chain_break:
            brk[i] = True
