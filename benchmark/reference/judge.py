"""The numbers that decide ``correct``, worked out from the FASTA files a
job was given, the output file it wrote and the generator's truth.

Per output file, every record is judged by what it says:

- ``unreadable``: files the plain readers cannot read (or whose footer
  counts disagree with their lines);
- ``bad_format``: records or lines that contradict the genomes (contig,
  length, coordinates outside a sequence; a .1aln skeleton that is not
  the two genomes; a PAF match count or block length other than its spans
  and differences give);
- ``bad_trace``: .1aln records whose trace does not add up (a panel per
  trace-spacing interval of A, B advances summing to the B span,
  differences summing to the record's);
- ``filter_miss``: records shorter or less similar than the options allow
  (FastGA's own slack: length at least -l minus 50, differences at most
  (1 - -i + 0.05) times the A span);
- ``lies``: trace panels (.1aln, every one) or whole records (PAF, a
  sample of ``WHOLE_MAX`` drawn from the seed, each job's longest in it)
  whose stated differences are fewer than the edit distance of the two
  sequences they name: no alignment of them has so few;
- ``excess_share``: the differences stated beyond that edit distance, in
  percent of it, summed over the same panels (and records whose banded
  distance is exact): a path worse than it need be, or differences
  overstated;
- ``in_mask`` (runs with -M only): records whose A span or B span has no
  base outside the FASTA's soft mask (lower case), where -M allows no
  seed, so no alignment can start;
- ``redundant``: pairs of records of one contig pair and strand that
  start at the same point or end at the same point (what dedup removes);
- ``off_truth``: records that are not homologous in the generator's
  truth at any of five points along them (neither on the pair's own
  diagonal, nor copies of one repeat family, nor two tandem arrays);
- ``uncovered_max``: the largest share of a stretch of true homology (a
  contig pair and strand, 1,000 bases or more) that no diagonal record
  covers (none in a self comparison, whose own diagonal FastGA leaves
  out).  Under -M a stretch is owed a record only where it holds -c
  unmasked bases in a row, in A and at their image in B: -M lets no seed
  start in a masked base, so a stretch with fewer cannot hold a chain of
  seeds that covers -c bases.

The rules come from the job's own options: -l (default 100), -i (default
.7), -c (default 85) and -M.  ``excess_max`` (stated differences less the edit distance,
the widest gap) and the record and panel counts are information.
"""

from __future__ import annotations

import struct
from collections import defaultdict
from typing import Callable, List

import numpy as np
import torch

from . import editdist, onealn, paf
from .fasta import read_fasta, revcomp

TANDEM0 = -2
COMPARED = ("unreadable", "bad_format", "bad_trace", "filter_miss", "lies",
            "excess_share", "redundant", "off_truth", "uncovered_max",
            "in_mask")
MIN_STRETCH = 1000
BAND_HALF = 64
PANEL_MAX_B = 4         # panels advancing B past this many spacings: bound
TSPACE = 100            # FastGA's trace spacing
WHOLE_MAX = 2048        # PAF records whose edit distance is computed


def job_rules(options):
    """(-l, -i, -c, -M) of a job's command line, FastGA's defaults where
    absent."""
    align_min, ident, chain_min = 100, 0.7, 85
    for o in options:
        if o.startswith("-l") and len(o) > 2:
            align_min = int(o[2:])
        elif o.startswith("-i") and len(o) > 2:
            ident = float(o[2:])
        elif o.startswith("-c") and len(o) > 2:
            chain_min = int(o[2:])
    return align_min, ident, chain_min, "-M" in options


class _Genomes:
    """Both genomes of a pair as flat base arrays: A, then B forward
    followed by every B contig reverse-complemented."""

    def __init__(self, a_fa, b_fa):
        self.names_a, A, low_a = read_fasta(a_fa, lower=True)
        self.names_b, B, low_b = read_fasta(b_fa, lower=True)
        self.low_a = np.concatenate(low_a)
        self.low_b = np.concatenate(low_b)
        # upper-case bases before each position, per genome (flat)
        self.up_a = np.concatenate([[0], np.cumsum(~self.low_a)])
        self.up_b = np.concatenate([[0], np.cumsum(~self.low_b)])
        self.len_a = np.array([len(s) for s in A], np.int64)
        self.len_b = np.array([len(s) for s in B], np.int64)
        self.off_a = np.concatenate([[0], np.cumsum(self.len_a)[:-1]])
        self.off_b = np.concatenate([[0], np.cumsum(self.len_b)[:-1]])
        self.tot_b = int(self.len_b.sum())
        self.seq_a = np.concatenate(A)
        self.seq_b = np.concatenate(B + [revcomp(s) for s in B])


class _Truth:
    """The generator's truth of a pair, flattened: each A base's label,
    each B base's origin in A, and per contig the A bases homologous to B
    forward and through an inversion.  In a self comparison B is A: each
    base its own origin, and no stretch is owed a record."""

    def __init__(self, pair, off_a, off_b, self_cmp=False):
        self.labels = np.concatenate(pair.labels)
        origin = pair.origin
        inv = pair.inv
        if self_cmp:
            origin = [np.arange(len(x), dtype=np.int64) for x in pair.labels]
            inv = [(0, 0)] * len(origin)
        self.origin = np.concatenate(origin)
        self.off_a, self.off_b = off_a, off_b
        self.inv = np.array(inv, np.int64).reshape(-1, 2)
        self.sets, self.img = [], []
        for o, (q0, q1), la in zip(origin, inv,
                                   (len(x) for x in pair.labels)):
            img = np.full(la, -1, np.int64)
            ok = o >= 0
            img[o[ok]] = np.nonzero(ok)[0]
            comp = (img >= q0) & (img < q1)
            none = np.zeros(la, bool)
            self.sets.append((none, none) if self_cmp
                             else ((img >= 0) & ~comp, comp))
            self.img.append(img)

    def origin_of(self, b, pos):
        """A position each B base came from (an inserted base takes its
        nearest neighbour's within 32 bases; -1 past that)."""
        flat = self.off_b[b] + pos
        o = self.origin[flat]
        hi = self.off_b[b] + (self.origin_len(b) - 1)
        for d in range(1, 33):
            miss = o < 0
            if not miss.any():
                break
            for step in (d, -d):
                q = np.clip(flat + step, self.off_b[b], hi)
                o = np.where(miss & (o < 0), self.origin[q], o)
        return o

    def origin_len(self, b):
        ends = np.concatenate([self.off_b[1:], [len(self.origin)]])
        return ends[b] - self.off_b[b]


def _arrays(recs):
    f = np.array([(r.a, r.b, r.comp, r.ab, r.ae, r.bb, r.be, r.diffs)
                  for r in recs], np.int64).reshape(-1, 8)
    return [f[:, k] for k in range(8)]


def judge(jobs: List[dict], rules: dict, truth_of: Callable, device
          ) -> tuple:
    """``jobs``: dicts with ``pair`` (index), ``a_fa``, ``b_fa`` (``a_fa``
    again in a self comparison), ``out`` (the file the job wrote) and
    ``form`` ("1aln" or "paf").  ``rules``: ``options`` (the job's
    command line flags), ``self`` (a self comparison) and ``seed`` (the
    sample of records without a trace whose edit distance is computed).
    ``truth_of(pair)`` gives the generator's pair.  Returns (numbers,
    info)."""
    num = dict.fromkeys(COMPARED, 0)
    num["uncovered_max"] = 0.0
    info = dict(records=0, panels=0, excess_max=0, excess=0, edit=0)
    align_min, ident, chain_min, soft_mask = job_rules(
        rules.get("options", []))
    self_cmp = bool(rules.get("self"))
    T = TSPACE
    min_len = align_min - 50
    max_rate = 1.0 - ident + 0.05
    by_pair = defaultdict(list)
    for j in jobs:
        by_pair[j["pair"]].append(j)
    dp = defaultdict(list)      # panels / whole: columns of pieces
    seqs = {"a": [], "b": []}   # every pair's sequences, end to end
    for pi, pjobs in sorted(by_pair.items()):
        g = _Genomes(pjobs[0]["a_fa"], pjobs[0]["b_fa"])
        tr = _Truth(truth_of(pi), g.off_a, g.off_b, self_cmp)
        g.off_a_dp = g.off_a + sum(len(x) for x in seqs["a"])
        g.off_b_dp = g.off_b + sum(len(x) for x in seqs["b"])
        seqs["a"].append(g.seq_a)
        seqs["b"].append(g.seq_b)
        for job in pjobs:
            try:
                if job["form"] == "1aln":
                    skel, recs, _ = onealn.read_aln(job["out"])
                    skel = [list(map(int, s)) for s in skel]
                    want = [g.len_a.tolist(), g.len_b.tolist()]
                    if skel != want and not (self_cmp and skel == want[:1]):
                        num["bad_format"] += 1
                else:
                    recs, bad = paf.read_paf(job["out"], g.names_a,
                                             g.len_a.tolist(), g.names_b,
                                             g.len_b.tolist())
                    num["bad_format"] += bad
            except (onealn.FormatError, ValueError, OSError, IndexError,
                    KeyError, struct.error):
                num["unreadable"] += 1
                continue
            info["records"] += len(recs)
            recs = _in_bounds(recs, g, num)
            if not recs:
                continue
            a, b, comp, ab, ae, bb, be, d = _arrays(recs)
            span = ae - ab
            num["filter_miss"] += int(((span < min_len)
                                       | (d > max_rate * span)).sum())
            num["redundant"] += _redundant(a, b, comp, ab, ae, bb, be)
            if soft_mask:
                num["in_mask"] += _in_mask(g, a, b, comp, ab, ae, bb, be)
            diag = _homology(tr, g, a, b, comp, ab, ae, bb, be, num)
            num["uncovered_max"] = max(
                num["uncovered_max"],
                _uncovered(tr, g, a, comp, ab, ae, diag,
                           chain_min if soft_mask else 0))
            if job["form"] == "1aln":
                _panels(recs, g, T, dp, num)
            else:
                sa = g.off_a_dp[a] + ab
                sb = g.off_b_dp[b] + bb + comp * g.tot_b
                longest = np.zeros(len(a), bool)
                longest[np.argmax(span)] = True
                for k, v in zip(("sa", "la", "sb", "lb", "d", "top"),
                                (sa, span, sb, be - bb, d, longest)):
                    dp["whole_" + k].append(v)
    _sample_whole(dp, rules.get("seed", 0))
    if seqs["a"]:
        _run_dp(dp, torch.from_numpy(np.concatenate(seqs["a"])).to(device),
                torch.from_numpy(np.concatenate(seqs["b"])).to(device),
                num, info)
    if info["edit"]:
        num["excess_share"] = 100.0 * info["excess"] / info["edit"]
    return num, info


def _in_bounds(recs, g, num):
    keep = []
    for r in recs:
        if (0 <= r.a < len(g.len_a) and 0 <= r.b < len(g.len_b)
                and 0 <= r.ab < r.ae <= g.len_a[r.a]
                and 0 <= r.bb < r.be <= g.len_b[r.b] and r.diffs >= 0):
            keep.append(r)
        else:
            num["bad_format"] += 1
    return keep


def _redundant(a, b, comp, ab, ae, bb, be):
    n = len(a)
    starts = np.unique(np.stack([a, b, comp, ab, bb], 1), axis=0)
    ends = np.unique(np.stack([a, b, comp, ae, be], 1), axis=0)
    return int((n - len(starts)) + (n - len(ends)))


def _in_mask(g, a, b, comp, ab, ae, bb, be):
    fa0, fa1 = g.off_a[a] + ab, g.off_a[a] + ae
    bf0 = np.where(comp == 1, g.len_b[b] - be, bb)     # B forward span
    bf1 = np.where(comp == 1, g.len_b[b] - bb, be)
    fb0, fb1 = g.off_b[b] + bf0, g.off_b[b] + bf1
    none_a = g.up_a[fa1] - g.up_a[fa0] == 0
    none_b = g.up_b[fb1] - g.up_b[fb0] == 0
    return int((none_a | none_b).sum())


def _homology(tr, g, a, b, comp, ab, ae, bb, be, num):
    """Per record, whether it is homologous in the truth at one of five
    points spread along it (a record can span several repeat copies and
    the stretches between them); returns whether it lies on its pair's
    own diagonal."""
    diag = np.zeros(len(a), bool)
    good = np.zeros(len(a), bool)
    for f in (0.5, 0.1, 0.3, 0.7, 0.9):
        pa = ab + ((ae - ab) * f).astype(np.int64)
        pb = bb + ((be - bb) * f).astype(np.int64)
        pbf = np.where(comp == 1, g.len_b[b] - 1 - pb, pb)
        oa = tr.origin_of(b, pbf)
        inv = (pbf >= tr.inv[b, 0]) & (pbf < tr.inv[b, 1])
        on = ((a == b) & (oa >= 0)
              & (np.abs(oa - pa) <= 0.05 * (ae - ab) + 100)
              & ((comp == 1) == inv))
        la = tr.labels[tr.off_a[a] + pa]
        lb = np.where(oa >= 0,
                      tr.labels[tr.off_a[b] + np.maximum(oa, 0)], -1)
        fam = (la == lb) & (la >= 0)
        tan = (la <= TANDEM0) & (lb <= TANDEM0)
        diag |= on
        good |= on | fam | tan
    num["off_truth"] += int((~good).sum())
    return diag


def _longest_run(x):
    r = np.diff(np.concatenate([[0], x.astype(np.int8), [0]]))
    starts, ends = np.nonzero(r == 1)[0], np.nonzero(r == -1)[0]
    return int((ends - starts).max()) if len(starts) else 0


def _uncovered(tr, g, a, comp, ab, ae, diag, min_unmasked):
    """``min_unmasked``: under -M, the unmasked bases in a row a stretch
    needs to be owed a record (0: every stretch is)."""
    worst = 0.0
    for i, fwd_comp in enumerate(tr.sets):
        for s, want in enumerate(fwd_comp):
            tot = int(want.sum())
            if tot < MIN_STRETCH:
                continue
            if min_unmasked:
                img = tr.img[i]
                open_ = (want & ~g.low_a[g.off_a[i]:g.off_a[i] + len(img)]
                         & ~g.low_b[g.off_b[i] + np.maximum(img, 0)])
                if _longest_run(open_) < min_unmasked:
                    continue
            sel = diag & (a == i) & (comp == s)
            cov = np.zeros(len(want) + 1, np.int64)
            np.add.at(cov, ab[sel], 1)
            np.add.at(cov, ae[sel], -1)
            covered = np.cumsum(cov)[:-1] > 0
            worst = max(worst, float((want & ~covered).sum()) / tot)
    return worst


def _panels(recs, g, T, dp, num):
    """A panel a trace point: its A interval, B interval and differences
    (records whose trace does not add up count in bad_trace instead)."""
    rows = []
    for r in recs:
        tr = r.trace or []
        k = (r.ae - 1) // T - r.ab // T + 1
        if (len(tr) != k or sum(x for _, x in tr) != r.be - r.bb
                or sum(x for x, _ in tr) != r.diffs
                or any(x < 0 or y < 0 for x, y in tr)):
            num["bad_trace"] += 1
            continue
        rows.append(r)
    if not rows:
        return
    a, b, comp, ab, ae, bb, be, d = _arrays(rows)
    k = (ae - 1) // T - ab // T + 1
    rec = np.repeat(np.arange(len(rows)), k)
    first = np.concatenate([[0], np.cumsum(k)[:-1]])
    kk = np.arange(len(rec)) - first[rec]
    tdd = np.array([x for r in rows for x, _ in r.trace], np.int64)
    tbb = np.array([y for r in rows for _, y in r.trace], np.int64)
    a0 = np.maximum(ab[rec], (ab[rec] // T + kk) * T)
    a1 = np.minimum(ae[rec], (ab[rec] // T + kk + 1) * T)
    csum = np.cumsum(tbb)
    b0 = bb[rec] + csum - tbb - (csum - tbb)[first][rec]
    dp["panel_sa"].append(g.off_a_dp[a[rec]] + a0)
    dp["panel_la"].append(a1 - a0)
    dp["panel_sb"].append(g.off_b_dp[b[rec]] + b0 + comp[rec] * g.tot_b)
    dp["panel_lb"].append(tbb)
    dp["panel_d"].append(tdd)


def _sample_whole(dp, seed):
    """Whole records beyond ``WHOLE_MAX`` are sampled, drawn from
    ``seed``, each job's longest record always in."""
    if not dp["whole_sa"]:
        return
    top = np.concatenate(dp.pop("whole_top"))
    cap = WHOLE_MAX
    if len(top) <= cap:
        return
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), len(top)])
    rest = np.nonzero(~top)[0]
    pick = np.sort(np.concatenate([
        np.nonzero(top)[0],
        rng.choice(rest, max(0, cap - int(top.sum())), replace=False)]))
    for k in ("sa", "la", "sb", "lb", "d"):
        dp["whole_" + k] = [np.concatenate(dp["whole_" + k])[pick]]


def _run_dp(dp, seq_a, seq_b, num, info):
    dev = seq_a.device
    for kind, half in (("panel", None), ("whole", BAND_HALF)):
        if not dp[kind + "_sa"]:
            continue
        sa, la, sb, lb, d = (np.concatenate(dp[f"{kind}_{k}"])
                             for k in ("sa", "la", "sb", "lb", "d"))
        if kind == "panel":
            info["panels"] += len(d)
        else:
            info["whole_checked"] = info.get("whole_checked", 0) + len(d)
            long_b = lb > PANEL_MAX_B * max(int(la.max()), 1)
            # past the cap only the length difference is a sure bound
            num["lies"] += int((d[long_b] < np.abs(lb - la)[long_b]).sum())
            keep = ~long_b
            sa, la, sb, lb, d = sa[keep], la[keep], sb[keep], lb[keep], d[keep]
            if not len(d):
                continue
        t = [torch.from_numpy(x).to(dev) for x in (sa, la, sb, lb)]
        if kind == "panel":
            dist = editdist.panels(seq_a, t[0], t[1], seq_b, t[2], t[3])
        else:
            dist = editdist.banded(seq_a, t[0], t[1], seq_b, t[2], t[3],
                                   half)
        dist = dist.cpu().numpy()
        # a record whose B span leaves the band: its length difference is
        # the bound
        wide = dist < 0
        num["lies"] += int((d[wide] < np.abs(lb - la)[wide]).sum())
        # a path that leaves a band of ``half`` takes more than ``half``
        # indels, so the distance is at least min(banded, half + 1), and
        # equals the banded value where that is ``half`` or less
        sure = dist if half is None else np.minimum(dist, half + 1)
        num["lies"] += int((d[~wide] < sure[~wide]).sum())
        exact = ~wide if half is None else (~wide) & (dist <= half)
        if exact.any():
            gap = (d - dist)[exact]
            info["excess_max"] = max(info["excess_max"], int(gap.max()))
            info["excess"] += int(np.clip(gap, 0, None).sum())
            info["edit"] += int(dist[exact].sum())
