# Copied from fastga_tpu/utils/synth.py; imports point at fastga_tpu_torch.
"""Synthetic genome-pair generators for benchmarks and scale gates.

Two workload shapes:

- ``uniform_pair``: near-identical random contigs (~1% divergence,
  occasional inversions).  Yields one long alignment per contig — the
  easy, repeat-free case (bench.py's secondary scenario; also
  tools/refcheck.py's default).

- ``repeat_rich_pair``: the reference's design envelope
  (EXAMPLE/sample_session:51 — 380,294 alignments averaging 1,930 bp
  from an 86 Mbp haplotype pair, i.e. ~8.5x of the genome aligned,
  almost all of it repeat-copy-vs-repeat-copy off-diagonal).  Dispersed
  repeat families are synthesized with *subfamily structure* (copies
  within a subfamily are recent relatives at a few % divergence, so
  they chain and align; subfamily-common 40-mers sit near the -f
  frequency cutoff, exercising freq capping); tandem arrays and
  softmasked (lowercased) repeat intervals exercise the mask plumbing;
  inversions/indels in the B haplotype exercise the complement strand
  and dedup/entwine passes.

Both return plain per-contig uint8 base arrays (plus mask intervals),
convertible to in-memory GDBs via ``to_gdb`` or FASTA via
``write_fasta``.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional

import numpy as np


def mutate(rng, s: np.ndarray, div: float, indel_frac: float = 0.1
           ) -> np.ndarray:
    """Substitute div*(1-2*indel_frac), delete/insert div*indel_frac each."""
    b = s.copy()
    sub = rng.random(len(b)) < div * (1.0 - 2.0 * indel_frac)
    b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    nind = int(div * indel_frac * len(b))
    if nind:
        b = np.delete(b, rng.integers(0, len(b), nind))
        ins = rng.integers(0, len(b), nind)
        b = np.insert(b, ins, rng.integers(0, 4, nind))
    return b


def uniform_pair(rng, ncontig: int, clen: int, div: float = 0.01
                 ) -> Dict[str, List[np.ndarray]]:
    """ncontig near-identical contig pairs; every 4th B contig carries a
    middle-third inversion (the round-1/2 bench workload)."""
    genomes = {"A": [], "B": []}
    for i in range(ncontig):
        a = rng.integers(0, 4, clen).astype(np.uint8)
        b = a.copy()
        mut = rng.random(clen) < div * 0.8
        b[mut] = (b[mut] + rng.integers(1, 4, mut.sum())) % 4
        b = np.delete(b, rng.integers(0, len(b), int(div * 0.1 * clen) + 1))
        ins = rng.integers(0, len(b), int(div * 0.1 * clen) + 1)
        b = np.insert(b, ins, rng.integers(0, 4, len(ins)))
        if i % 4 == 3:
            q = len(b) // 3
            b[q:2 * q] = (3 - b[q:2 * q])[::-1]
        genomes["A"].append(a)
        genomes["B"].append(b)
    return genomes


def repeat_rich_pair(rng, total_bp: int, ncontig: int = 16,
                     hap_div: float = 0.01,
                     repeat_frac: float = 0.45,
                     nfam: Optional[int] = None,
                     subfam_per_fam: int = 6,
                     copies_per_subfam: int = 11,
                     subfam_div: float = 0.06,
                     copy_div: float = 0.015,
                     tandem_frac: float = 0.02,
                     mask_repeats: bool = True):
    """Repeat-bearing haplotype pair matching the reference yield shape.

    Returns (genomes, masks) where genomes = {"A": [contigs], "B": ...}
    and masks = {"A": [per-contig [n,2] int arrays], "B": ...} marking
    the softmasked (repeat) intervals.

    Yield model: each repeat copy aligns to its subfamily's other copies
    in the opposite haplotype (~copies_per_subfam partners each), so
    off-diagonal alignments ~= nfam * subfam * copies^2, with average
    length ~= the mean copy length (log-uniform 400..4000 -> ~1.3 kb).
    Subfamily-common 40-mers appear ~copies_per_subfam * (1-copy_div*2)^40
    times per haplotype — right at the default -f10 cutoff, exercising
    adaptamer frequency capping the way real young repeat families do.
    """
    # mean of log-uniform on [400, 4000] is (b-a)/ln(b/a)
    mean_copy = (4000.0 - 400.0) / np.log(10.0)
    repeat_bp = total_bp * repeat_frac * (1.0 - tandem_frac)
    if nfam is None:
        per_fam = subfam_per_fam * copies_per_subfam * mean_copy
        nfam = max(1, int(round(repeat_bp / per_fam)))

    # --- repeat library with subfamily structure ---
    fam_lens = np.exp(rng.uniform(np.log(400.0), np.log(4000.0),
                                  nfam)).astype(int)
    copies: List[np.ndarray] = []   # every copy instance, pre-mutation
    for fl in fam_lens:
        root = rng.integers(0, 4, int(fl)).astype(np.uint8)
        for _ in range(subfam_per_fam):
            cons = mutate(rng, root, subfam_div)
            for _ in range(copies_per_subfam):
                copies.append(mutate(rng, cons, copy_div))
    order = rng.permutation(len(copies))

    # --- tandem arrays (short-period microsatellite-like) ---
    ntand = max(1, int(total_bp * repeat_frac * tandem_frac / 800))
    tandems = []
    for _ in range(ntand):
        period = int(rng.integers(4, 64))
        unit = rng.integers(0, 4, period).astype(np.uint8)
        reps = int(rng.integers(200, 2000)) // period + 2
        arr = np.tile(unit, reps)
        tandems.append(mutate(rng, arr, 0.02))

    # --- assemble haplotype A: unique stretches + shuffled inserts ---
    inserts = [copies[i] for i in order] + tandems
    ins_order = rng.permutation(len(inserts))
    per_ctg = np.array_split(ins_order, ncontig)
    uniq_total = total_bp - sum(len(x) for x in inserts)
    uniq_total = max(uniq_total, total_bp // 10)

    A, B = [], []
    amasks, bmasks = [], []
    for ci in range(ncontig):
        idxs = per_ctg[ci]
        n_gaps = len(idxs) + 1
        share = uniq_total // ncontig
        gap_lens = rng.multinomial(
            share, np.ones(n_gaps) / n_gaps) + 20
        parts = []
        mask = []
        pos = 0
        for gi, ii in enumerate(idxs):
            g = rng.integers(0, 4, int(gap_lens[gi])).astype(np.uint8)
            parts.append(g)
            pos += len(g)
            cp = inserts[ii]
            if rng.random() < 0.5:
                cp = (3 - cp)[::-1]          # reverse-complement insert
            parts.append(cp)
            mask.append((pos, pos + len(cp)))
            pos += len(cp)
        parts.append(rng.integers(0, 4,
                                  int(gap_lens[-1])).astype(np.uint8))
        a = np.concatenate(parts)
        A.append(a)
        amasks.append(np.asarray(mask, np.int64).reshape(-1, 2))

        # --- haplotype B: mutate + structural edits ---
        b = mutate(rng, a, hap_div)
        if ci % 3 == 2 and len(b) > 3000:
            # one mid-contig inversion per third contig
            q0 = int(rng.integers(len(b) // 4, len(b) // 2))
            q1 = q0 + int(rng.integers(1000, max(1001, len(b) // 4)))
            q1 = min(q1, len(b))
            b[q0:q1] = (3 - b[q0:q1])[::-1]
        B.append(b)
        if mask_repeats and len(amasks[-1]):
            # approximate B masks by scaling A's intervals (hap_div
            # indels shift coordinates ~0.1%; masks are annotations,
            # not alignment inputs, so approximate is fine)
            sc = len(b) / max(len(a), 1)
            bm = np.clip((amasks[-1] * sc).astype(np.int64), 0, len(b))
            bmasks.append(bm)
        else:
            bmasks.append(np.zeros((0, 2), np.int64))
        if not mask_repeats:
            amasks[-1] = np.zeros((0, 2), np.int64)

    return ({"A": A, "B": B},
            {"A": amasks, "B": bmasks} if mask_repeats else None)


def to_gdb(name: str, contigs: List[np.ndarray],
           masks: Optional[List[np.ndarray]] = None):
    """In-memory GDB over uint8 base arrays (one scaffold per contig).

    Returns (gdb, mask_ivals) — mask_ivals a List[MaskIval] (empty
    without ``masks``), the shape io.gdb.create_gdb returns."""
    from ..io import gdb as gdbm
    from .dna import compress
    g = gdbm.GDB()
    packs = []
    boff = 0
    counts = np.zeros(4, dtype=np.int64)
    for i, c in enumerate(contigs):
        g.contigs.append(gdbm.Contig(len(c), 0, boff, i))
        g.scaffolds.append(gdbm.Scaffold(len(c), i, i + 1, f"{name}{i}"))
        pk = compress(c)
        packs.append(pk)
        boff += len(pk)
        counts += np.bincount(c, minlength=4)[:4]
        g.maxctg = max(g.maxctg, len(c))
    g.seqtot = int(counts.sum())
    g.freq = counts / max(g.seqtot, 1)
    g._bps = np.concatenate(packs) if packs else np.zeros(0, np.uint8)
    ivals = []
    if masks is not None:
        for ci, m in enumerate(masks):
            for b, e in m:
                ivals.append(gdbm.MaskIval(ci, int(b), int(e)))
    return g, ivals


def write_fasta(fn: str, contigs: List[np.ndarray], prefix: str,
                masks: Optional[List[np.ndarray]] = None,
                width: int = 70):
    """Write contigs as (optionally gzipped) FASTA; mask intervals are
    lowercased (implicit softmask, GDB.c:851-1022 semantics)."""
    ACGT = np.frombuffer(b"ACGT", np.uint8)
    acgt_l = np.frombuffer(b"acgt", np.uint8)
    op = gzip.open if fn.endswith(".gz") else open
    with op(fn, "wt") as f:
        for i, s in enumerate(contigs):
            f.write(f">{prefix}{i}\n")
            chars = ACGT[s].copy()
            if masks is not None and len(masks[i]):
                for b, e in masks[i]:
                    chars[b:e] = acgt_l[s[b:e]]
            txt = chars.tobytes().decode()
            for j in range(0, len(txt), width):
                f.write(txt[j:j + width] + "\n")
