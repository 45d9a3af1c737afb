"""Genome-pair generators of the benchmark, with the truth the reference needs.

Frozen copy of ``fastga_tpu_torch/utils/synth.py`` (``mutate``,
``uniform_pair``, ``repeat_rich_pair``) as of commit 1ef7a55, with the
same random draws in the same order, so that a seed gives the genomes the
program's own scenarios give.  What this copy adds is the
truth: where every base of B came from in A (``origin``: the A position,
or -1 for an inserted base), which B bases lie in an inverted stretch, and
what each A base is (a unique stretch, a copy of repeat family f, or a
tandem array).  Later changes to the program do not change this file.

FASTA writing (``write_fasta``) puts the repeat intervals in lower case,
FASTA's soft mask, 80 bases a line.  One departure from ``synth``: B's
mask is the image of A's through B's edits and inversion (``_image_masks``),
as a repeat masker run on B would find it, not A's intervals scaled to
B's length.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

UNIQUE = -1          # A label of a unique stretch
TANDEM0 = -2         # A label of tandem array t is TANDEM0 - t


@dataclass
class Pair:
    """Two genomes (lists of uint8 base codes 0-3), their soft-mask
    intervals and the truth of B against A, contig by contig."""
    A: List[np.ndarray]
    B: List[np.ndarray]
    masks_a: List[np.ndarray] = field(default_factory=list)
    masks_b: List[np.ndarray] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)   # per A base
    origin: List[np.ndarray] = field(default_factory=list)   # per B base
    inv: List[tuple] = field(default_factory=list)   # B [q0, q1) inverted


def _mutate(rng, s, div, indel_frac=0.1):
    """synth.mutate, returning (mutated, origin of each output base)."""
    b = s.copy()
    o = np.arange(len(s), dtype=np.int64)
    sub = rng.random(len(b)) < div * (1.0 - 2.0 * indel_frac)
    b[sub] = (b[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    nind = int(div * indel_frac * len(b))
    if nind:
        dels = rng.integers(0, len(b), nind)
        b = np.delete(b, dels)
        o = np.delete(o, dels)
        ins = rng.integers(0, len(b), nind)
        b = np.insert(b, ins, rng.integers(0, 4, nind))
        o = np.insert(o, ins, -1)
    return b, o


def uniform_pair(rng, ncontig: int, clen: int, div: float = 0.01) -> Pair:
    """synth.uniform_pair: ncontig near-identical contig pairs; every 4th B
    contig carries a middle-third inversion."""
    p = Pair([], [])
    for i in range(ncontig):
        a = rng.integers(0, 4, clen).astype(np.uint8)
        b = a.copy()
        o = np.arange(clen, dtype=np.int64)
        mut = rng.random(clen) < div * 0.8
        b[mut] = (b[mut] + rng.integers(1, 4, mut.sum())) % 4
        dels = rng.integers(0, len(b), int(div * 0.1 * clen) + 1)
        b = np.delete(b, dels)
        o = np.delete(o, dels)
        ins = rng.integers(0, len(b), int(div * 0.1 * clen) + 1)
        b = np.insert(b, ins, rng.integers(0, 4, len(ins)))
        o = np.insert(o, ins, -1)
        inv = (0, 0)
        if i % 4 == 3:
            q = len(b) // 3
            b[q:2 * q] = (3 - b[q:2 * q])[::-1]
            o[q:2 * q] = o[q:2 * q][::-1]
            inv = (q, 2 * q)
        p.A.append(a)
        p.B.append(b)
        p.labels.append(np.full(clen, UNIQUE, np.int32))
        p.origin.append(o)
        p.inv.append(inv)
        p.masks_a.append(np.zeros((0, 2), np.int64))
        p.masks_b.append(np.zeros((0, 2), np.int64))
    return p


def repeat_rich_pair(rng, total_bp: int, ncontig: int = 16,
                     hap_div: float = 0.01, repeat_frac: float = 0.45,
                     nfam: Optional[int] = None, subfam_per_fam: int = 6,
                     copies_per_subfam: int = 11, subfam_div: float = 0.06,
                     copy_div: float = 0.015, tandem_frac: float = 0.02,
                     mask_repeats: bool = True) -> Pair:
    """synth.repeat_rich_pair: a haplotype pair with dispersed repeat
    families (subfamilies of recent copies), tandem arrays, soft-masked
    repeat intervals and inversions in B."""
    mean_copy = (4000.0 - 400.0) / np.log(10.0)
    repeat_bp = total_bp * repeat_frac * (1.0 - tandem_frac)
    if nfam is None:
        per_fam = subfam_per_fam * copies_per_subfam * mean_copy
        nfam = max(1, int(round(repeat_bp / per_fam)))

    fam_lens = np.exp(rng.uniform(np.log(400.0), np.log(4000.0),
                                  nfam)).astype(int)
    copies: List[np.ndarray] = []
    copy_fam: List[int] = []
    for f, fl in enumerate(fam_lens):
        root = rng.integers(0, 4, int(fl)).astype(np.uint8)
        for _ in range(subfam_per_fam):
            cons = _mutate(rng, root, subfam_div)[0]
            for _ in range(copies_per_subfam):
                copies.append(_mutate(rng, cons, copy_div)[0])
                copy_fam.append(f)
    order = rng.permutation(len(copies))

    ntand = max(1, int(total_bp * repeat_frac * tandem_frac / 800))
    tandems = []
    for _ in range(ntand):
        period = int(rng.integers(4, 64))
        unit = rng.integers(0, 4, period).astype(np.uint8)
        reps = int(rng.integers(200, 2000)) // period + 2
        arr = np.tile(unit, reps)
        tandems.append(_mutate(rng, arr, 0.02)[0])

    inserts = [copies[i] for i in order] + tandems
    ins_label = ([copy_fam[i] for i in order]
                 + [TANDEM0 - t for t in range(ntand)])
    ins_order = rng.permutation(len(inserts))
    per_ctg = np.array_split(ins_order, ncontig)
    uniq_total = total_bp - sum(len(x) for x in inserts)
    uniq_total = max(uniq_total, total_bp // 10)

    p = Pair([], [])
    for ci in range(ncontig):
        idxs = per_ctg[ci]
        n_gaps = len(idxs) + 1
        share = uniq_total // ncontig
        gap_lens = rng.multinomial(share, np.ones(n_gaps) / n_gaps) + 20
        parts, mask, labs = [], [], []
        pos = 0
        for gi, ii in enumerate(idxs):
            g = rng.integers(0, 4, int(gap_lens[gi])).astype(np.uint8)
            parts.append(g)
            labs.append(np.full(len(g), UNIQUE, np.int32))
            pos += len(g)
            cp = inserts[ii]
            if rng.random() < 0.5:
                cp = (3 - cp)[::-1]
            parts.append(cp)
            labs.append(np.full(len(cp), ins_label[ii], np.int32))
            mask.append((pos, pos + len(cp)))
            pos += len(cp)
        parts.append(rng.integers(0, 4, int(gap_lens[-1])).astype(np.uint8))
        labs.append(np.full(len(parts[-1]), UNIQUE, np.int32))
        a = np.concatenate(parts)
        am = np.asarray(mask, np.int64).reshape(-1, 2)

        b, o = _mutate(rng, a, hap_div)
        inv = (0, 0)
        if ci % 3 == 2 and len(b) > 3000:
            q0 = int(rng.integers(len(b) // 4, len(b) // 2))
            q1 = q0 + int(rng.integers(1000, max(1001, len(b) // 4)))
            q1 = min(q1, len(b))
            b[q0:q1] = (3 - b[q0:q1])[::-1]
            o[q0:q1] = o[q0:q1][::-1]
            inv = (q0, q1)
        if mask_repeats and len(am):
            bm = _image_masks(am, len(a), o)
        else:
            bm = np.zeros((0, 2), np.int64)
        if not mask_repeats:
            am = np.zeros((0, 2), np.int64)
        p.A.append(a)
        p.B.append(b)
        p.masks_a.append(am)
        p.masks_b.append(bm)
        p.labels.append(np.concatenate(labs))
        p.origin.append(o)
        p.inv.append(inv)
    return p


def _runs(x):
    """[start, end) of each run of True in ``x``, as an [n, 2] array."""
    d = np.diff(np.concatenate([[0], x.astype(np.int8), [0]]))
    return np.stack([np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]],
                    1).astype(np.int64)


def _image_masks(am, la, origin):
    """B's soft mask: each B base masked where the A base it came from is
    (an inserted base as the base before it), so a repeat stays masked in
    B wherever it lies, inverted stretches included."""
    low = np.zeros(la + 1, np.int64)
    np.add.at(low, am[:, 0], 1)
    np.add.at(low, am[:, 1], -1)
    low = np.cumsum(low)[:-1] > 0
    src = np.where(origin >= 0, np.arange(len(origin)), 0)
    src = np.maximum.accumulate(src)
    return _runs(low[np.maximum(origin, 0)][src])


GENERATORS = {"uniform_pair": uniform_pair,
              "repeat_rich_pair": repeat_rich_pair}


def make_pair(generator: dict, seed: int, index: int) -> Pair:
    """Pair ``index`` of a run seeded with ``seed``: the configuration's
    generator (its ``kind`` and keyword ``params``) on its own stream."""
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), int(index)])
    kind = generator["kind"]
    if kind not in GENERATORS:
        raise ValueError(f"unknown generator kind '{kind}' "
                         f"(known: {sorted(GENERATORS)})")
    return GENERATORS[kind](rng, **generator.get("params", {}))


_UPPER = np.frombuffer(b"ACGT", np.uint8)


def write_fasta(path: str, contigs: List[np.ndarray], prefix: str,
                masks: Optional[List[np.ndarray]] = None, width: int = 80):
    """Contigs as FASTA, ``width`` bases a line; mask intervals in lower
    case."""
    with open(path, "wb") as f:
        for i, s in enumerate(contigs):
            body = _UPPER[s]
            if masks is not None and len(masks[i]):
                low = np.zeros(len(body), bool)
                for b, e in masks[i]:
                    low[b:e] = True
                body = np.where(low, body | 0x20, body).astype(np.uint8)
            full = len(body) // width
            f.write(b">%s%d\n" % (prefix.encode(), i))
            f.write(np.concatenate(
                [body[:full * width].reshape(full, width),
                 np.full((full, 1), 10, np.uint8)], 1).tobytes())
            if len(body) % width:
                f.write(body[full * width:].tobytes() + b"\n")


def write_pair(pair: Pair, directory: str, stem: str):
    """The pair as ``<stem>_A.fa`` and ``<stem>_B.fa`` in ``directory``;
    returns the two paths."""
    pa = os.path.join(directory, f"{stem}_A.fa")
    pb = os.path.join(directory, f"{stem}_B.fa")
    write_fasta(pa, pair.A, "a", pair.masks_a)
    write_fasta(pb, pair.B, "b", pair.masks_b)
    return pa, pb

