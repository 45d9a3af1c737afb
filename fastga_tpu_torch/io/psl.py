# Copied from fastga_tpu/io/psl.py; imports point at fastga_tpu_torch.
"""PSL emission from alignment overlaps (ALNtoPSL equivalent).

PSL always needs the exact alignment: per record we reconstruct via
ops/tracerec (Compute_Trace_PTS + Gap_Improver), trim trailing indels
(ALNtoPSL.c:206-233), decompose into gapless blocks, and emit the 21-column
PSL line.  For '-' strand records query block starts are given in
reverse-complemented query coordinates with blocks listed in reverse
(ALNtoPSL.c:359-396).
"""

from __future__ import annotations

from typing import IO, Iterable, List, Tuple

import numpy as np

from .alncode import Overlap
from .gdb import GDB
from .paf import short_name
from ..ops import tracerec


def psl_line(o: Overlap, gdb1: GDB, gdb2: GDB, A: np.ndarray, B: np.ndarray,
             tspace: int) -> str:
    trace, diffs = tracerec.compute_trace_pts(
        A, B, o.abpos, o.aepos, o.bbpos, o.bepos, o.trace, tspace)
    trace, diffs = tracerec.gap_improver(A, B, o.abpos, o.bbpos, o.aepos,
                                         len(A), len(B), trace, diffs)
    abpos, aepos = o.abpos, o.aepos
    bbpos, bepos = o.bbpos, o.bepos

    # trim trailing indels abutting the end point
    T = len(trace)
    trim = 0
    while T > 0 and trace[T - 1] == -aepos - 1:
        trim += 1
        T -= 1
    if trim:
        bepos -= trim
        diffs -= trim
    trim = 0
    while T > 0 and trace[T - 1] == bepos + 1:
        trim += 1
        T -= 1
    if trim:
        aepos -= trim
        diffs -= trim
    trace = trace[:T]

    M = aepos - abpos
    I = D = IB = DB = 0
    p = 0
    for x in range(T):
        q = p
        p = trace[x]
        if p < 0:
            I += 1
            if p != q:
                IB += 1
        else:
            D += 1
            if p != q:
                DB += 1
    S = diffs - (I + D)
    X = M - D - S

    c1 = gdb1.contigs[o.aread]
    c2 = gdb2.contigs[o.bread]
    s1 = gdb1.scaffolds[c1.scaf]
    s2 = gdb2.scaffolds[c2.scaf]
    aoff = c1.sbeg
    strand = "-" if o.bcomp else "+"
    if o.bcomp:
        boff = c2.sbeg + c2.clen
        tpos = (boff - bepos, boff - bbpos)
    else:
        boff = c2.sbeg
        tpos = (boff + bbpos, boff + bepos)

    # gapless blocks
    sizes: List[int] = []
    astarts: List[int] = []
    bstarts: List[int] = []
    i = abpos + 1
    j = bbpos + 1
    for x in range(T):
        p = trace[x]
        if p < 0:
            bmat = -(p + i)
            if bmat > 0:
                sizes.append(bmat)
                astarts.append(i - 1)
                bstarts.append(j - 1)
            i += bmat
            j += bmat + 1
        else:
            bmat = p - j
            if bmat > 0:
                sizes.append(bmat)
                astarts.append(i - 1)
                bstarts.append(j - 1)
            i += bmat + 1
            j += bmat
    bmat = (aepos - i) + 1
    if bmat > 0:
        sizes.append(bmat)
        astarts.append(i - 1)
        bstarts.append(j - 1)
    bcnt = len(sizes)

    if o.bcomp:
        bsz = "".join(f"{sizes[i]}," for i in range(bcnt - 1, -1, -1))
        qst = "".join(f"{s1.slen - (aoff + astarts[i] + sizes[i])},"
                      for i in range(bcnt - 1, -1, -1))
        boff = c2.sbeg + c2.clen
        tst = "".join(f"{boff - (bstarts[i] + sizes[i])},"
                      for i in range(bcnt - 1, -1, -1))
    else:
        bsz = "".join(f"{s},"for s in sizes)
        qst = "".join(f"{aoff + a},"for a in astarts)
        boff = c2.sbeg
        tst = "".join(f"{boff + b},"for b in bstarts)

    return (f"{X}\t{S}\t0\t0\t{DB}\t{D}\t{IB}\t{I}\t{strand}\t"
            f"{short_name(s1.header)}\t{s1.slen}\t"
            f"{aoff + abpos}\t{aoff + aepos}\t"
            f"{short_name(s2.header)}\t{s2.slen}\t{tpos[0]}\t{tpos[1]}\t"
            f"{bcnt}\t{bsz}\t{qst}\t{tst}")


def write_psl(overlaps: Iterable[Overlap], gdb1: GDB, gdb2: GDB,
              get_a, get_b, tspace: int, out: IO[str]):
    """get_a(contig)/get_b(contig, comp) supply numeric sequences."""
    for o in overlaps:
        A = get_a(o.aread)
        B = get_b(o.bread, o.bcomp)
        out.write(psl_line(o, gdb1, gdb2, A, B, tspace) + "\n")
