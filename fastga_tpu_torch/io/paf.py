# Copied from fastga_tpu/io/paf.py; imports point at fastga_tpu_torch.
"""PAF emission from alignment overlaps (ALNtoPAF equivalent).

Field semantics per ALNtoPAF.c:102-636: coordinates are *scaffold*-space
(contig sbeg offsets applied; complement records map B through
sbeg+clen - pos since stored b coords are in B-complement contig space).
Base mode: matches/blocklen are the trace-free approximations
iid=(aspan+bspan-diffs)/2, blocklen=(aspan+bspan)/2; `dv:f` uses the
reference's fixed-4-digit integer rounding; `df:i` = diffs.

CIGAR (-m/-x) and CS (-s/-S) modes reconstruct the exact alignment via
ops/tracerec (Compute_Trace_PTS + Gap_Improver) and emit cg:Z / cs:Z tags;
for complemented records the op list is reversed and, for cs, both
sequences complemented so the tag reads in target-forward orientation
(ALNtoPAF.c:486-594).
"""

from __future__ import annotations

from typing import IO, Iterable, List, Optional, Tuple

import numpy as np

from .alncode import Overlap
from .gdb import GDB
from ..ops import tracerec
from ..utils import dna

_MBASE = "ACGT"
_DBASE = "acgt"


def short_name(header: str) -> str:
    """GDB headers truncated to first white-space, as ALNtoPAF/ALNtoPSL
    do before emitting names (ALNtoPAF.c:763-783, ALNtoPSL.c:489-510)."""
    parts = header.split(None, 1)
    return parts[0] if parts else header


def paf_line(o: Overlap, gdb1: GDB, gdb2: GDB, swap: bool = False,
             tags_extra: str = "") -> str:
    c1 = gdb1.contigs[o.aread]
    c2 = gdb2.contigs[o.bread]
    s1 = gdb1.scaffolds[c1.scaf]
    s2 = gdb2.scaffolds[c2.scaf]
    aoff = c1.sbeg
    if o.bcomp:
        boff = c2.sbeg + c2.clen
        b0, b1 = boff - o.bepos, boff - o.bbpos
    else:
        boff = c2.sbeg
        b0, b1 = boff + o.bbpos, boff + o.bepos
    strand = "-" if o.bcomp else "+"
    q = (short_name(s1.header), s1.slen, aoff + o.abpos, aoff + o.aepos)
    t = (short_name(s2.header), s2.slen, b0, b1)
    if swap:
        q, t = t, q
    aspan = o.aepos - o.abpos
    blocksum = aspan + (o.bepos - o.bbpos)
    iid = (blocksum - o.diffs) // 2
    x = 10000 + (10000 * (aspan - iid)) // aspan if aspan else 10000
    dv = f"0.{(x//1000)%10}{(x//100)%10}{(x//10)%10}{x%10}"
    return (f"{q[0]}\t{q[1]}\t{q[2]}\t{q[3]}\t{strand}\t"
            f"{t[0]}\t{t[1]}\t{t[2]}\t{t[3]}\t"
            f"{iid}\t{blocksum//2}\t255\tdv:f:{dv}\tdf:i:{o.diffs}"
            f"{tags_extra}")


def write_paf(overlaps: Iterable[Overlap], gdb1: GDB, gdb2: GDB,
              out: IO[str], swap: bool = False):
    for o in overlaps:
        out.write(paf_line(o, gdb1, gdb2, swap) + "\n")


# -- exact-trace modes (cg:Z / cs:Z) ------------------------------------------


def exact_alignment(o: Overlap, A: np.ndarray, B: np.ndarray,
                    tspace: int) -> Tuple[list, int]:
    """(signed indel trace, diffs) after Compute_Trace_PTS + Gap_Improver.

    ``B`` must already be in alignment orientation (reverse complement for
    R records, with o.b* coords in complement space).
    """
    tr, diffs = tracerec.compute_trace_pts(
        A, B, o.abpos, o.aepos, o.bbpos, o.bepos, o.trace, tspace)
    return tracerec.gap_improver(A, B, o.abpos, o.bbpos, o.aepos,
                                 len(A), len(B), tr, diffs)


def cigar_string(cig: List[Tuple[str, int]], rev: bool, merge_m: bool,
                 swap: bool = False) -> str:
    """Render an (op,len) list; rev reverses (COMP records), merge_m folds
    '='/'X' runs into 'M' (the -m+-s combination), swap exchanges I/D."""
    if swap:
        cig = [("D" if op == "I" else "I" if op == "D" else op, ln)
               for op, ln in cig]
    ops = cig[::-1] if rev else cig
    if merge_m:
        parts = []
        j = 0
        for op, ln in ops:
            if op in ("I", "D"):
                if j:
                    parts.append(f"{j}M")
                    j = 0
                parts.append(f"{ln}{op}")
            else:
                j += ln
        if j:
            parts.append(f"{j}M")
        return "".join(parts)
    return "".join(f"{ln}{op}" for op, ln in ops)


def cs_string(cig: List[Tuple[str, int]], o: Overlap, A: np.ndarray,
              B: np.ndarray, short: bool, swap: bool = False) -> str:
    """cs:Z tag: '=SEQ'/':len' matches, '*ba' subs, '+a' query-ins,
    '-b' query-del (ALNtoPAF.c:525-594)."""
    Aw = np.asarray(A[o.abpos:o.aepos])
    Bw = np.asarray(B[o.bbpos:o.bepos])
    ops = cig
    if o.bcomp and not swap:
        Aw = dna.revcomp(Aw)
        Bw = dna.revcomp(Bw)
        ops = cig[::-1]
    if swap:
        Aw, Bw = Bw, Aw
        ops = [("D" if op == "I" else "I" if op == "D" else op, ln)
               for op, ln in ops]
    parts = []
    ai = bi = 0
    for op, ln in ops:
        if op == "=" and not short:
            parts.append("=" + "".join(_MBASE[c] for c in Aw[ai:ai + ln]))
            ai += ln
            bi += ln
        elif op in ("=", "M"):
            parts.append(f":{ln}")
            ai += ln
            bi += ln
        elif op == "X":
            for j in range(ln):
                parts.append("*" + _DBASE[Bw[bi + j]] + _DBASE[Aw[ai + j]])
            ai += ln
            bi += ln
        elif op == "I":
            parts.append("+" + "".join(_DBASE[c] for c in Aw[ai:ai + ln]))
            ai += ln
        elif op == "D":
            parts.append("-" + "".join(_DBASE[c] for c in Bw[bi:bi + ln]))
            bi += ln
    return "".join(parts)


def paf_line_exact(o: Overlap, gdb1: GDB, gdb2: GDB, A: np.ndarray,
                   B: np.ndarray, tspace: int, cigar_m: bool = False,
                   cigar_x: bool = False, cs: bool = False,
                   cs_short: bool = False, swap: bool = False) -> str:
    """PAF line with exact-trace tags (any of -m -x -s -S set)."""
    trace, diffs = exact_alignment(o, A, B, tspace)
    want_cs = cs or cs_short
    if cigar_m and not want_cs:
        cig, dele = tracerec.cigar_m(trace, o.abpos, o.aepos, o.bbpos)
    else:
        cig, dele = tracerec.cigar_x(trace, A, B, o.abpos, o.aepos, o.bbpos)

    aspan = o.aepos - o.abpos
    blocksum = aspan + dele
    iid = blocksum - diffs
    x = 10000 + (10000 * (aspan - iid)) // aspan if aspan else 10000
    dv = f"0.{(x//1000)%10}{(x//100)%10}{(x//10)%10}{x%10}"

    tags = [f"dv:f:{dv}", f"df:i:{diffs}"]
    if cigar_m or cigar_x:
        rev = o.bcomp and not swap
        tags.append("cg:Z:" + cigar_string(
            cig, rev, merge_m=cigar_m and want_cs, swap=swap))
    if want_cs:
        tags.append("cs:Z:" + cs_string(cig, o, A, B, cs_short, swap=swap))

    base = paf_line(o, gdb1, gdb2, swap)
    cols = base.split("\t")
    cols[9] = str(iid)
    cols[10] = str(blocksum)
    return "\t".join(cols[:12] + tags)
