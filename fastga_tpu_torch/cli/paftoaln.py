# Copied from fastga_tpu/cli/paftoaln.py; imports point at fastga_tpu_torch.
"""paftoaln — PAF with =/X CIGARs -> .1aln (PAFtoALN.c surface).

    python -m fastga_tpu_torch.cli.paftoaln [-T<int(8)>] <alignments>[.paf]
        <source1>[.1gdb|<fa_extn>] [<source2>[...]]

Each PAF line becomes one 'a' chain group whose alignment is split into
per-contig records with per-100bp trace points (cigar2tp PAFtoALN.c:215);
indels longer than the 8-bit trace budget split records with 'p' gap lines
between them.  M ops are rejected (=/X required).
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import alncode

USAGE = ("[-T<int(8)>] <alignments:path>[.paf] <source1:path>[.1gdb|fa] "
         "[<source2:path>[...]]")

TSPACE = 100

#      0 = no-op (H,P)   1 = A only (I,S)   2 = B only (D,N)
#      3 = match (=)     4 = mismatch (X)   5 = M (rejected)
_INTERP = {"=": 3, "X": 4, "x": 4, "M": 5, "m": 5, "I": 1, "i": 1,
           "S": 1, "s": 1, "D": 2, "d": 2, "N": 2, "n": 2, "H": 0,
           "h": 0, "P": 0, "p": 0}


def _parse_cigar(s: str):
    ops = []
    i = 0
    n = len(s)
    while i < n:
        ln = 0
        while i < n and s[i].isdigit():
            ln = 10 * ln + int(s[i])
            i += 1
        if ln == 0:
            ln = 1
        c = s[i]
        i += 1
        x = _INTERP.get(c)
        if x is None:
            raise _common.ArgError("paftoaln", f"Invalid Cigar symbol {c}")
        ops.append((x, ln, c))
    return ops


class _Cursor:
    """(apos, bpos, op index, remaining length) over a parsed CIGAR."""

    __slots__ = ("ops", "i", "len", "apos", "bpos")

    def __init__(self, ops, apos, bpos):
        self.ops = ops
        self.i = 0
        self.len = 0
        self.apos = apos
        self.bpos = bpos

    def at_end(self):
        return self.i >= len(self.ops) and self.len <= 0

    def cur(self):
        """(interp, remaining length) of the pending command."""
        if self.len > 0:
            return self.ops[self.i][0], self.len
        return self.ops[self.i][0], self.ops[self.i][1]

    def prefix(self):
        """Skip until both coords >= 0 and next command is diagonal
        (cigarPrefix PAFtoALN.c:146-188)."""
        apos, bpos = self.apos, self.bpos
        ln = self.len
        while self.i < len(self.ops):
            x, full, _ = self.ops[self.i]
            if ln <= 0:
                ln = full
            if x >= 3:
                if apos >= 0 and bpos > 0:
                    break
                if apos < 0 and apos + ln >= 0:
                    ln += apos
                    bpos -= apos
                    apos = 0
                    if bpos >= 0:
                        break
                if bpos < 0 and bpos + ln >= 0:
                    ln += bpos
                    apos -= bpos
                    bpos = 0
                    if apos >= 0:
                        break
                apos += ln
                bpos += ln
            elif x == 2:
                bpos += ln
            elif x == 1:
                apos += ln
            ln = 0
            self.i += 1
        self.len = ln
        self.apos = apos
        self.bpos = bpos


def _cigar2tp(C: _Cursor, aend: int, bend: int, tspace: int):
    """One record's trace points; stops at contig ends or trace-byte
    overflow (cigar2tp PAFtoALN.c:215-335).  Returns (trace pairs, diffs)
    and leaves C at the stopping command with C.len = pending length."""
    diff = dlast = 0
    bpos = blast = C.bpos
    apos = C.apos
    anext = (apos // tspace + 1) * tspace
    trace = []
    slen = 0
    ln = C.len
    while C.i < len(C.ops):
        x, full, _ = C.ops[C.i]
        if ln <= 0:
            ln = full
        if apos >= aend or bpos >= bend:
            slen = ln
            break
        if (x >= 3 or x == 1) and apos + ln > aend:
            slen = (apos + ln) - aend
            ln = aend - apos
        if x >= 2 and bpos + ln > bend:
            slen = (bpos + ln + slen) - bend
            ln = bend - bpos
        if x == 4:
            while apos + ln > anext:
                inc = anext - apos
                apos += inc
                bpos += inc
                diff += inc
                ln -= inc
                anext += tspace
                trace.append((diff - dlast, bpos - blast))
                blast, dlast = bpos, diff
            apos += ln
            bpos += ln
            diff += ln
        elif x == 3:
            while apos + ln > anext:
                inc = anext - apos
                apos += inc
                bpos += inc
                ln -= inc
                anext += tspace
                trace.append((diff - dlast, bpos - blast))
                blast, dlast = bpos, diff
            apos += ln
            bpos += ln
        elif x == 2:
            if (bpos - blast) + ln + (anext - apos) > 200:
                slen += ln
            else:
                bpos += ln
                diff += ln
        elif x == 1:
            if tspace + ln > 200:
                slen += ln
            else:
                while apos + ln > anext:
                    inc = anext - apos
                    apos += inc
                    diff += inc
                    ln -= inc
                    anext += tspace
                    trace.append((diff - dlast, bpos - blast))
                    blast, dlast = bpos, diff
                apos += ln
                diff += ln
        if slen > 0:
            break
        ln = 0
        C.i += 1
    if apos > anext - tspace:
        trace.append((diff - dlast, bpos - blast))
    C.apos = apos
    C.bpos = bpos
    C.len = slen
    return trace, diff


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="", opts="T")
    if not 2 <= len(pos) <= 3:
        raise _common.ArgError("paftoaln", "expects paf and 1-2 sources",
                               USAGE)
    paf = Path(pos[0])
    if not paf.name.endswith(".paf"):
        q = Path(str(paf) + ".paf")
        paf = q if q.exists() else paf
    gdb1 = _common.resolve_gdb(pos[1])
    istwo = len(pos) == 3
    gdb2 = _common.resolve_gdb(pos[2]) if istwo else gdb1

    names1 = {s.header.split()[0]: i for i, s in enumerate(gdb1.scaffolds)}
    names2 = ({s.header.split()[0]: i for i, s in enumerate(gdb2.scaffolds)}
              if istwo else names1)
    ctg1, scf1 = gdb1.contigs, gdb1.scaffolds
    ctg2, scf2 = gdb2.contigs, gdb2.scaffolds

    aroot = paf.name[:-4] if paf.name.endswith(".paf") else paf.name
    out = paf.parent / (aroot + ".1aln")
    import os
    w = alncode.AlnWriter(out, TSPACE, str(Path(pos[1]).resolve()),
                          str(Path(pos[2]).resolve()) if istwo else None,
                          os.getcwd(), prog="paftoaln",
                          command="paftoaln " + " ".join(argv))
    w.write_skeleton(gdb1)
    if istwo:
        w.write_skeleton(gdb2)

    for lineno, raw in enumerate(open(paf), 1):
        fld = raw.split()
        if not fld:
            continue
        if len(fld) < 11:
            raise _common.ArgError("paftoaln",
                                   f"line {lineno} has fewer than 11 fields")
        if fld[0] not in names1 or int(fld[1]) != \
                scf1[names1[fld[0]]].slen:
            raise _common.ArgError(
                "paftoaln", f"scaffold {fld[0]} not in first source")
        s1 = names1[fld[0]]
        abeg, aend_s = int(fld[2]), int(fld[3])
        a = scf1[s1].fctg
        while a < scf1[s1].ectg - 1 and abeg >= \
                ctg1[a].sbeg + ctg1[a].clen:
            a += 1
        abpos = abeg - ctg1[a].sbeg
        aepos = aend_s - ctg1[a].sbeg

        if fld[5] not in names2 or int(fld[6]) != \
                scf2[names2[fld[5]]].slen:
            raise _common.ArgError(
                "paftoaln", f"scaffold {fld[5]} not in second source")
        s2 = names2[fld[5]]
        bbeg, bend_s = int(fld[7]), int(fld[8])
        comp = fld[4] == "-"
        if comp:
            b = scf2[s2].ectg - 1
            while b > scf2[s2].fctg and bend_s <= ctg2[b].sbeg:
                b -= 1
            bbpos = (ctg2[b].sbeg + ctg2[b].clen) - bend_s
            bepos = (ctg2[b].sbeg + ctg2[b].clen) - bbeg
        else:
            b = scf2[s2].fctg
            while b < scf2[s2].ectg - 1 and bbeg >= \
                    ctg2[b].sbeg + ctg2[b].clen:
                b += 1
            bbpos = bbeg - ctg2[b].sbeg
            bepos = bend_s - ctg2[b].sbeg

        cg = next((f[5:] for f in fld[11:] if f.startswith("cg:Z:")), None)
        if cg is None:
            raise _common.ArgError(
                "paftoaln", f"PAF line {lineno} is missing a CIGAR string")
        ops = _parse_cigar(cg)
        if any(x == 5 for x, _, _ in ops):
            raise _common.ArgError(
                "paftoaln", "PAF CIGAR string uses M, should be X & =")
        # span check
        ap, bp = abpos, bbpos
        for x, ln, _ in ops:
            if x >= 3:
                ap += ln
                bp += ln
            elif x == 2:
                bp += ln
            elif x == 1:
                ap += ln
        if ap != aepos or bp != bepos:
            raise _common.ArgError(
                "paftoaln", "Cigar span and alignment intervals do not "
                "match")
        if comp:
            ops = ops[::-1]

        aend = ctg1[a].clen
        bend = ctg2[b].clen
        w.w.write("a")
        C = _Cursor(ops, abpos, bbpos)
        C.prefix()
        while True:
            r_abpos, r_bbpos = C.apos, C.bpos
            trace, diffs = _cigar2tp(C, aend, bend, TSPACE)
            o = alncode.Overlap(a, b, r_abpos, C.apos, r_bbpos, C.bpos,
                                diffs, comp, trace)
            w.write_overlap(o)
            if C.at_end():
                break
            adel = bdel = 0
            x, _ = C.cur()
            if x == 1:
                adel += C.len
                C.apos += C.len
                C.i += 1
                C.len = 0
            elif x == 2:
                bdel += C.len
                C.bpos += C.len
                C.i += 1
                C.len = 0
            while C.apos >= aend:
                C.apos += ctg1[a].sbeg
                a += 1
                C.apos -= ctg1[a].sbeg
                aend = ctg1[a].clen
            while C.bpos >= bend:
                if comp:
                    C.bpos -= ctg2[b].sbeg + ctg2[b].clen
                    b -= 1
                    C.bpos += ctg2[b].sbeg + ctg2[b].clen
                else:
                    C.bpos += ctg2[b].sbeg
                    b += 1
                    C.bpos -= ctg2[b].sbeg
                bend = ctg2[b].clen
            adel -= C.apos
            bdel -= C.bpos
            C.prefix()
            adel += C.apos
            bdel += C.bpos
            if adel + bdel > 0:
                w.w.write("p", adel, bdel)
            if C.at_end():
                break
    w.close()
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
