# Copied from fastga_tpu/cli/alnshow.py; imports point at fastga_tpu_torch.
"""alnshow — display .1aln alignments (reference ALNshow.c surface).

    python -m fastga_tpu_torch.cli.alnshow [-anrU] [-i<int(4)>] [-w<int(100)>]
        [-b<int(10)>] <alignments>[.1aln] [<selection> [<selection>]]

Line mode lists records with scaffold coordinates; -a/-r reconstruct the
exact alignment (tracerec) and render BLAST-style rows (io/show).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from . import _common
from ..io import show as showm
from ..ops import tracerec
from ..utils import dna
from ..utils import select as selm
from ..utils.fmt import comma_number, number_digits

USAGE = ("[-anrU] [-i<int(4)>] [-w<int(100)>] [-b<int(10)>] "
         "<alignments:path>[.1aln] [<selection>|<FILE> [<selection>|<FILE>]]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="anrU", opts="iwb")
    if not 1 <= len(pos) <= 3:
        raise _common.ArgError("alnshow", "expects 1-3 arguments", USAGE)
    ALIGN = opts["a"]
    REF = opts["r"]
    NAMES = opts["n"]
    UPPER = opts["U"]
    INDENT = _common.opt_int(opts, "i", 4)
    WIDTH = _common.opt_int(opts, "w", 100)
    BORDER = _common.opt_int(opts, "b", 10)

    af, gdb1, gdb2 = _common.open_aln(pos[0], "alnshow")
    istwo = gdb2 is not gdb1
    out = sys.stdout

    anames = selm.scaffold_names(gdb1)
    bnames = selm.scaffold_names(gdb2) if istwo else anames
    try:
        achord = selm.get_selection_contigs(pos[1] if len(pos) > 1 else None,
                                            gdb1, anames)
        bchord = selm.get_selection_contigs(pos[2] if len(pos) > 2 else None,
                                            gdb2, bnames)
    except selm.SelectError as e:
        raise _common.ArgError("alnshow", str(e), USAGE)

    amaxlen = max((s.slen for s in gdb1.scaffolds), default=0)
    bmaxlen = max((s.slen for s in gdb2.scaffolds), default=0)
    actgmax = max((s.ectg - s.fctg for s in gdb1.scaffolds), default=0)
    bctgmax = max((s.ectg - s.fctg for s in gdb2.scaffolds), default=0)
    tspace = af.tspace

    if ALIGN or REF:
        ar_wide = br_wide = ai_wide = bi_wide = 0
        ac_wide = bc_wide = mn_wide = tp_wide = 0
        mx_wide = number_digits(max(amaxlen, bmaxlen))
    else:
        mx_wide = 0
        ar_wide = number_digits(gdb1.nscaff)
        ai_wide = number_digits(amaxlen)
        ac_wide = number_digits(actgmax + 1)
        br_wide = number_digits(gdb2.nscaff)
        bi_wide = number_digits(bmaxlen)
        bc_wide = number_digits(bctgmax + 1)
        mctg = min(gdb1.maxctg, gdb2.maxctg)
        mn_wide = number_digits(mctg)
        tp_wide = number_digits(mctg // tspace + 2) if tspace > 0 else 0
        ar_wide += (ar_wide - 1) // 3
        br_wide += (br_wide - 1) // 3
        ai_wide += (ai_wide - 1) // 3
        bi_wide += (bi_wide - 1) // 3
        mn_wide += (mn_wide - 1) // 3
        tp_wide += (tp_wide - 1) // 3

    rootname = Path(pos[0]).name
    if rootname.endswith(".1aln"):
        rootname = rootname[:-5]
    out.write(f"\n{rootname}: {comma_number(len(af.overlaps))} records\n")

    acache = {}
    bcache = {}

    def get_actg(c):
        if c not in acache:
            acache.clear()
            acache[c] = gdb1.get_contig(c)
        return acache[c]

    def get_bctg(c):
        if c not in bcache:
            bcache.clear()
            bcache[c] = gdb2.get_contig(c)
        return bcache[c]

    for o in af.overlaps:
        aptr = achord[o.aread]
        if not aptr.order:
            continue
        bptr = bchord[o.bread]
        if not bptr.order:
            continue
        if o.aepos <= aptr.beg or o.abpos >= aptr.end:
            continue
        if o.bepos <= bptr.beg or o.bbpos >= bptr.end:
            continue
        if bptr.orient != 0:
            want_comp = (aptr.orient >= 0 > bptr.orient
                         or aptr.orient < 0 <= bptr.orient)
            if want_comp != o.bcomp:
                continue

        actg = gdb1.contigs[o.aread]
        bctg = gdb2.contigs[o.bread]
        ascaf, bscaf = actg.scaf, bctg.scaf
        aoffs, boffs = actg.sbeg, bctg.sbeg
        aclen, bclen = actg.clen, bctg.clen
        aslen = gdb1.scaffolds[ascaf].slen
        bslen = gdb2.scaffolds[bscaf].slen
        tps = len(o.trace)
        reverse = aptr.orient < 0

        if ALIGN or REF:
            out.write("\n")
        if NAMES:
            out.write(gdb1.scaffolds[ascaf].header.split()[0])
        else:
            out.write(comma_number(ascaf + 1, ar_wide + 1))
        out.write(f".{o.aread - gdb1.scaffolds[ascaf].fctg + 1:0{ac_wide}d}"
                  f"{'c' if reverse else 'n'}")
        out.write("  ")
        if NAMES:
            out.write(gdb2.scaffolds[bscaf].header.split()[0])
        else:
            out.write(comma_number(bscaf + 1, br_wide + 1))
        out.write(f".{o.bread - gdb2.scaffolds[bscaf].fctg + 1:0{bc_wide}d}"
                  f"{'c' if (not o.bcomp) == reverse else 'n'}")

        if reverse:
            ab, ae = aoffs + o.aepos, aoffs + o.abpos
        else:
            ab, ae = aoffs + o.abpos, aoffs + o.aepos
        out.write("   <" if ab in (0, aslen) else "   [")
        out.write(comma_number(ab, ai_wide))
        out.write("..")
        out.write(comma_number(ae, ai_wide))
        out.write("> x " if ae in (0, aslen) else "] x ")
        if o.bcomp:
            bb, be = boffs + (bclen - o.bbpos), boffs + (bclen - o.bepos)
        else:
            bb, be = boffs + o.bbpos, boffs + o.bepos
        if reverse:
            bb, be = be, bb
        out.write("<" if bb in (0, bslen) else "[")
        out.write(comma_number(bb, bi_wide))
        out.write("..")
        out.write(comma_number(be, bi_wide))
        out.write(">" if be in (0, bslen) else "]")

        if not (ALIGN or REF):
            pct = (200.0 * o.diffs) / ((o.aepos - o.abpos)
                                       + (o.bepos - o.bbpos))
            out.write(f"  ~  {pct:5.2f}%   ({comma_number(aslen, ai_wide)}"
                      f" x {comma_number(bslen, bi_wide)} bps,"
                      f"{comma_number(o.diffs, mn_wide)} diffs, "
                      f"{comma_number(tps, tp_wide)} trace pts)\n")
            continue

        # exact alignment display
        self_cmp = (not istwo) and o.aread == o.bread and not o.bcomp
        A = get_actg(o.aread)
        Bf = A if self_cmp else get_bctg(o.bread)
        Bor = dna.revcomp(Bf) if o.bcomp else Bf
        trace, diffs = tracerec.compute_trace_pts(
            A, Bor, o.abpos, o.aepos, o.bbpos, o.bepos, o.trace, tspace,
            selfie=self_cmp)
        trace, diffs = tracerec.gap_improver(
            A, Bor, o.abpos, o.bbpos, o.aepos, len(A), len(Bor),
            trace, diffs)

        pct = (200.0 * diffs) / ((o.aepos - o.abpos) + (o.bepos - o.bbpos))
        out.write(f"  ~  {pct:5.2f}%   ({comma_number(aslen, ai_wide)}"
                  f" x {comma_number(bslen, bi_wide)} bps, "
                  f"{comma_number(diffs)} diffs, "
                  f"{comma_number(tps)} trace pts)\n")

        abpos, aepos = o.abpos, o.aepos
        bbpos, bepos = o.bbpos, o.bepos
        Adisp, Bdisp = A, Bor
        if reverse:
            Adisp = dna.revcomp(A)
            Bdisp = dna.revcomp(Bor)
            abpos, aepos = aclen - aepos, aclen - abpos
            bbpos, bepos = bclen - bepos, bclen - bbpos
            trace = [-(aclen + 2 + t) if t < 0 else (bclen + 2) - t
                     for t in reversed(trace)]

        # scaffold-coordinate shift
        abpos += aoffs
        aepos += aoffs
        bbpos += boffs
        bepos += boffs
        alen_disp = 2 * aoffs + aclen if reverse else 0
        blen_disp = 2 * boffs + bclen if (not o.bcomp) == reverse else 0
        trace = [t - aoffs if t < 0 else t + boffs for t in trace]
        a1 = showm.Seq1(Adisp, aoffs)
        b1 = showm.Seq1(Bdisp, boffs)

        kwargs = dict(indent=INDENT, border=BORDER, upper=UPPER,
                      coord=mx_wide, acomp=reverse,
                      bcomp=(not o.bcomp) == reverse,
                      alen=alen_disp, blen=blen_disp)
        if REF:
            showm.print_reference(out, a1, b1, trace, abpos, aepos,
                                  bbpos, bepos, block=WIDTH, **kwargs)
        if ALIGN:
            showm.print_alignment(out, a1, b1, trace, abpos, aepos,
                                  bbpos, bepos, width=WIDTH, **kwargs)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
