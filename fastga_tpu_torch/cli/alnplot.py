# Copied from fastga_tpu/cli/alnplot.py; imports point at fastga_tpu_torch.
"""alnplot — static dot plot of a .1aln or PAF to EPS/PDF (ALNplot.c).

    python -m fastga_tpu_torch.cli.alnplot [-vGSL] [-T<int(4)>] [-p[:<out>[.pdf]]]
        [-l<int(100)>] [-i<float(.7)>] [-n<int(100000)>]
        [-H<int(600)>] [-W<int>] [-f<int>] [-t<float>]
        <alignment>[.1aln|.paf[.gz]] [<selection> [<selection>]]

EPS written to stdout (or converted via an external [e]ps[to|2]pdf with
-p).  Forward matches red, complement blue; axis layout, grid, Helvetica
label sizing and the length filter reproduce the reference.
"""

from __future__ import annotations

import gzip
import struct
import subprocess
import sys
from pathlib import Path
from typing import IO, List

import numpy as np

from . import _common
from ..io import alncode
from ..io.gdb import GDB, Contig, Scaffold
from ..utils import select as selm
from ..utils.fmt import number_digits

USAGE = ("[-vGSL] [-T<int(4)>] [-p[:<output:path>[.pdf]]] [-l<int(100)>] "
         "[-i<float(.7)>] [-n<int(100000)>] [-H<int(600)>] [-W<int>] "
         "[-f<int>] [-t<float>] <alignment:path>[.1aln|.paf[.gz]] "
         "[<selection> [<selection>]]")

MAX_XY_LEN = 10000
MIN_XY_LEN = 100
MAX_LAB_LEN = 20
MAX_LAB_FRC = .2

G_COLOR = 0x808080
N_COLOR = 0xFF0000
C_COLOR = 0x0080FF

DEL_FLAG, COL_GRAY, COL_RED, COL_BLUE = 0x1, 0x2, 0x4, 0x8

HELVETICA = [0.0] * 32 + [
    0.278, 0.278, 0.355, 0.556, 0.556, 0.889, 0.667, 0.222, 0.333, 0.333,
    0.389, 0.584, 0.278, 0.333, 0.278, 0.278, 0.556, 0.556, 0.556, 0.556,
    0.556, 0.556, 0.556, 0.556, 0.556, 0.556, 0.278, 0.278, 0.584, 0.584,
    0.584, 0.556, 1.015, 0.667, 0.667, 0.722, 0.722, 0.667, 0.611, 0.778,
    0.722, 0.278, 0.500, 0.667, 0.556, 0.833, 0.722, 0.778, 0.667, 0.778,
    0.722, 0.667, 0.611, 0.722, 0.667, 0.944, 0.667, 0.667, 0.611, 0.278,
    0.278, 0.278, 0.469, 0.556, 0.222, 0.556, 0.556, 0.500, 0.556, 0.556,
    0.278, 0.556, 0.556, 0.222, 0.222, 0.500, 0.222, 0.833, 0.556, 0.556,
    0.556, 0.556, 0.333, 0.500, 0.278, 0.556, 0.500, 0.722, 0.500, 0.500,
    0.500, 0.334, 0.260, 0.334, 0.584, 0.000]


def _g(x) -> str:
    """C's printf %g of a value cast to float."""
    return f"{float(np.float32(x)):g}"


class Seg:
    __slots__ = ("flag", "aread", "bread", "abpos", "aepos", "bbpos",
                 "bepos")

    def __init__(self, aread, abpos, aepos, bread, bbpos, bepos):
        self.flag = 0
        self.aread, self.abpos, self.aepos = aread, abpos, aepos
        self.bread, self.bbpos, self.bepos = bread, bbpos, bepos


def _read_1aln(path, minalen, minaidnt):
    af, gdb1, gdb2 = _common.open_aln(str(path), "alnplot")
    segs = []
    for o in af.overlaps:
        if o.aepos - o.abpos < minalen or o.bepos - o.bbpos < minalen:
            continue
        blocksum = (o.aepos - o.abpos) + (o.bepos - o.bbpos)
        iid = (blocksum - o.diffs) // 2
        if 2.0 * iid / blocksum < minaidnt:
            continue
        bb, be = o.bbpos, o.bepos
        if o.bcomp:
            clen = gdb2.contigs[o.bread].clen
            bb, be = clen - bb, clen - be
        segs.append(Seg(o.aread, o.abpos, o.aepos, o.bread, bb, be))
    return segs, gdb1, gdb2


def _read_paf(path, gzipd, minalen, minaidnt):
    opener = gzip.open if gzipd else open
    anames, bnames = {}, {}
    alens, blens = [], []
    segs = []
    with opener(path, "rt") as f:
        for line in f:
            fld = line.rstrip("\n").split("\t")
            if len(fld) < 11:
                continue
            if fld[0] not in anames:
                anames[fld[0]] = len(alens)
                alens.append(int(fld[1]))
            aread = anames[fld[0]]
            abpos, aepos = int(fld[2]), int(fld[3])
            if fld[5] not in bnames:
                bnames[fld[5]] = len(blens)
                blens.append(int(fld[6]))
            bread = bnames[fld[5]]
            bbpos, bepos = int(fld[7]), int(fld[8])
            if aepos - abpos < minalen or bepos - bbpos < minalen:
                continue
            blocksum = (aepos - abpos) + (bepos - bbpos)
            iid = int(fld[9])
            if 2.0 * iid / blocksum < minaidnt:
                continue
            if fld[4] == "-":
                bbpos, bepos = bepos, bbpos
            segs.append(Seg(aread, abpos, aepos, bread, bbpos, bepos))

    def mkgdb(names, lens):
        g = GDB()
        for name, i in names.items():
            g.scaffolds.append(Scaffold(lens[i], i, i + 1, name))
            g.contigs.append(Contig(lens[i], 0, 0, i))
            g.seqtot += lens[i]
        return g

    return segs, mkgdb(anames, alens), mkgdb(bnames, blens)


def myers_clip(seg, xmin, xmax, ymin, ymax):
    """Clip (abpos,bbpos)-(aepos,bepos) to the box; -1 if fully outside
    (myers_clip ALNplot.c:1087-1150; x = a axis, y = b axis)."""
    nx1, ny1, nx2, ny2 = seg.abpos, seg.bbpos, seg.aepos, seg.bepos
    inter = 0
    flipx = nx1 > nx2
    if flipx:
        x1, x2, y1, y2 = float(nx2), float(nx1), float(ny2), float(ny1)
    else:
        x1, x2, y1, y2 = float(nx1), float(nx2), float(ny1), float(ny2)
    if x2 <= xmin or x1 >= xmax:
        return -1
    flipy = y1 > y2
    if flipy:
        x1, x2 = x2, x1
        y1, y2 = y2, y1
    if y2 <= ymin or y1 >= ymax:
        return -1
    if y2 > ymax:
        x2 = x1 + (x2 - x1) * (ymax - y1) / (y2 - y1)
        y2 = ymax
        inter = 1
    if y1 < ymin:
        x1 = x1 + (x2 - x1) * (ymin - y1) / (y2 - y1)
        y1 = ymin
        inter = 1
    if flipy:
        x1, x2 = x2, x1
        y1, y2 = y2, y1
    if x2 > xmax:
        if x1 >= xmax:
            return -1
        y2 = y1 + (y2 - y1) * (xmax - x1) / (x2 - x1)
        x2 = xmax
        inter = 1
    if x1 < xmin:
        if x2 <= xmin:
            return -1
        y1 = y1 + (y2 - y1) * (xmin - x1) / (x2 - x1)
        x1 = xmin
        inter = 1
    if inter:
        if flipx:
            seg.abpos = int(x2 + .499)
            seg.aepos = int(x1 + .499)
            seg.bbpos = int(y2 + .499)
            seg.bepos = int(y1 + .499)
        else:
            seg.abpos = int(x1 + .499)
            seg.aepos = int(x2 + .499)
            seg.bbpos = int(y1 + .499)
            seg.bepos = int(y2 + .499)
    return 0


def axis_config(gdb, chord, labels, printsid):
    """Axis layout: contig offsets, per-sequence tick offsets, and label
    strings (axisConfig ALNplot.c:938-1039)."""
    sarr = [(abs(chord[i].order), i) for i in range(gdb.ncontig)
            if chord[i].order]
    sarr.sort()
    caxis = [0] * gdb.ncontig
    saxis = []
    names = []

    def add_name(c0, c1, s, orien):
        if printsid:
            nm = str(s + 1)
        else:
            nm = gdb.scaffolds[s].header.split()[0]
        sc = gdb.scaffolds[s]
        if (chord[c0].beg > 0 or sc.fctg != c0 or sc.ectg != c1 + 1
                or chord[c1].end != gdb.contigs[c1].clen):
            p = gdb.contigs[c0].sbeg + chord[c0].beg + 1
            nm += f"_{p}"
            p = gdb.contigs[c1].sbeg + chord[c1].end
            nm += f"-{p}"
        if orien < 0:
            nm += "'"
        if len(nm) > MAX_LAB_LEN:
            if orien < 0:
                nm = nm[:MAX_LAB_LEN - 3] + "*" + nm[-2:]
            else:
                nm = nm[:MAX_LAB_LEN - 2] + "*" + nm[-1:]
        names.append(nm)

    def axis_reverse(lo, hi, soff):
        coff = caxis[sarr[lo][1]]
        s = soff
        for k in range(lo, hi):
            c = sarr[k][1]
            s -= caxis[c] - coff
            clen = chord[c].end - chord[c].beg
            s -= clen
            coff = caxis[c] + clen
            caxis[c] = s

    tseq = 0
    j = 0
    c1 = sarr[0][1]
    o1 = chord[c1].orient
    r1 = chord[c1].order
    i = 1
    while i < len(sarr):
        caxis[c1] = tseq - chord[c1].beg
        tseq += chord[c1].end - chord[c1].beg
        c2 = sarr[i][1]
        r2 = chord[c2].order
        o2 = chord[c2].orient
        if (chord[c1].end < gdb.contigs[c1].clen or c1 + 1 < c2
                or gdb.contigs[c1].scaf != gdb.contigs[c2].scaf
                or r1 != r2 or o1 != o2 or chord[c2].beg > 0):
            c0 = sarr[j][1]
            if labels:
                add_name(c0, c1, gdb.contigs[c0].scaf, o1)
            saxis.append(tseq)
            if o1 < 0:
                axis_reverse(j, i, tseq)
            j = i
        else:
            tseq += (gdb.contigs[c2].sbeg - gdb.contigs[c1].sbeg
                     - gdb.contigs[c1].clen)
        c1, r1, o1 = c2, r2, o2
        i += 1
    caxis[c1] = tseq - chord[c1].beg
    tseq += chord[c1].end - chord[c1].beg
    c0 = sarr[j][1]
    if labels:
        add_name(c0, c1, gdb.contigs[c0].scaf, o1)
    saxis.append(tseq)
    if o1 < 0:
        axis_reverse(j, i, tseq)
    return caxis, saxis, names, tseq


def _name_width(names):
    return max((sum(HELVETICA[ord(c)] for c in nm) for nm in names),
               default=0.0)


def _name_render_width(names, soff, unit, space):
    w = 0.0
    for i, nm in enumerate(names):
        s = soff[0] if i == 0 else soff[i] - soff[i - 1]
        if s * unit < space:
            continue
        w = max(w, sum(HELVETICA[ord(c)] for c in nm))
    return w


def _font_by_height(soff, unit, minf, maxf):
    f = maxf
    for i in range(len(soff)):
        s = (soff[0] if i == 0 else soff[i] - soff[i - 1]) * unit
        if minf <= s < f:
            f = s
    return f


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    pdf = None
    rest = []
    for a in argv:
        if a == "-p" or a.startswith("-p:"):
            pdf = a[3:] if a.startswith("-p:") else ""
        else:
            rest.append(a)
    opts, pos = _common.parse_args(rest, flags="vGSL", opts="ftnilHTW")
    if not 1 <= len(pos) <= 3:
        raise _common.ArgError("alnplot", "expects 1-3 arguments", USAGE)
    verbose = opts["v"]
    printsid = opts["S"]
    nogrid = opts["G"]
    labels = not opts["L"]
    fontsize = _common.opt_int(opts, "f", 0)
    linesize = _common.opt_float(opts, "t", 0.0)
    maxalign = _common.opt_int(opts, "n", 100000)
    minaidnt = _common.opt_float(opts, "i", 0.7)
    minalen = _common.opt_int(opts, "l", 100)
    imgheigh = _common.opt_int(opts, "H", 0)
    imgwidth = _common.opt_int(opts, "W", 0)
    if not imgwidth and not imgheigh:
        imgheigh = 600

    # locate input: .1aln, .paf or .paf.gz
    src = Path(pos[0])
    cands = [src]
    for ext in (".1aln", ".paf", ".paf.gz"):
        cands.append(Path(str(src) + ext))
    found = next((c for c in cands if c.exists() and c.is_file()), None)
    if found is None:
        raise _common.ArgError("alnplot",
                               f"Cannot open {pos[0]} as a .1aln or .paf")
    if found.name.endswith(".1aln"):
        segs, agdb, bgdb = _read_1aln(found, minalen, minaidnt)
    else:
        segs, agdb, bgdb = _read_paf(found, found.name.endswith(".gz"),
                                     minalen, minaidnt)

    xsel = pos[1] if len(pos) > 1 and pos[1] != "-" else None
    ysel = pos[2] if len(pos) > 2 else None
    anames = selm.scaffold_names(agdb)
    bnames = selm.scaffold_names(bgdb)
    achord = selm.get_selection_contigs(xsel, agdb, anames, ordered=True)
    bchord = selm.get_selection_contigs(ysel, bgdb, bnames, ordered=True)
    for cr in achord:
        if cr.orient < 0:
            cr.order = -cr.order
    for cr in bchord:
        if cr.orient < 0:
            cr.order = -cr.order

    # clip + max-count filter (aln_filter ALNplot.c:1193-1266)
    nseg = 0
    for s in segs:
        if achord[s.aread].order == 0 or bchord[s.bread].order == 0:
            s.flag |= DEL_FLAG
            continue
        if myers_clip(s, achord[s.aread].beg, achord[s.aread].end,
                      bchord[s.bread].beg, bchord[s.bread].end) < 0:
            s.flag |= DEL_FLAG
        else:
            nseg += 1
    if maxalign and nseg > maxalign:
        lens = sorted((s.aepos - s.abpos for s in segs
                       if not s.flag & DEL_FLAG), reverse=True)
        alen = lens[maxalign - 1]
        digits = 1
        while (alen // digits) * digits >= .9 * alen:
            digits *= 10
        digits //= 10
        alen = (alen // digits) * digits
        nseg = 0
        for s in segs:
            if s.flag & DEL_FLAG:
                continue
            if s.aepos - s.abpos < alen:
                s.flag |= DEL_FLAG
            else:
                nseg += 1
        if verbose:
            sys.stderr.write(f"  Using length filter threshold {alen}\n"
                             f"  Selected {nseg} alignments to plot\n")

    if pdf is not None:
        tool = next((t for t in ("pstopdf", "epstopdf", "ps2pdf",
                                 "eps2pdf")
                     if subprocess.run(["which", t], capture_output=True
                                       ).returncode == 0), None)
        if tool is None:
            raise _common.ArgError(
                "alnplot", "Cannot find [e]ps[to|2]pdf needed for .pdf")
        name = pdf if pdf else str(found)
        for ext in (".pdf", ".1aln", ".paf.gz", ".paf"):
            if name.endswith(ext):
                name = name[:-len(ext)]
                break
        outeps = Path(name + ".eps")
        fo = open(outeps, "w")
    else:
        outeps = None
        fo = sys.stdout

    _make_plot(fo, segs, agdb, bgdb, achord, bchord, labels, printsid,
               nogrid, imgwidth, imgheigh, fontsize, linesize)

    if outeps is not None:
        fo.close()
        subprocess.run([tool, str(outeps)])
        outeps.unlink(missing_ok=True)
    return 0


def _make_plot(fo, segs, agdb, bgdb, achord, bchord, labels, printsid,
               nogrid, imgwidth, imgheigh, fontsize, linesize):
    cxoff, sxoff, xnames, txseq = axis_config(bgdb, bchord, labels,
                                              printsid)
    cyoff, syoff, ynames, tyseq = axis_config(agdb, achord, labels,
                                              printsid)

    # orient flips + colors (alnConfig)
    for s in segs:
        if s.flag & DEL_FLAG:
            continue
        if achord[s.aread].order < 0:
            l = agdb.contigs[s.aread].clen
            s.abpos, s.aepos = l - s.abpos, l - s.aepos
        if bchord[s.bread].order < 0:
            l = bgdb.contigs[s.bread].clen
            s.bbpos, s.bepos = l - s.bbpos, l - s.bepos
        a = s.abpos - s.aepos
        b = s.bbpos - s.bepos
        sign = lambda v: (v > 0) - (v < 0)
        s.flag |= COL_RED if sign(a) == sign(b) else COL_BLUE

    width = float(imgwidth)
    height = float(imgheigh)
    if height < 1e-6:
        height = int(width / txseq * tyseq + .499)
    if width < 1e-6:
        width = int(height / tyseq * txseq + .499)
    maxis = max(width, height)
    if maxis > MAX_XY_LEN:
        scale = MAX_XY_LEN / maxis
        width = int(width * scale + .499)
        height = int(height * scale + .499)
        width = max(width, MIN_XY_LEN)
        height = max(height, MIN_XY_LEN)
    maxis = min(width, height)
    if maxis < MIN_XY_LEN:
        scale = MIN_XY_LEN / maxis
        width = int(width * scale + .499)
        height = int(height * scale + .499)
        width = min(width, MAX_XY_LEN)
        height = min(height, MAX_XY_LEN)
    maxis = min(width, height)

    lsize = linesize if linesize > 1e-6 else maxis / 500
    bsize = lsize * 2
    gsize = lsize / 2
    sx = width / txseq
    sy = height / tyseq
    xmargin = bsize * 2
    ymargin = bsize * 2

    fsize = float(fontsize)
    if fsize < 1e-6:
        if labels:
            xf = _font_by_height(sxoff, sx, maxis / 100, maxis / 50)
            yf = _font_by_height(syoff, sy, maxis / 100, maxis / 50)
            fsize = min(xf, yf)
            xlabw = _name_width(xnames)
            ylabw = _name_width(ynames)
            if xlabw * fsize > height * MAX_LAB_FRC:
                fsize = height * MAX_LAB_FRC / xlabw
            if ylabw * fsize > width * MAX_LAB_FRC:
                fsize = width * MAX_LAB_FRC / ylabw
            fsize = int(fsize + .499)
        else:
            fsize = 10
    if labels:
        xlabw = _name_render_width(xnames, sxoff, sx, fsize)
        ylabw = _name_render_width(ynames, syoff, sy, fsize)
        xmargin += fsize * ylabw
        ymargin += fsize * xlabw
    xmargin += 1
    ymargin += 1

    w = fo.write
    w("%!PS-Adobe-3.0 EPSF-3.0\n")
    w(f"%%BoundingBox: 1 1 {_g(width + xmargin * 1.1 + bsize * 3 + 1.0)} "
      f"{_g(height + ymargin * 1.1 + bsize * 3 + 1.0)}\n\n")
    w("/C { dup 255 and 255 div exch dup -8 bitshift 255 and 255 div 3"
      " 1 roll -16 bitshift 255 and 255 div 3 1 roll setrgbcolor }"
      " bind def\n")
    w("/L { 4 2 roll moveto lineto } bind def\n")
    w("/LX { dup 4 -1 roll exch moveto lineto } bind def\n")
    w("/LY { dup 4 -1 roll moveto exch lineto } bind def\n")
    w("/LS { 3 1 roll moveto show } bind def\n")
    w("/MS { dup stringwidth pop 2 div 4 -1 roll exch sub 3 -1"
      " roll moveto show } bind def\n")
    w("/RS { dup stringwidth pop 4 -1 roll exch sub 3 -1 roll moveto show"
      " } bind def\n")
    w("/B { 4 copy 3 1 roll exch 6 2 roll 8 -2 roll moveto lineto"
      " lineto lineto closepath } bind def\n")
    w(f"{_g(lsize)} setlinewidth\n\n")
    w(f"/FS {int(fsize)} def\n")
    w("/FS4 FS 4 div def\n")
    w(f"/Helvetica-Narrow findfont FS scalefont setfont\n\n")
    w("/RightAlignedText {\n  /str exch def\n  /y exch def\n"
      "  /x exch def\n  str stringwidth pop\n  x exch sub\n  y moveto\n"
      "  str show\n} def\n\n")

    if labels:
        aoff = min(xmargin, ymargin) * 0.1
        for i, nm in enumerate(xnames):
            s = sxoff[0] if i == 0 else sxoff[i] - sxoff[i - 1]
            if sx * s >= fsize:
                prev = 0 if i == 0 else sxoff[i - 1]
                x = xmargin + bsize + .5 * (prev + sxoff[i]) * sx \
                    - fsize / 2
                w(f"/str ({nm}) def\ngsave\n{_g(x)} {_g(ymargin - aoff)} "
                  f"moveto\n{_g(270)} rotate\nstr show\ngrestore\n")
        for i, nm in enumerate(ynames):
            s = syoff[0] if i == 0 else syoff[i] - syoff[i - 1]
            if sy * s >= fsize:
                prev = 0 if i == 0 else syoff[i - 1]
                y = ymargin + bsize + .5 * (prev + syoff[i]) * sy \
                    - fsize / 2
                w(f"{_g(xmargin - aoff)} {_g(y)} ({nm}) RightAlignedText\n")

    if not nogrid:
        w(f"{_g(.6)} setgray\n")
        w(f"{_g(gsize)} setlinewidth\n")
        for i in range(len(syoff) - 1):
            w(f"{_g(xmargin)} {_g(xmargin + bsize * 2 + width)} "
              f"{_g(ymargin + bsize + syoff[i] * sy - gsize / 2)} LX\n")
        for i in range(len(sxoff) - 1):
            w(f"{_g(ymargin)} {_g(ymargin + bsize * 2 + height)} "
              f"{_g(xmargin + bsize + sxoff[i] * sx - gsize / 2)} LY\n")
        w("stroke\n")
        w(f"{_g(0)} setgray\n")
    w(f"{_g(bsize)} setlinewidth\n")
    w(f"{_g(xmargin)} {_g(xmargin + bsize * 2 + width)} "
      f"{_g(ymargin + bsize / 2)} LX\n")
    w(f"{_g(xmargin)} {_g(xmargin + bsize * 2 + width)} "
      f"{_g(ymargin + height + bsize * 3 / 2)} LX\n")
    w(f"{_g(ymargin)} {_g(ymargin + bsize * 2 + height)} "
      f"{_g(xmargin + bsize / 2)} LY\n")
    w(f"{_g(ymargin)} {_g(ymargin + bsize * 2 + height)} "
      f"{_g(xmargin + width + bsize * 3 / 2)} LY\n")
    w("stroke\n")

    xoff = xmargin + bsize
    yoff = ymargin + bsize
    w(f"{_g(lsize)} setlinewidth\n")
    for c, col in enumerate((G_COLOR, N_COLOR, C_COLOR)):
        w(f"stroke {col} C\n")
        iflag = 1 << (c + 1)
        for s in segs:
            if s.flag != iflag:
                continue
            x0 = xoff + (s.bbpos + cxoff[s.bread]) * sx
            x1 = xoff + (s.bepos + cxoff[s.bread]) * sx
            y0 = yoff + (s.abpos + cyoff[s.aread]) * sy
            y1 = yoff + (s.aepos + cyoff[s.aread]) * sy
            w(f"{_g(x0)} {_g(y0)} {_g(x1)} {_g(y1)} L\n")
        w("stroke\n")
    w("stroke showpage\n")


if __name__ == "__main__":
    _common.cli_exit(main)
