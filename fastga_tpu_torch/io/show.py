# Copied from fastga_tpu/io/show.py; imports point at fastga_tpu_torch.
"""BLAST-style alignment displays (align.c Print_Alignment:4104-4362,
Print_Reference:4364-4642, Alignment_Cartoon:4652-4738).

Works from the signed-indel trace produced by ops/tracerec.  Sequences are
accessed through 1-based views that return the sentinel (4) outside their
valid window, reproducing the reference's bordered contig-piece buffers.
"""

from __future__ import annotations

from typing import IO, List

import numpy as np

_TO_L = "acgt.[]-"
_TO_U = "ACGT.[]-"


class Seq1:
    """1-based sequence view: self[i] = data[i - 1 - off], sentinel 4
    outside (the reference's `a = align->aseq - 1` pointer with contig-piece
    sentinels)."""

    __slots__ = ("data", "off")

    def __init__(self, data: np.ndarray, off: int):
        self.data = data
        self.off = off

    def __getitem__(self, i: int) -> int:
        k = i - 1 - self.off
        if 0 <= k < len(self.data):
            return int(self.data[k])
        return 4


class _Rows:
    """Column accumulator with width-based (Print_Alignment) or A-position
    block-based (Print_Reference) row flushing."""

    def __init__(self, out: IO[str], indent: int, width: int, upper: bool,
                 coord: int, aend: int, bend: int, acomp: bool, bcomp: bool,
                 alen: int, blen: int):
        self.out = out
        self.indent = indent
        self.width = width
        self.n2a = _TO_U if upper else _TO_L
        self.coord = coord
        self.aend = aend
        self.bend = bend
        self.acomp = acomp
        self.bcomp = bcomp
        self.alen = alen
        self.blen = blen
        self.abuf: List[str] = []
        self.bbuf: List[str] = []
        self.dbuf: List[str] = []
        self.sa = 0
        self.sb = 0
        self.match = 0
        self.diff = 0
        self.mtag = ":"
        self.dtag = ":"

    def _flush(self, i: int, j: int, final: bool = False):
        out = self.out
        o = len(self.abuf)
        out.write("\n")
        out.write(" " * self.indent)
        if self.coord > 0:
            if self.sa < self.aend:
                v = self.alen - self.sa if self.acomp else self.sa
                out.write(f" {v:>{self.coord}d}")
            else:
                out.write(" " + " " * self.coord)
            out.write(" " + "".join(self.abuf) + "\n")
            out.write(" " * self.indent + " " + " " * self.coord + " "
                      + "".join(self.dbuf) + "\n")
            out.write(" " * self.indent)
            if self.sb < self.bend:
                v = self.blen - self.sb if self.bcomp else self.sb
                out.write(f" {v:>{self.coord}d}")
            else:
                out.write(" " + " " * self.coord)
            out.write(" " + "".join(self.bbuf))
        else:
            out.write(" " + "".join(self.abuf) + "\n")
            out.write(" " * self.indent + " " + "".join(self.dbuf) + "\n")
            out.write(" " * self.indent + " " + "".join(self.bbuf))
        if final:
            if self.diff + self.match > 0:
                pct = (100.0 * self.diff) / (self.diff + self.match)
                out.write(f" {pct:5.1f}%\n")
            else:
                out.write("\n")
        else:
            if self.diff + self.match:
                pct = (100.0 * self.diff) / (self.diff + self.match)
                out.write(f" {pct:5.1f}%\n")
            else:
                out.write("  -nan%\n")   # C's %5.1f of 0./0
            self.abuf.clear()
            self.bbuf.clear()
            self.dbuf.clear()
            self.sa = i - 1
            self.sb = j - 1
            self.match = self.diff = 0
        del o

    def col(self, u: int, v: int, i: int, j: int):
        if len(self.abuf) >= self.width:
            self._flush(i, j)
        if u == 4 or v == 4:
            self.dbuf.append(" ")
        elif u == v:
            self.dbuf.append(self.mtag)
        else:
            self.dbuf.append(self.dtag)
        self.abuf.append(self.n2a[u])
        self.bbuf.append(self.n2a[v])


def _emit(out, a: Seq1, b: Seq1, trace, abpos, aepos, bbpos, bepos,
          indent, width, border, upper, coord, acomp, bcomp, alen, blen,
          by_block: bool):
    rows = _Rows(out, indent, width, upper, coord, aepos, bepos,
                 acomp, bcomp, alen, blen)
    i = abpos
    prefa = 0
    while prefa < border and a[i] != 4:
        prefa += 1
        i -= 1
    i += 1
    j = bbpos
    prefb = 0
    while prefb < border and b[j] != 4:
        prefb += 1
        j -= 1
    j += 1
    s0 = i
    rows.sa = i - 1
    rows.sb = j - 1

    if by_block:
        # Print_Reference: rows break when A-position crosses a block
        # boundary (i%block == 1, not at start, real base, row non-empty)
        base_col = rows.col

        def col(u, v, ci, cj):
            if (ci % width == 1 and ci != s0 and u < 4 and rows.abuf):
                rows._flush(ci, cj)
            if u == 4 or v == 4:
                rows.dbuf.append(" ")
            elif u == v:
                rows.dbuf.append(rows.mtag)
            else:
                rows.dbuf.append(rows.dtag)
            rows.abuf.append(rows.n2a[u])
            rows.bbuf.append(rows.n2a[v])
        del base_col
    else:
        col = rows.col

    rows.mtag = rows.dtag = ":"
    while prefa > prefb:
        col(a[i], 4, i, j)
        i += 1
        prefa -= 1
    while prefb > prefa:
        col(4, b[j], i, j)
        j += 1
        prefb -= 1
    while prefa > 0:
        col(a[i], b[j], i, j)
        i += 1
        j += 1
        prefa -= 1
    rows.mtag = "["
    had_pref = prefb > 0
    if had_pref:
        col(5, 5, i, j)

    rows.mtag = "|"
    rows.dtag = "*"
    rows.match = rows.diff = 0

    for p in trace:
        if p < 0:
            p = -p
            while i != p:
                col(a[i], b[j], i, j)
                if a[i] == b[j]:
                    rows.match += 1
                else:
                    rows.diff += 1
                i += 1
                j += 1
            col(7, b[j], i, j)
            j += 1
            rows.diff += 1
        else:
            while j != p:
                col(a[i], b[j], i, j)
                if a[i] == b[j]:
                    rows.match += 1
                else:
                    rows.diff += 1
                i += 1
                j += 1
            col(a[i], 7, i, j)
            i += 1
            rows.diff += 1
    while i <= aepos:
        col(a[i], b[j], i, j)
        if a[i] == b[j]:
            rows.match += 1
        else:
            rows.diff += 1
        i += 1
        j += 1

    rows.mtag = "]"
    if a[i] != 4 and b[j] != 4 and border > 0:
        col(6, 6, i, j)
    rows.mtag = rows.dtag = ":"
    c = 0
    while c < border and (a[i] != 4 or b[j] != 4):
        if a[i] != 4:
            if b[j] != 4:
                col(a[i], b[j], i, j)
                i += 1
                j += 1
            else:
                col(a[i], 4, i, j)
                i += 1
        else:
            col(4, b[j], i, j)
            j += 1
        c += 1

    rows._flush(i, j, final=True)


def print_alignment(out, a: Seq1, b: Seq1, trace, abpos, aepos, bbpos,
                    bepos, indent=4, width=100, border=10, upper=False,
                    coord=0, acomp=False, bcomp=False, alen=0, blen=0):
    """BLAST-style display, `width` columns per row (Print_Alignment).

    Note the reference's match/diff row percentages count columns in the
    order C evaluates them — the col() calls here preserve that order.
    """
    _emit(out, a, b, trace, abpos, aepos, bbpos, bepos, indent, width,
          border, upper, coord, acomp, bcomp, alen, blen, by_block=False)


def print_reference(out, a: Seq1, b: Seq1, trace, abpos, aepos, bbpos,
                    bepos, indent=4, block=100, border=10, upper=False,
                    coord=0, acomp=False, bcomp=False, alen=0, blen=0):
    """Display with `block` bps of A per row (Print_Reference)."""
    _emit(out, a, b, trace, abpos, aepos, bbpos, bepos, indent, block,
          border, upper, coord, acomp, bcomp, alen, blen, by_block=True)


def alignment_cartoon(out, abpos: int, aepos: int, bbpos: int, bepos: int,
                      alen: int, blen: int, diffs: int, comp: bool,
                      indent: int, coord: int) -> None:
    """ASCII overlap cartoon (align.c Alignment_Cartoon 4644-4738),
    byte-identical to the reference."""
    from ..utils.fmt import number_digits

    def rep(ch, n):
        if n > 0:
            out.write(ch * n)

    out.write("%*s" % (indent, ""))
    if abpos > 0:
        out.write("    %*d " % (coord, abpos))
    else:
        out.write("%*s" % (coord + 5, ""))
    if aepos < alen:
        out.write("%*s%d" % (coord + 8, "", alen - aepos))
    out.write("\n")

    out.write("%*s" % (indent, ""))
    if abpos > 0:
        out.write("A ")
        w = number_digits(abpos)
        rep(" ", coord - w)
        rep("=", w + 3)
        out.write("+")
        rep("-", coord + 5)
    else:
        out.write("A %*s" % (coord + 4, ""))
        rep("-", coord + 5)
    if aepos < alen:
        out.write("+")
        w = number_digits(alen - aepos)
        rep("=", w + 2)
        out.write(">")
        rep(" ", w)
    else:
        out.write(">")
        rep(" ", coord + 3)
    asub = aepos - abpos
    bsub = bepos - bbpos
    pct = (200.0 * diffs) / (asub + bsub) if asub + bsub else float("nan")
    out.write("   dif/(len1+len2) = %d/(%d+%d) = %5.2f%%\n"
              % (diffs, asub, bsub, pct))

    if comp:
        sym1p, sym2p, sym1e, sym2e = "<", "-", "<", "="
    else:
        sym1p, sym2p, sym1e, sym2e = "-", ">", "=", ">"

    out.write("%*s" % (indent, ""))
    if bbpos > 0:
        out.write("B ")
        w = number_digits(bbpos)
        rep(" ", coord - w)
        out.write(sym1e)
        rep("=", w + 2)
        out.write("+")
        rep("-", coord + 5)
    else:
        out.write("B ")
        rep(" ", coord + 3)
        out.write(sym1p)
        rep("-", coord + 5)
    if bepos < blen:
        out.write("+")
        w = number_digits(blen - bepos)
        rep("=", w + 2)
        out.write("%s\n" % sym2e)
    else:
        out.write("%s\n" % sym2p)

    out.write("%*s" % (indent, ""))
    if bbpos > 0:
        out.write("    %*d " % (coord, bbpos))
    else:
        out.write("%*s" % (coord + 5, ""))
    if bepos < blen:
        out.write("%*s%d" % (coord + 8, "", blen - bepos))
    out.write("\n")


def transmit_alignment(receiver, *args, **kwargs) -> int:
    """Transmit_Alignment (align.c:4740): Print_Alignment routed through
    a per-line callback instead of a file (ALNview GUI support)."""
    import io as _io

    class _Tap(_io.StringIO):
        def write(self, s):
            for piece in s.splitlines(keepends=True):
                receiver(piece)
            return len(s)

    return print_alignment(_Tap(), *args, **kwargs)
