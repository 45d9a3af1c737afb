# Copied from fastga_tpu/api.py; imports point at fastga_tpu_torch.
"""User-facing .1aln reader API (the ONEaln.[ch] equivalent, Pythonic).

Mirrors the reference's release C API (ONEaln.h:20-350; usage
README.md:801-1194): an alignment-record cursor over a .1aln with genome
structure accessors and exact-alignment derivations (CIGAR, CS tag, indel
array, BLAST-style display).  Example::

    from fastga_tpu_torch.api import AlnReader

    with AlnReader("H1vH2.1aln") as r:
        for rec in r:
            print(rec.seq1, rec.bpos1, rec.epos1, rec.diffs)
            print(rec.cigar(show_x=True))
            rec.show_alignment(sys.stdout, width=100)

Coordinates follow ONEaln conventions: ``seq1``/``seq2`` are 1-based
scaffold numbers, positions are scaffold-space, and complemented records
have ``bpos2 > epos2``.
"""

from __future__ import annotations

import io as _io
import sys
from pathlib import Path
from typing import IO, Iterator, List, Optional

import numpy as np

from .cli import _common
from .io import alncode
from .io import show as showm
from .ops import tracerec
from .utils import dna


class AlnError(Exception):
    """Raised on API misuse or malformed files (alnError catalog)."""


class AlnGDB:
    """Genome structure accessors (gdb* routines ONEaln.c:436-811).

    Scaffolds and contigs are numbered from 1; gap p of scaffold s is the
    gap *before* its p'th contig (p=0 is a leading N-run).
    """

    def __init__(self, gdb, see_seq: bool):
        self._g = gdb
        self._see_seq = see_seq

    @property
    def scaffold_count(self) -> int:
        return self._g.nscaff

    @property
    def contig_count(self) -> int:
        return self._g.ncontig

    @property
    def gap_count(self) -> int:
        n = 0
        for s in self._g.scaffolds:
            spos = 0
            for c in range(s.fctg, s.ectg):
                if self._g.contigs[c].sbeg > spos:
                    n += 1
                spos = self._g.contigs[c].sbeg + self._g.contigs[c].clen
            if spos < s.slen:
                n += 1
        return n

    @property
    def contig_max(self) -> int:
        return max((s.ectg - s.fctg for s in self._g.scaffolds), default=0)

    def _scaf(self, s: int):
        if not 1 <= s <= self._g.nscaff:
            raise AlnError(f"scaffold index {s} out of range")
        return self._g.scaffolds[s - 1]

    def scaffold_len(self, s: int) -> int:
        return self._scaf(s).slen

    def scaffold_contigs(self, s: int) -> int:
        sc = self._scaf(s)
        return sc.ectg - sc.fctg

    def scaffold_name(self, s: int) -> str:
        return self._scaf(s).header.split()[0]

    def contig_len(self, s: int, c: int) -> int:
        sc = self._scaf(s)
        if not 1 <= c <= sc.ectg - sc.fctg:
            raise AlnError(f"contig index {c} out of range")
        return self._g.contigs[sc.fctg + c - 1].clen

    def contig_start(self, s: int, c: int) -> int:
        sc = self._scaf(s)
        if not 1 <= c <= sc.ectg - sc.fctg:
            raise AlnError(f"contig index {c} out of range")
        return self._g.contigs[sc.fctg + c - 1].sbeg

    def gap_len(self, s: int, p: int) -> int:
        """Length of the gap before the p'th contig (p == #contigs for a
        trailing N-run)."""
        sc = self._scaf(s)
        nc = sc.ectg - sc.fctg
        if not 0 <= p <= nc:
            raise AlnError(f"gap index {p} out of range")
        if p == 0:
            return self._g.contigs[sc.fctg].sbeg
        prev = self._g.contigs[sc.fctg + p - 1]
        prev_end = prev.sbeg + prev.clen
        if p == nc:
            return sc.slen - prev_end
        return self._g.contigs[sc.fctg + p].sbeg - prev_end

    def scaffold_seq(self, s: int, beg: int, end: int) -> str:
        """Sequence of scaffold s over [beg,end] (gaps as 'n')."""
        if not self._see_seq:
            raise AlnError("reader opened without sequence access")
        sc = self._scaf(s)
        if not 0 <= beg <= end <= sc.slen:
            raise AlnError("interval out of scaffold range")
        out = np.full(end - beg, ord("n"), np.uint8)
        for ci in range(sc.fctg, sc.ectg):
            c = self._g.contigs[ci]
            lo = max(beg, c.sbeg)
            hi = min(end, c.sbeg + c.clen)
            if lo < hi:
                piece = self._g.get_contig_piece(ci, lo - c.sbeg,
                                                 hi - c.sbeg)
                out[lo - beg:hi - beg] = dna.CODE_TO_LOWER[piece]
        return out.tobytes().decode()


class AlnRecord:
    """One alignment with exact-alignment derivations.

    ``seq1``/``seq2`` are 1-based scaffold indices; positions are
    scaffold-space; ``bpos2 > epos2`` iff the second sequence is
    complemented (alnAlignment ONEaln.c:813-930).
    """

    def __init__(self, reader: "AlnReader", idx: int):
        o = reader._af.overlaps[idx]
        self._reader = reader
        self._o = o
        g1, g2 = reader._gdb1, reader._gdb2
        c1 = g1.contigs[o.aread]
        c2 = g2.contigs[o.bread]
        self.seq1 = c1.scaf + 1
        self.bpos1 = o.abpos + c1.sbeg
        self.epos1 = o.aepos + c1.sbeg
        self.seq2 = c2.scaf + 1
        if o.bcomp:
            self.bpos2 = (c2.clen + c2.sbeg) - o.bbpos
            self.epos2 = (c2.clen + c2.sbeg) - o.bepos
        else:
            self.bpos2 = o.bbpos + c2.sbeg
            self.epos2 = o.bepos + c2.sbeg
        self.diffs = o.diffs
        self.tpoints = [b for _, b in o.trace]
        self.tdiffs = [d for d, _ in o.trace]
        self.tlen = len(o.trace)
        self._exact = None

    @property
    def complement(self) -> bool:
        return self._o.bcomp

    # -- exact alignment derivations --------------------------------------

    def _sequences(self):
        r = self._reader
        if not r._see_seq:
            raise AlnError("reader opened without sequence access")
        o = self._o
        A = r._contig_seq(1, o.aread)
        B = r._contig_seq(2, o.bread)
        Bor = dna.revcomp(B) if o.bcomp else B
        return A, Bor

    def _exact_trace(self):
        if self._exact is None:
            o = self._o
            A, Bor = self._sequences()
            tr, diffs = tracerec.compute_trace_pts(
                A, Bor, o.abpos, o.aepos, o.bbpos, o.bepos, o.trace,
                self._reader.trace_spacing)
            tr, diffs = tracerec.gap_improver(
                A, Bor, o.abpos, o.bbpos, o.aepos, len(A), len(Bor),
                tr, diffs)
            self._exact = (tr, diffs, A, Bor)
        return self._exact

    def cigar(self, show_x: bool = False, reversed: bool = False) -> str:
        """CIGAR transforming seq1 into seq2 with seq1 forward
        (alnCreateCigar); with ``reversed`` the roles swap and the ops
        run along seq2 forward.  NOTE: ONEaln's I/D letters are the
        mirror of ALNtoPAF's cg:Z convention (verified against the
        reference's ONEalnTEST); this method follows ONEaln."""
        from .io.paf import cigar_string
        tr, diffs, A, Bor = self._exact_trace()
        o = self._o
        if show_x:
            cig, _ = tracerec.cigar_x(tr, A, Bor, o.abpos, o.aepos, o.bbpos)
        else:
            cig, _ = tracerec.cigar_m(tr, o.abpos, o.aepos, o.bbpos)
        rev = o.bcomp and reversed
        s = cigar_string(cig, rev, merge_m=False, swap=reversed)
        return s.translate(str.maketrans("ID", "DI"))

    def cs_tag(self, short_form: bool = False,
               reversed: bool = False) -> str:
        """CS difference string (alnCreateCStag).  ONEaln's conventions
        are the mirror of ALNtoPAF's cs:Z in several ways (all verified
        against the reference's ONEalnTEST): everything lower case, the
        first sequence stays FORWARD for complemented records,
        substitutions order (first, second), and the +/- indel roles are
        exchanged."""
        tr, diffs, A, Bor = self._exact_trace()
        o = self._o
        cig, _ = tracerec.cigar_x(tr, A, Bor, o.abpos, o.aepos, o.bbpos)
        W1 = np.asarray(A[o.abpos:o.aepos])
        W2 = np.asarray(Bor[o.bbpos:o.bepos])
        ops = cig
        if reversed:
            W1, W2 = W2, W1
            ops = [("D" if op == "I" else "I" if op == "D" else op, ln)
                   for op, ln in ops]
            if o.bcomp:
                W1 = dna.revcomp(W1)
                W2 = dna.revcomp(W2)
                ops = ops[::-1]
        acgt = "acgtn"
        parts = []
        ai = bi = 0
        for op, ln in ops:
            if op in ("=", "M"):
                if short_form:
                    parts.append(f":{ln}")
                else:
                    parts.append("=" + "".join(
                        acgt[c] for c in W1[ai:ai + ln]))
                ai += ln
                bi += ln
            elif op == "X":
                # a substitution RUN shares one '*' (unlike cs:Z)
                parts.append("*" + "".join(
                    acgt[W1[ai + j]] + acgt[W2[bi + j]]
                    for j in range(ln)))
                ai += ln
                bi += ln
            elif op == "I":     # consumes the first sequence
                parts.append("-" + "".join(
                    acgt[c] for c in W1[ai:ai + ln]))
                ai += ln
            else:               # consumes the second sequence
                parts.append("+" + "".join(
                    acgt[c] for c in W2[bi:bi + ln]))
                bi += ln
        return "".join(parts)

    def indel_array(self, reversed: bool = False) -> List[int]:
        """Dash positions relative to the aligned subsequences
        (alnCreateIndelArray): +x = dash before the x'th char of seq2,
        -x = dash before the x'th char of seq1 (signs verified against
        the reference's ONEalnTEST)."""
        tr, diffs, A, Bor = self._exact_trace()
        o = self._o
        out = []
        for t in tr:
            if t < 0:   # base of seq2 unmatched: dash in seq1
                out.append(-((-t) - o.abpos))
            else:       # extra base in seq1: dash in seq2
                out.append(t - o.bbpos)
        if reversed:
            if o.bcomp:
                # reflect through the swapped frames, reversed order
                # (alnCreateIndelArray ONEaln.c:1525-1545)
                aw = (o.aepos - o.abpos) + 2
                bw = (o.bepos - o.bbpos) + 2
                out = [(aw + v) if v < 0 else (v - bw)
                       for v in out][::-1]
            else:
                out = [-v for v in out]
        return out

    def show_alignment(self, where: IO[str] = sys.stdout, indent: int = 8,
                       width: int = 100, border: int = 10, coord: int = 5,
                       upper: bool = False, reversed: bool = False):
        """BLAST-style display (alnShowAlignment).  With ``reversed`` the
        second sequence is shown on top in its forward orientation
        (ONEaln.c:1555-1786 role swap; note the reference additionally
        prints a stray debug "shift = ..." line in the complemented case
        which is not reproduced here)."""
        tr, diffs, A, Bor = self._exact_trace()
        o = self._o
        kw = dict(indent=indent, width=width, border=border, upper=upper,
                  coord=coord)
        if not reversed:
            a1 = showm.Seq1(A, 0)
            b1 = showm.Seq1(Bor, 0)
            showm.print_alignment(where, a1, b1, tr, o.abpos, o.aepos,
                                  o.bbpos, o.bepos, acomp=False,
                                  bcomp=o.bcomp, alen=len(A),
                                  blen=len(Bor), **kw)
            return
        if not o.bcomp:
            ntr = [-t for t in tr]
            showm.print_alignment(where, showm.Seq1(Bor, 0),
                                  showm.Seq1(A, 0), ntr,
                                  o.bbpos, o.bepos, o.abpos, o.aepos,
                                  acomp=False, bcomp=False,
                                  alen=len(Bor), blen=len(A), **kw)
        else:
            # both strands complement; the reference reader anchors the
            # forward-B frame at (blen - bepos, blen - bbpos) — one off
            # from our complement frame — and the indel codes reflect
            # through the swapped frames in reverse order
            A_c = dna.revcomp(A)
            B_f = dna.revcomp(Bor)
            L = len(Bor)
            bb, be = L - o.bepos, L - o.bbpos
            amax2 = o.abpos + o.aepos + 2
            bmax2 = len(Bor) + 2
            ntr = [(amax2 + t) if t < 0 else (t - bmax2)
                   for t in tr[::-1]]
            a1 = showm.Seq1(B_f, 0)
            b1 = showm.Seq1(A_c, o.abpos + o.aepos - len(A))
            showm.print_alignment(where, a1, b1, ntr,
                                  bb, be, o.abpos, o.aepos,
                                  acomp=False, bcomp=True, alen=0,
                                  blen=o.abpos + o.aepos, **kw)


class AlnReader:
    """Cursor over a .1aln's alignment records (alnOpenReader et al.)."""

    def __init__(self, path, see_seq: bool = True):
        self.path = Path(path)
        self._af, gdb1, gdb2 = _common.open_aln(str(path), "AlnReader")
        self._gdb1, self._gdb2 = gdb1, gdb2
        self._see_seq = see_seq
        self._pos = 0
        self._cache = {}

    # -- counts ------------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._af.overlaps)

    @property
    def trace_max(self) -> int:
        return max((len(o.trace) for o in self._af.overlaps), default=0)

    @property
    def trace_count(self) -> int:
        return sum(len(o.trace) for o in self._af.overlaps)

    @property
    def trace_spacing(self) -> int:
        return self._af.tspace

    @property
    def gdb1(self) -> AlnGDB:
        return AlnGDB(self._gdb1, self._see_seq)

    @property
    def gdb2(self) -> AlnGDB:
        return AlnGDB(self._gdb2, self._see_seq)

    # -- cursor --------------------------------------------------------------

    def goto(self, idx: int):
        """Position at the idx'th record, 1-based (alnGoto)."""
        if not 1 <= idx <= self.count:
            raise AlnError(f"record index {idx} out of range")
        self._pos = idx - 1

    def next(self) -> bool:
        """Advance; returns True at EOF (alnNext)."""
        self._pos += 1
        return self._pos >= self.count

    @property
    def eof(self) -> bool:
        return self._pos >= self.count

    def alignment(self) -> AlnRecord:
        if self.eof:
            raise AlnError("cursor at end of file")
        return AlnRecord(self, self._pos)

    def __iter__(self) -> Iterator[AlnRecord]:
        for i in range(self.count):
            yield AlnRecord(self, i)

    def __len__(self):
        return self.count

    def __getitem__(self, i: int) -> AlnRecord:
        return AlnRecord(self, i)

    # -- internals -----------------------------------------------------------

    def _contig_seq(self, which: int, ctg: int) -> np.ndarray:
        key = (which, ctg)
        if key not in self._cache:
            if len(self._cache) > 4:
                self._cache.clear()
            g = self._gdb1 if which == 1 else self._gdb2
            self._cache[key] = g.get_contig(ctg)
        return self._cache[key]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
