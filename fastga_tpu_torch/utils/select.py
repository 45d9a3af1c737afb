# Copied from fastga_tpu/utils/select.py; imports point at fastga_tpu_torch.
"""Genome selection-expression parser (select.c equivalent).

Grammar (reference select.c:32-37, README.md:395-455)::

    <selection> = <range>[+-] [ , <range>[+-] ]*
    <range>     = <loc> [ - <loc> ] | @ | .
    <loc>       = @ <scaffold> [. <contig>] [: <position>]
                |              .  <contig>  [: <position>]
                |                              <position>
    <scaffold>  = # | <int> | <identifier>       (# = last)
    <contig>    = # | <int>
    <position>  = # | <int> [. <int>] [kMG]

Scaffold identifiers terminate at control chars, '#', '%', '&', ':' or DEL
(the follow[] table select.c:129-149) and are otherwise arbitrary.  A range
with an '@' selects over scaffold sequences, otherwise contig sequences.
The second location of a range inherits the unstated scaffold/contig prefix
of the first.  A '+'/'-' suffix selects orientation.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

CONTG_SELECTION = 0
SCAFF_SELECTION = 1
POINT_SELECTION = 2

_FOLLOW = set(chr(i) for i in range(25)) | {"#", "%", "&", ":", chr(127)}


class SelectError(ValueError):
    pass


@dataclass
class Selection:
    type: int
    orient: int          # +1 fwd, -1 rev, 0 none
    s1: int
    c1: int
    p1: int
    s2: int
    c2: int
    p2: int


@dataclass
class ContigRange:
    order: int = 0       # 0 if out of selection, else ordinal
    beg: int = -1
    end: int = -1
    orient: int = 0


class _Cursor:
    __slots__ = ("s", "i")

    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def white(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else "\0"

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def get_int(self) -> Tuple[int, int]:
        v = 0
        n = 1
        while self.peek().isdigit():
            v = 10 * v + int(self.take())
            n *= 10
        return v, n


def _get_bps(cur: _Cursor) -> Tuple[int, int]:
    """Position with optional .frac and k/M/G multiplier; returns
    (value, multiplier-per-unit) like get_bps select.c:167-206."""
    r, n = cur.get_int()
    cur.white()
    if cur.peek() == ".":
        cur.take()
        cur.white()
        if not cur.peek().isdigit():
            raise SelectError("Location . not followed by integer")
        p, n = cur.get_int()
        cur.white()
    else:
        p, n = 0, 1
    a = cur.peek()
    if a == "G":
        m = 1000000000
        cur.take()
    elif a == "M":
        m = 1000000
        cur.take()
    elif a == "k":
        m = 1000
        cur.take()
    else:
        m = 1
    if p >= m:
        raise SelectError("Location precision has more digits than "
                          "multiplier")
    m //= n
    return (r * n + p) * m, m


def _get_location(cur: _Cursor, names: dict) -> list:
    """v = [scaffold, contig, pos, pos-multiplier]; -2 unset, -1 = '#'."""
    v = [-2, -2, -2, -2]
    cur.white()
    if cur.peek() == "@":
        cur.take()
        cur.white()
        if cur.peek() == "#":
            v[0] = -1
            cur.take()
        elif cur.peek().isdigit():
            v[0], _ = cur.get_int()
            if v[0] == 0:
                raise SelectError("Scaffold index cannot be 0")
        else:
            j = cur.i
            while cur.peek() not in _FOLLOW:
                cur.i += 1
            name = cur.s[j:cur.i]
            if name not in names:
                raise SelectError(f"Could not parse scaffold item '{name}'")
            v[0] = names[name] + 1
        cur.white()
    if cur.peek() == ".":
        cur.take()
        cur.white()
        if cur.peek() == "#":
            v[1] = -1
            cur.take()
        elif cur.peek().isdigit():
            v[1], _ = cur.get_int()
            if v[1] == 0:
                raise SelectError("Contig index cannot be 0")
        else:
            raise SelectError("Contig is not an integer or #-sign")
        cur.white()
    if v[0] >= -1 or v[1] >= -1:
        if cur.peek() == ":":
            cur.take()
            cur.white()
            if cur.peek() == "#":
                v[2] = -1
                cur.take()
            elif cur.peek().isdigit():
                v[2], v[3] = _get_bps(cur)
            else:
                raise SelectError("Position is not an integer or #-sign")
    elif cur.peek() == "#":
        v[2] = -1
        cur.take()
    elif cur.peek().isdigit():
        v[2], v[3] = _get_bps(cur)
    else:
        raise SelectError("Empty location")
    return v


def _complete_address(v: list, gdb, first: bool) -> Tuple[int, int, int]:
    """Fill in missing fields -> (scaffold, absolute contig, contig-relative
    position) per complete_address select.c:371-516."""
    nscaff = gdb.nscaff
    ncontig = gdb.ncontig
    contig = gdb.contigs
    scaff = gdb.scaffolds
    s, c, p = v[0], v[1], v[2]
    q = p
    if s < -1:
        if c < -1:
            if p == -1:
                s = nscaff - 1
                c = ncontig - 1
                p = contig[c].clen
            else:
                for s in range(nscaff):
                    if p > scaff[s].slen:
                        p -= scaff[s].slen
                    else:
                        break
                else:
                    s = nscaff
                if s >= nscaff and p > v[3]:
                    raise SelectError(f"Position {q} is larger than genome")
                s = min(s, nscaff - 1)
                fc, ec = scaff[s].fctg, scaff[s].ectg
                for c in range(fc, ec):
                    if p > contig[c].clen:
                        p -= contig[c].clen
                    else:
                        break
        else:
            if c == -1:
                s = nscaff - 1
                c = ncontig - 1
            else:
                if c > ncontig:
                    raise SelectError(
                        f"Contig {c} is > {ncontig}, the # of contigs")
                c = c - 1
                for s in range(nscaff):
                    if c < scaff[s].ectg:
                        break
            cl = contig[c].clen
            if p < -1:
                p = 0 if first else cl
            elif p == -1:
                p = cl
            elif p > cl + v[3]:
                raise SelectError(
                    f"Position {p} beyond contig {c} of length {cl}")
    else:
        if s == -1:
            s = nscaff - 1
        else:
            if s > nscaff:
                raise SelectError(
                    f"Scaffold {s} does not exist, only {nscaff} scaffolds")
            s = s - 1
        fc, ec = scaff[s].fctg, scaff[s].ectg
        if c < -1:
            if p < -1:
                if first:
                    c = fc
                    p = 0
                else:
                    c = ec - 1
                    p = contig[c].clen
            elif p == -1:
                c = ec - 1
                p = contig[c].clen
            else:
                for c in range(fc, ec):
                    if p < contig[c].sbeg:
                        break
                else:
                    c = ec
                c -= 1
                p -= contig[c].sbeg
                if c == ec - 1 and p > contig[c].clen + v[3]:
                    raise SelectError(
                        f"Position {q} is beyond scaffold {s} of length "
                        f"{scaff[s].slen}")
        else:
            if c == -1:
                c = ec - 1
            else:
                if c > ec - fc:
                    raise SelectError(
                        f"Contig {c} is > {ec - fc}, the # of contigs in "
                        f"scaffold {s}")
                c += fc - 1
            cl = contig[c].clen
            if p < -1:
                p = 0 if first else cl
            elif p == -1:
                p = cl
            elif p > cl + v[3]:
                raise SelectError(
                    f"Position {p} beyond contig {c} of length {cl}")
    return s, c, p


def scaffold_names(gdb) -> dict:
    """First whitespace-delimited word of each header -> scaffold index."""
    names = {}
    for i, s in enumerate(gdb.scaffolds):
        name = s.header.split()[0] if s.header.split() else s.header
        if name in names:
            raise SelectError(f"Duplicate scaffold name: {name}")
        names[name] = i
    return names


def interpret_range(expr: str, gdb, names: dict) -> Selection:
    """One range -> Selection (interpret_range select.c:556-649)."""
    y = expr.strip()
    special = 10
    a = y[:1]
    if a in ("@", "."):
        rest = y[1:].strip()
        if rest == "":
            special = 0
        elif rest in ("-", "+"):
            special = -1 if rest == "-" else 1
    if special < 10:
        typ = SCAFF_SELECTION if a == "@" else CONTG_SELECTION
        c2 = gdb.ncontig - 1
        return Selection(typ, special, 0, 0, 0, gdb.nscaff - 1, c2,
                         gdb.contigs[c2].clen)

    # clip trailing +/-
    ori = 0
    if y.endswith("+"):
        ori = 1
        y = y[:-1]
    elif y.endswith("-"):
        ori = -1
        y = y[:-1]

    cur = _Cursor(y)
    v1 = _get_location(cur, names)
    cur.white()
    if cur.peek() == "-":
        cur.take()
        v2 = _get_location(cur, names)
        cur.white()
    else:
        v2 = [-2, -2, -2, -2]
    if cur.peek() != "\0":
        raise SelectError(f"Range syntax is not complete: '{expr}'")

    typ = CONTG_SELECTION if v1[0] < -1 else SCAFF_SELECTION

    if v2[0] < -1 and v2[1] < -1 and v2[2] < -1:
        if v1[2] >= -1:
            raise SelectError("Must specify a range, not a point")
        v2[0] = v1[0]
        v2[1] = v1[1]
    elif v2[0] < -1:
        v2[0] = v1[0]
        if v2[1] < -1:
            v2[1] = v1[1]

    s1, c1, p1 = _complete_address(v1, gdb, True)
    s2, c2, p2 = _complete_address(v2, gdb, False)
    return Selection(typ, ori, s1, c1, p1, s2, c2, p2)


def _ranges_of(expr: Optional[str]) -> Optional[List[str]]:
    """Expression -> list of range strings (comma split or file lines)."""
    if expr is None:
        return None
    expr = expr.strip()
    if expr == "":
        raise SelectError("Empty range")
    p = Path(expr)
    try:
        if p.is_file():
            out = []
            for line in p.read_text().splitlines():
                w = line.split()
                if w:
                    out.append(w[0])
            return out
    except OSError:
        pass
    return expr.split(",")


def get_selection_list(expr: Optional[str], gdb,
                       names: Optional[dict] = None) -> List[Selection]:
    """Expression/file -> Selection list; None selects every contig."""
    if names is None:
        names = scaffold_names(gdb)
    ranges = _ranges_of(expr)
    if ranges is None:
        c2 = gdb.ncontig - 1
        return [Selection(CONTG_SELECTION, 0, 0, 0, 0, gdb.nscaff - 1, c2,
                          gdb.contigs[c2].clen)]
    return [interpret_range(r, gdb, names) for r in ranges]


def get_selection_contigs(expr: Optional[str], gdb,
                          names: Optional[dict] = None,
                          ordered: bool = False) -> List[ContigRange]:
    """Expression -> per-contig coverage records (get_selection_contigs
    select.c:747-875)."""
    if names is None:
        names = scaffold_names(gdb)
    chord = [ContigRange() for _ in range(gdb.ncontig)]
    ranges = _ranges_of(expr)
    if ranges is None:
        for i, cr in enumerate(chord):
            cr.order = 1
            cr.beg = 0
            cr.end = gdb.contigs[i].clen
        return chord

    order = 1
    for r in ranges:
        s = interpret_range(r, gdb, names)
        pbeg, pend, pfst, plst, ori = s.c1, s.c2, s.p1, s.p2, s.orient
        if ordered:
            for i in range(pbeg, pend):
                if chord[i].order:
                    raise SelectError("Overlapping contigs in selection "
                                      "ranges")
        elif ori != 0:
            for i in range(pbeg, pend + 1):
                if chord[i].order and ori * chord[i].orient < 0:
                    raise SelectError("Conflicting sign for contig in "
                                      "selection expression")
        for i in range(pbeg + 1, pend):
            chord[i].order = order
            chord[i].beg = 0
            chord[i].end = gdb.contigs[i].clen
            chord[i].orient = ori
        if pbeg != pend:
            if chord[pend].order:
                if chord[pend].end < plst:
                    chord[pend].end = plst
            else:
                chord[pend].order = order
                chord[pend].end = plst
            chord[pend].beg = 0
            if chord[pbeg].order:
                if chord[pbeg].beg > pfst:
                    chord[pbeg].beg = pfst
            else:
                chord[pbeg].order = order
                chord[pbeg].beg = pfst
            chord[pbeg].end = gdb.contigs[pbeg].clen
            chord[pbeg].orient = ori
            chord[pend].orient = ori
        else:
            if chord[pend].order:
                if chord[pend].end < plst:
                    chord[pend].end = plst
                if chord[pbeg].beg > pfst:
                    chord[pbeg].beg = pfst
            else:
                chord[pend].order = order
                chord[pend].end = plst
                chord[pbeg].beg = pfst
            chord[pbeg].orient = ori
        order += 1
    return chord
