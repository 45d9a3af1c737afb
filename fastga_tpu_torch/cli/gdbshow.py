# Copied from fastga_tpu/cli/gdbshow.py; imports point at fastga_tpu_torch.
"""gdbshow — display scaffolds/contigs of a GDB (reference GDBshow.c).

    python -m fastga_tpu_torch.cli.gdbshow [-hu] [-w<int(80)>] <source>[.1gdb]
        [#[<mask>[.1ano]]] [ <selection> | <FILE> ]

Output marks selection boundaries with '<'/'>' at element ends and '['/']'
at interior positions (GDBshow.c:37-40); scaffold selections emit gap runs
as n/N strings with line wrapping carried across pieces.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from . import _common
from ..io import ano as anom
from ..io import gdb as gdbm
from ..utils import dna
from ..utils import select as selm

USAGE = ("[-hu] [-w<int(80)>] <source:path>[.1gdb] [#[<mask>[.1ano]]] "
         "[ <selection>|<FILE> ]")

SOEL, EOEL, SPOS, EPOS = "<", ">", "[", "]"

_COMP = np.zeros(256, np.uint8)
for _x, _y in zip(b"ACGTacgt", b"TGCAtgca"):
    _COMP[_x] = _y


class _Roller:
    """WIDTH-wrapped emission carried across sequence pieces."""

    def __init__(self, out, width: int):
        self.out = out
        self.width = width
        self.wpos = 0

    def emit(self, s: str):
        w = self.width - self.wpos
        i = 0
        while i + w <= len(s):
            self.out.write(s[i:i + w] + "\n")
            i += w
            self.wpos = 0
            w = self.width
        if i < len(s):
            self.out.write(s[i:])
            self.wpos += len(s) - i


def _ascii_contig(gdb, ano_by_ctg, k: int, upper: bool) -> np.ndarray:
    codes = gdb.get_contig(k)
    s = (dna.CODE_TO_UPPER if upper else dna.CODE_TO_LOWER)[codes].copy()
    if ano_by_ctg is not None:
        b = 0
        for mb, me in ano_by_ctg.get(k, ()):
            if b < mb:
                b = mb
            s[b:me] += 32
            if me > b:
                b = me
    return s


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # a bare '#mask' argument only counts before the first positional
    # (GDBshow.c:134-137: `if (j == 1) MFILE = ...`, silently dropped after)
    mfile = None
    rest = []
    npos = 0
    for a in argv:
        if a.startswith("#"):
            if npos == 0:
                mfile = a[1:]
        else:
            if not a.startswith("-"):
                npos += 1
            rest.append(a)
    opts, pos = _common.parse_args(rest, flags="hu", opts="w")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("gdbshow", "expects a source and optional "
                               "selection", USAGE)
    width = _common.opt_int(opts, "w", 80)
    doseq = not opts["h"]
    upper = bool(opts["u"])

    gdb = gdbm.read_gdb(_common._root(Path(pos[0])))
    names = selm.scaffold_names(gdb)

    ano_by_ctg = None
    if mfile is not None:
        upper = True
        if mfile == "":
            root = _common._root(Path(pos[0]))
            mpath = Path(str(root) + ".1ano")
        else:
            mpath = Path(mfile)
        masks = anom.read_ano(mpath, gdb)
        ano_by_ctg = {}
        for m in masks:
            ano_by_ctg.setdefault(m.contig, []).append((m.beg, m.end))

    try:
        sels = selm.get_selection_list(pos[1] if len(pos) == 2 else None,
                                       gdb, names)
    except selm.SelectError as e:
        raise _common.ArgError("gdbshow", str(e), USAGE)

    out = sys.stdout
    nstr = ("N" if upper else "n") * width
    ctg = gdb.contigs
    scf = gdb.scaffolds

    for sel in sels:
        ori = sel.orient
        if sel.type == selm.SCAFF_SELECTION:
            for k in range(sel.s1, sel.s2 + 1):
                fst = ctg[sel.c1].sbeg + sel.p1 if k == sel.s1 else 0
                lst = (ctg[sel.c2].sbeg + sel.p2 if k == sel.s2
                       else scf[k].slen)
                if ori < 0:
                    out.write(f">{scf[k].header} "
                              f"{SOEL if fst == 0 else SPOS}"
                              f"{scf[k].slen - fst},{scf[k].slen - lst}"
                              f"{EOEL if lst == scf[k].slen else EPOS}\n")
                    if doseq:
                        roll = _Roller(out, width)
                        cbeg = scf[k].slen
                        for u in range(scf[k].ectg - 1, scf[k].fctg - 1, -1):
                            r = ctg[u]
                            cend = r.sbeg + r.clen
                            if cbeg > lst:
                                cbeg = lst
                            if cend < lst and cbeg > fst:
                                ln = cbeg - cend if cend >= fst else cbeg - fst
                                q, rem = divmod(ln, width)
                                roll.emit(nstr * q + nstr[:rem])
                            cbeg = r.sbeg
                            if cbeg < lst and cend > fst:
                                s = _ascii_contig(gdb, ano_by_ctg, u, upper)
                                s = _COMP[s[::-1]]
                                f = max(fst - cbeg, 0)
                                l = min(lst - cbeg, r.clen)
                                f, l = r.clen - l, r.clen - f
                                roll.emit(s[f:l].tobytes().decode())
                        cend = 0
                        if cbeg > lst:
                            cbeg = lst
                        if cend < lst and cbeg > fst:
                            ln = cbeg - cend if cend >= fst else cbeg - fst
                            q, rem = divmod(ln, width)
                            roll.emit(nstr * q + nstr[:rem])
                        out.write("\n")
                else:
                    out.write(f">{scf[k].header} "
                              f"{SOEL if fst == 0 else SPOS}{fst},{lst}"
                              f"{EOEL if lst == scf[k].slen else EPOS}\n")
                    if doseq:
                        roll = _Roller(out, width)
                        cend = 0
                        for u in range(scf[k].fctg, scf[k].ectg):
                            r = ctg[u]
                            cbeg = r.sbeg
                            if cend < fst:
                                cend = fst
                            if cend < lst and cbeg > fst:
                                ln = cbeg - cend if cbeg <= lst else lst - cend
                                q, rem = divmod(ln, width)
                                roll.emit(nstr * q + nstr[:rem])
                            cend = cbeg + r.clen
                            if cbeg < lst and cend > fst:
                                s = _ascii_contig(gdb, ano_by_ctg, u, upper)
                                f = max(fst - cbeg, 0)
                                l = min(lst - cbeg, r.clen)
                                roll.emit(s[f:l].tobytes().decode())
                        cbeg = scf[k].slen
                        if cend < fst:
                            cend = fst
                        if cend < lst and cbeg > fst:
                            ln = cbeg - cend if cbeg <= lst else lst - cend
                            q, rem = divmod(ln, width)
                            roll.emit(nstr * q + nstr[:rem])
                        out.write("\n")
        else:
            for k in range(sel.c1, sel.c2 + 1):
                r = ctg[k]
                s = scf[r.scaf]
                fst = sel.p1 if k == sel.c1 else 0
                lst = sel.p2 if k == sel.c2 else r.clen
                cno = k - s.fctg + 1
                if ori < 0:
                    out.write(
                        f">{s.header} "
                        f"{SOEL if r.sbeg + lst == s.slen else SPOS}"
                        f"{r.sbeg + lst},{r.sbeg + fst}"
                        f"{EOEL if r.sbeg + fst == 0 else EPOS}"
                        f" :: Contig {cno} "
                        f"{SOEL if lst == r.clen else SPOS}{lst},{fst}"
                        f"{EOEL if fst == 0 else EPOS}\n")
                else:
                    out.write(
                        f">{s.header} "
                        f"{SOEL if r.sbeg + fst == 0 else SPOS}"
                        f"{r.sbeg + fst},{r.sbeg + lst}"
                        f"{EOEL if r.sbeg + lst == s.slen else EPOS}"
                        f" :: Contig {cno} "
                        f"{SOEL if fst == 0 else SPOS}{fst},{lst}"
                        f"{EOEL if lst == r.clen else EPOS}\n")
                if doseq:
                    seq = _ascii_contig(gdb, ano_by_ctg, k, upper)
                    if ori < 0:
                        fst, lst = r.clen - lst, r.clen - fst
                        seq = _COMP[seq[::-1]]
                    txt = seq[fst:lst].tobytes().decode()
                    for j in range(0, max(len(txt), 1), width):
                        if txt[j:j + width]:
                            out.write(txt[j:j + width] + "\n")
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
