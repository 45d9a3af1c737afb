# Copied from fastga_tpu/cli/anoshow.py; imports point at fastga_tpu_torch.
"""anoshow — display .1ano intervals under a selection (ANOshow.c).

    python -m fastga_tpu_torch.cli.anoshow <source>[.1ano] [<selection>|<FILE>]
"""

from __future__ import annotations

import sys

from . import _common
from ..io import ano as anom
from ..utils import select as selm

USAGE = "<source:path>[.1ano] [ <selection>|<FILE> ]"

SOEL, EOEL, SPOS, EPOS = "<", ">", "[", "]"


def _fmt(m: anom.AnoRecord, fst, lst, off, out, reverse=False):
    if reverse:
        lo = (f"[{m.end + off:>10d}" if m.end <= lst
              else f"<{lst + off:>10d}")
        hi = (f" - {m.beg + off:>10d}]" if m.beg >= fst
              else f" - {fst + off:>10d}>")
    else:
        lo = (f"[{m.beg + off:>10d}" if m.beg >= fst
              else f"<{fst + off:>10d}")
        hi = (f" - {m.end + off:>10d}]" if m.end <= lst
              else f" - {lst + off:>10d}>")
    out.write(lo + hi)
    if m.label is not None:
        out.write(f" {m.label}")
    if m.score > 0:
        out.write(f" score = {m.score}")
    out.write("\n")
    if m.parse:
        pts = m.parse if not reverse else m.parse[::-1]
        out.write("  Parse: ")
        for p in pts:
            if p > fst or p < lst:
                out.write(f" {p}")
        out.write("\n")


def _print_ctg(by_ctg, n, fst, lst, off, out, reverse):
    recs = by_ctg[n]
    if reverse:
        for m in reversed(recs):
            if m.beg >= lst or m.end <= fst:
                continue
            _fmt(m, fst, lst, off, out, reverse=True)
    else:
        for m in recs:
            if m.end <= fst or m.beg >= lst:
                continue
            _fmt(m, fst, lst, off, out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("anoshow", "expects source and optional "
                               "selection", USAGE)
    gdb, by_ctg, _ = anom.read_ano_records(pos[0])
    names = selm.scaffold_names(gdb)
    try:
        sels = selm.get_selection_list(pos[1] if len(pos) > 1 else None,
                                       gdb, names)
    except selm.SelectError as e:
        raise _common.ArgError("anoshow", str(e), USAGE)
    out = sys.stdout
    ctg = gdb.contigs
    scf = gdb.scaffolds
    for sel in sels:
        ori = sel.orient
        if sel.type == selm.SCAFF_SELECTION:
            for k in range(sel.s1, sel.s2 + 1):
                b, e = sel.c1, sel.c2
                fst = ctg[b].sbeg + sel.p1
                lst = ctg[e].sbeg + sel.p2
                if k > sel.s1:
                    b, fst = scf[k].fctg, 0
                if k < sel.s2:
                    e, lst = scf[k].ectg - 1, scf[k].slen
                if ori < 0:
                    out.write(f">{scf[k].header} "
                              f"{SOEL if fst == 0 else SPOS}"
                              f"{scf[k].slen - fst},{scf[k].slen - lst}"
                              f"{EOEL if lst == scf[k].slen else EPOS}\n")
                    for n in range(e, b - 1, -1):
                        f2 = sel.p1 if n == sel.c1 else 0
                        l2 = sel.p2 if n == sel.c2 else ctg[n].clen
                        _print_ctg(by_ctg, n, f2, l2, ctg[n].sbeg, out, True)
                else:
                    out.write(f">{scf[k].header} "
                              f"{SOEL if fst == 0 else SPOS}{fst},{lst}"
                              f"{EOEL if lst == scf[k].slen else EPOS}\n")
                    for n in range(b, e + 1):
                        f2 = sel.p1 if n == sel.c1 else 0
                        l2 = sel.p2 if n == sel.c2 else ctg[n].clen
                        _print_ctg(by_ctg, n, f2, l2, ctg[n].sbeg, out, False)
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
                    _print_ctg(by_ctg, k, fst, lst, 0, out, True)
                else:
                    out.write(
                        f">{s.header} "
                        f"{SOEL if r.sbeg + fst == 0 else SPOS}"
                        f"{r.sbeg + fst},{r.sbeg + lst}"
                        f"{EOEL if r.sbeg + lst == s.slen else EPOS}"
                        f" :: Contig {cno} "
                        f"{SOEL if fst == 0 else SPOS}{fst},{lst}"
                        f"{EOEL if lst == r.clen else EPOS}\n")
                    _print_ctg(by_ctg, k, fst, lst, 0, out, False)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
