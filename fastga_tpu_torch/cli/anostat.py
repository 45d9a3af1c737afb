# Copied from fastga_tpu/cli/anostat.py; imports point at fastga_tpu_torch.
"""anostat — statistics for a .1ano (ANOstat.c).

    python -m fastga_tpu_torch.cli.anostat [-h[<int>,<int>]] [-hlog] <source>[.1ano]
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom
from .gdbstat import nice_round
from ..utils.fmt import comma_number, number_digits

USAGE = "[-h[<int>,<int>]] [-hlog] <source:path>[.1ano]"

NBINS = 20


def _span_str(v: int) -> str:
    if v >= 1000000:
        return f"{comma_number(v // 1000000)}.{(v % 1000000) // 100000}M"
    if v >= 1000:
        return f"{comma_number(v // 1000)}.{(v % 1000) // 100}K"
    return comma_number(v)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    hist_lin = hist_log = False
    rbuck = cbuck = 0
    pos = []
    for a in argv:
        if a.startswith("-h"):
            if a[2:] == "log":
                hist_log = True
            else:
                hist_lin = True
                if a[2:]:
                    rb, cb = a[2:].split(",")
                    rbuck, cbuck = int(rb), int(cb)
        else:
            pos.append(a)
    if len(pos) != 1:
        raise _common.ArgError("anostat", "expects one source", USAGE)

    gdb, by_ctg, _ = anom.read_ano_records(pos[0])
    out = sys.stdout

    region, covered, uncovered = [], [], []
    totreg = totcov = totunc = totgap = 0
    numori = numlab = numscr = numpar = 0
    nints = sum(len(r) for r in by_ctg)
    for c, recs in enumerate(by_ctg):
        if not recs:
            continue
        m = recs[0]
        b, e = m.beg, m.end
        region.append(e - b)
        totreg += e - b
        numori += m.orient
        numlab += m.label is not None
        numscr += m.score > 0
        # (sic) the reference never counts the first interval of a contig
        # in numpar (ANOstat.c:144-175)
        if b > 0:
            uncovered.append(b)
            totunc += b
        for m in recs[1:]:
            beg, end = m.beg, m.end
            if e < beg:
                covered.append(e - b)
                totcov += e - b
                b = beg
                uncovered.append(b - e)
                totunc += b - e
                e = end
            elif end > e:
                e = end
            region.append(end - beg)
            totreg += end - beg
            numori += m.orient
            numlab += m.label is not None
            numscr += m.score > 0
            numpar += bool(m.parse)
        covered.append(e - b)
        totcov += e - b
        end = gdb.contigs[c].clen
        if e < end:
            uncovered.append(end - e)
            totunc += end - e
        elif e > end:
            totgap += e - end

    region.sort()
    covered.sort()
    uncovered.sort()

    # the reference uses Root(path, ".ano"), so '.1ano' names keep their
    # extension in the banner (GDBstat-style quirk)
    name = Path(pos[0]).name
    if name.endswith(".ano") and not name.endswith(".1ano"):
        name = name[:-4]
    out.write(f"\nStatistics for ano file {name}:\n")
    out.write(f"\n  There are {comma_number(nints)}")
    out.write(" oriented" if numori else " unoriented")
    if numlab == nints:
        out.write(", labelled")
    elif numlab == 0:
        out.write(", unlabelled")
    out.write(", scored" if numscr else ", unscored")
    if numpar:
        out.write(", parsed")
    out.write(" intervals")
    if 0 != numlab != nints:
        out.write(f" of which {comma_number(numlab)} are labelled")
        if 0 != numpar != nints:
            out.write(f" and {comma_number(numpar)} have parses")
    elif 0 != numpar != nints:
        out.write(f" of which {comma_number(numpar)} have parses")
    out.write("\n")

    out.write("\n  ")
    if totcov == totreg:
        out.write("The intervals are all disjoint\n")
    else:
        out.write(f"{100.0 * (totreg - totcov) / totreg:.1f}% of the "
                  f"interval regions overlap\n")
    out.write(f"\n  The intervals span {_span_str(totreg)}bp and cover "
              f"{_span_str(totcov)}bp "
              f"({100.0 * totcov / gdb.seqtot:.1f}%) of the genome\n")
    if totgap:
        out.write(f"\n  The intervals span {comma_number(totgap)}bp of the "
                  f"gaps between contigs\n")
    else:
        out.write("\n  The intervals do not span gaps between contigs\n")

    rwide = max(number_digits(region[-1]), 1)
    rwide += (rwide - 1) // 3
    rwide = max(rwide, 9)
    cwide = max(number_digits(covered[-1]), 1)
    cwide += (cwide - 1) // 3
    cwide = max(cwide, 14)
    uwide = max(number_digits(uncovered[-1]) if uncovered else 1, 1)
    uwide += (uwide - 1) // 3
    uwide = max(uwide, 16)

    out.write(f"\n             Intervals{'':{rwide - 6}}Covered Blocks"
              f"{'':{cwide - 11}}Uncovered Blocks\n")
    out.write(f"       MAX:  {comma_number(region[-1], rwide)}   "
              f"{comma_number(covered[-1], cwide)}   "
              f"{comma_number(uncovered[-1] if uncovered else 0, uwide)}\n")
    nr, rs = len(region) - 1, 0
    nc, cs = len(covered) - 1, 0
    nu, us = len(uncovered) - 1, 0
    for n in range(10, 100, 10):
        while nr >= 0 and rs < totreg * (n / 100.0):
            rs += region[nr]
            nr -= 1
        out.write(f"       N{n:2d}:  {comma_number(region[nr + 1], rwide)}")
        while nc >= 0 and cs < totcov * (n / 100.0):
            cs += covered[nc]
            nc -= 1
        out.write(f"   {comma_number(covered[nc + 1], cwide)}")
        while nu >= 0 and us < totunc * (n / 100.0):
            us += uncovered[nu]
            nu -= 1
        out.write(f"   {comma_number(uncovered[nu + 1] if uncovered else 0, uwide)}")
        out.write("\n")
    out.write(f"       MIN:  {comma_number(region[0], rwide)}   "
              f"{comma_number(covered[0], cwide)}   "
              f"{comma_number(uncovered[0] if uncovered else 0, uwide)}\n")

    def histogram(next_r, next_c, rbin, rmin, cbin, cmin, header, pad_w):
        """Two-column (Intervals / Covered Blocks) histogram; `pad_w` is
        the empty-left-column width (mismatched between the modes in the
        reference, mirrored here)."""
        rwide_ = number_digits(region[-1])
        cwide_ = number_digits(covered[-1])
        rwide_ += (rwide_ - 1) // 3
        cwide_ += (cwide_ - 1) // 3
        rwide_ = max(rwide_, len("Intervals"))
        rcwide = number_digits(len(region))
        ccwide = number_digits(len(covered))
        out.write(header(rwide_, cwide_, rcwide, ccwide))
        nr_, rs_ = len(region) - 1, 0
        nc_, cs_ = len(covered) - 1, 0
        while nr_ >= 0 or nc_ >= 0:
            rt = 0
            while nr_ >= 0 and region[nr_] >= rbin:
                rt += 1
                rs_ += region[nr_]
                nr_ -= 1
            ct = 0
            while nc_ >= 0 and covered[nc_] >= cbin:
                ct += 1
                cs_ += covered[nc_]
                nc_ -= 1
            out.write("       ")
            if rbin >= rmin:
                out.write(f"{comma_number(rbin, rwide_)}:  {rt:{rcwide}d}"
                          f"   {100.0 * rs_ / totreg:5.1f}%")
            else:
                out.write(" " * pad_w(rwide_, cwide_, rcwide))
            if cbin >= cmin:
                out.write(f"        {comma_number(cbin, cwide_)}:  "
                          f"{ct:{ccwide}d}   {100.0 * cs_ / totcov:5.1f}%")
            out.write("\n")
            rbin = next_r(rbin)
            cbin = next_c(cbin)

    if hist_log:
        rmin, _ = nice_round(region[0], 1)
        rbin, rmod0 = nice_round(region[-1], 1)
        cmin, _ = nice_round(covered[0], 1)
        cbin, cmod0 = nice_round(covered[-1], 1)
        rmod = [rmod0]
        cmod = [cmod0]

        def nr(b):
            b = (b * 2) // 5 if rmod[0] == 1 else b // 2
            rmod[0] = (rmod[0] + 1) % 3
            return b

        def ncf(b):
            b = (b * 2) // 5 if cmod[0] == 1 else b // 2
            cmod[0] = (cmod[0] + 1) % 3
            return b

        histogram(nr, ncf, rbin, rmin, cbin, cmin,
                  # (sic) "Intervlas" typo is the reference's
                  lambda rw, cw, rc, cc:
                      f"\n       Intervlas{'':{rw + rc + 13}}"
                      f"Covered Blocks\n",
                  lambda rw, cw, rc: cw + rc + 12)
    if hist_lin:
        if rbuck == 0:
            rbuck, _ = nice_round(region[-1] - region[0], NBINS)
            cbuck, _ = nice_round(covered[-1] - covered[0], NBINS)
        rbuck = max(rbuck, 1)
        cbuck = max(cbuck, 1)
        rbin = (region[-1] // rbuck) * rbuck
        rmin = (region[0] // rbuck) * rbuck
        cbin = (covered[-1] // cbuck) * cbuck
        cmin = (covered[0] // cbuck) * cbuck
        rb, cb = rbuck, cbuck
        histogram(lambda b: b - rb, lambda b: b - cb, rbin, rmin, cbin, cmin,
                  lambda rw, cw, rc, cc:
                      f"\n       Intervals{'':{cw + cc + 13}}"
                      f"Covered_Blocks\n",
                  lambda rw, cw, rc: rw + rc + 12)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
