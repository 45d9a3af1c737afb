# Copied from fastga_tpu/cli/gdbstat.py; imports point at fastga_tpu_torch.
"""gdbstat — assembly statistics for a GDB (reference GDBstat.c).

    python -m fastga_tpu_torch.cli.gdbstat [-h[<int>,<int>]] [-hlog] <source>[.1gdb]

Prints scaffold/contig/gap overview, the N10..N90 table, and optional
linear (-h) or logarithmic (-hlog) length histograms with the reference's
nice_round bucket policy (GDBstat.c:48-65).
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import gdb as gdbm
from ..utils.fmt import comma_number, number_digits

USAGE = "[-h[<int>,<int>]] [-hlog] <source:path>[.1gdb]"

NBINS = 20


def nice_round(num: int, nbins: int):
    buck = 1
    while buck * nbins <= num:
        buck *= 10
    if buck >= 10:
        buck //= 10
    mod = 0
    if buck * nbins * 5 <= num:
        buck *= 5
        mod = 1
    elif buck * nbins * 2 <= num:
        buck *= 2
        mod = 2
    return buck, mod


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    hist_lin = hist_log = False
    cbuck = sbuck = 0
    pos = []
    for a in argv:
        if a.startswith("-h"):
            if a[2:] == "log":
                hist_log = True
            else:
                hist_lin = True
                if a[2:]:
                    try:
                        cb, sb = a[2:].split(",")
                        cbuck, sbuck = int(cb), int(sb)
                    except ValueError:
                        raise _common.ArgError(
                            "gdbstat", f"Cannot parse option {a} as 2 comma "
                            f"separated int's.")
                    if cbuck <= 0 or sbuck <= 0:
                        raise _common.ArgError(
                            "gdbstat", "Bucket sizes must be positive int's "
                            "in -h option.")
        else:
            pos.append(a)
    if len(pos) != 1:
        raise _common.ArgError("gdbstat", "expects one source", USAGE)

    gdb = gdbm.read_gdb(_common._root(Path(pos[0])))
    out = sys.stdout

    contigs, scaffs = gdb.contigs, gdb.scaffolds
    nctg, nscaff = gdb.ncontig, gdb.nscaff
    gaps = []
    for s in scaffs:
        spos = 0
        for c in range(s.fctg, s.ectg):
            if contigs[c].sbeg > spos:
                gaps.append(contigs[c].sbeg - spos)
            spos = contigs[c].sbeg + contigs[c].clen
        if spos < s.slen:
            gaps.append(s.slen - spos)
    ngap = len(gaps)

    totbps = gdb.seqtot
    totspan = sum(s.slen for s in scaffs)
    totgap = totspan - totbps

    clens = sorted(c.clen for c in contigs)
    slens = sorted(s.slen for s in scaffs)
    glens = sorted(gaps)

    # overview
    cwide = number_digits(nctg)
    swide = number_digits(totspan)
    awide = number_digits(totspan // nscaff)
    cwide += (cwide - 1) // 3
    swide += (swide - 1) // 3
    awide += (awide - 1) // 3

    name = Path(pos[0]).name
    for ext in (".1gdb", ".gdb"):
        if name.endswith(ext):
            name = name[:-len(ext)]
            break
    out.write(f"\nStatistics for assembly {name}:\n")
    out.write(f"\n  {comma_number(nscaff, cwide)} scaffolds spanning "
              f"{comma_number(totspan, swide)}bp, ave. = "
              f"{comma_number(totspan // nscaff, awide)}bp\n")
    out.write(f"  {comma_number(nctg, cwide)} contigs containing "
              f"{comma_number(totbps, swide)}bp, ave. = "
              f"{comma_number(totbps // nctg, awide)}bp\n")
    if ngap == 0:
        out.write(" No gaps\n")
    else:
        out.write(f"  {comma_number(ngap, cwide)} gaps    containing "
                  f"{comma_number(totgap, swide)}bp, ave. = "
                  f"{comma_number(totgap // ngap, awide)}bp\n")

    # N<X> table
    cwide = max(number_digits(clens[-1]), 1)
    cwide += (cwide - 1) // 3
    cwide = max(cwide, len("Contigs"))
    swide = number_digits(slens[-1])
    swide += (swide - 1) // 3
    swide = max(swide, len("Scaffolds"))
    if ngap > 0:
        gwide = number_digits(glens[-1])
        gwide += (gwide - 1) // 3

    if ngap > 0:
        out.write(f"\n             Contigs{'':{cwide - 4}}Scaffolds"
                  f"{'':{swide - 6}}Gaps\n")
    else:
        out.write(f"\n             Contigs{'':{cwide - 4}}Scaffolds\n")
    out.write(f"       MAX:  {comma_number(clens[-1], cwide)}   "
              f"{comma_number(slens[-1], swide)}")
    if ngap > 0:
        out.write(f"   {comma_number(glens[-1], gwide)}")
    out.write("\n")
    cf, cs = nctg - 1, 0
    sf, ss = nscaff - 1, 0
    gf, gs = ngap - 1, 0
    for n in range(10, 100, 10):
        while cf >= 0 and cs < totbps * (n / 100.0):
            cs += clens[cf]
            cf -= 1
        out.write(f"       N{n:2d}:  {comma_number(clens[cf + 1], cwide)}")
        while sf >= 0 and ss < totspan * (n / 100.0):
            ss += slens[sf]
            sf -= 1
        out.write(f"   {comma_number(slens[sf + 1], swide)}")
        if ngap > 0:
            while gf >= 0 and gs < totgap * (n / 100.0):
                gs += glens[gf]
                gf -= 1
            out.write(f"   {comma_number(glens[gf + 1], gwide)}")
        out.write("\n")
    out.write(f"       MIN:  {comma_number(clens[0], cwide)}   "
              f"{comma_number(slens[0], swide)}")
    if ngap > 0:
        out.write(f"   {comma_number(glens[0], gwide)}")
    out.write("\n")

    def histogram(next_cbin, next_sbin, cbin, sbin, cmin, smin):
        cwide_ = number_digits(clens[-1])
        swide_ = number_digits(slens[-1])
        cwide_ += (cwide_ - 1) // 3
        swide_ += (swide_ - 1) // 3
        cwide_ = max(cwide_, len("Contigs"))
        ccwide = number_digits(nctg)
        scwide = number_digits(nscaff)
        cf_, cs_ = nctg - 1, 0
        sf_, ss_ = nscaff - 1, 0
        out.write(f"\n       Contigs{'':{cwide_ + ccwide + 13}}Scaffolds\n")
        while cf_ >= 0 or sf_ >= 0:
            ct = 0
            while cf_ >= 0 and clens[cf_] >= cbin:
                ct += 1
                cs_ += clens[cf_]
                cf_ -= 1
            st = 0
            while sf_ >= 0 and slens[sf_] >= sbin:
                st += 1
                ss_ += slens[sf_]
                sf_ -= 1
            out.write("       ")
            if cbin >= cmin:
                out.write(f"{comma_number(cbin, cwide_)}:  {ct:{ccwide}d}   "
                          f"{100.0 * cs_ / totbps:5.1f}%")
            else:
                out.write(f"{'':{cwide_ + ccwide + 12}}")
            if sbin >= smin:
                out.write(f"        {comma_number(sbin, swide_)}:  "
                          f"{st:{scwide}d}   {100.0 * ss_ / totspan:5.1f}%")
            out.write("\n")
            cbin, sbin = next_cbin(cbin), next_sbin(sbin)

    if hist_log:
        cmin, _ = nice_round(clens[0], 1)
        cbin, cmod0 = nice_round(clens[-1], 1)
        smin, _ = nice_round(slens[0], 1)
        sbin, smod0 = nice_round(slens[-1], 1)
        cmod = [cmod0]
        smod = [smod0]

        def nc(b):
            b = (b * 2) // 5 if cmod[0] == 1 else b // 2
            cmod[0] = (cmod[0] + 1) % 3
            return b

        def ns(b):
            b = (b * 2) // 5 if smod[0] == 1 else b // 2
            smod[0] = (smod[0] + 1) % 3
            return b

        histogram(nc, ns, cbin, sbin, cmin, smin)

    if hist_lin:
        if cbuck == 0:
            cbuck, _ = nice_round(clens[-1] - clens[0], NBINS)
            sbuck, _ = nice_round(slens[-1] - slens[0], NBINS)
        cbin = (clens[-1] // cbuck) * cbuck
        cmin = (clens[0] // cbuck) * cbuck
        sbin = (slens[-1] // sbuck) * sbuck
        smin = (slens[0] // sbuck) * sbuck
        cb, sb = cbuck, sbuck
        histogram(lambda b: b - cb, lambda b: b - sb, cbin, sbin, cmin, smin)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
