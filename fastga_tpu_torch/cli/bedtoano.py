# Copied from fastga_tpu/cli/bedtoano.py; imports point at fastga_tpu_torch.
"""bedtoano — BED to .1ano (BEDtoANO.c).

    python -m fastga_tpu_torch.cli.bedtoano [-T<int(8)>] <bed>[.bed]
        <genome>[.1gdb|<fa_extn>]

BED fields: name, beg, end[, label[, score[, strand]]] in scaffold coords;
'-' strand records the interval orientation by swapping beg/end.  (The
reference reads the score from field 6 due to an off-by-one — we read the
BED-standard field 5.)
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom
from ..utils import select as selm

USAGE = "[-T<int(8)>] <bed:path>[.bed] [<genome:path>[.1gdb|<fa_extn>]]"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="", opts="T")
    if len(pos) != 2:
        raise _common.ArgError("bedtoano", "expects bed and genome "
                               "arguments", USAGE)
    bed = Path(pos[0])
    if not bed.name.endswith(".bed"):
        q = Path(str(bed) + ".bed")
        bed = q if q.exists() else bed
    gdb = _common.resolve_gdb(pos[1])
    names = selm.scaffold_names(gdb)

    by_ctg = [[] for _ in range(gdb.ncontig)]
    flat = []
    with open(bed) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if (not line or line.startswith("#")
                    or line.startswith("track:")
                    or line.startswith("browser:")):
                continue
            # BED is tab-delimited; fall back to whitespace when un-tabbed
            # (the reference splits on any whitespace, which breaks on
            # multi-word scaffold headers)
            fld = line.split("\t") if "\t" in line else line.split()
            if len(fld) < 3:
                raise _common.ArgError(
                    "bedtoano", f"line {lineno} has fewer than 3 fields")
            key = fld[0] if fld[0] in names else fld[0].split()[0]
            if key not in names:
                raise _common.ArgError(
                    "bedtoano", f"scaffold name {fld[0]} not in genome")
            s = names[key]
            beg, end = int(fld[1]), int(fld[2])
            if beg > end or beg < 0 or end > gdb.scaffolds[s].slen:
                raise _common.ArgError(
                    "bedtoano", f"bad interval at line {lineno}")
            label = (fld[3] or None) if len(fld) >= 4 else None
            score = int(fld[4]) if len(fld) >= 5 else 0
            orient = 1 if len(fld) >= 6 and fld[5] == "-" else 0
            flat.append((s, beg, end, orient, label, score))

    # group per contig in scaffold-sorted order
    flat.sort(key=lambda x: (x[0], x[1]))
    for s, beg, end, orient, label, score in flat:
        sc = gdb.scaffolds[s]
        ctg = sc.fctg
        while ctg + 1 < sc.ectg and beg >= gdb.contigs[ctg + 1].sbeg:
            ctg += 1
        c = gdb.contigs[ctg]
        by_ctg[ctg].append(anom.AnoRecord(
            ctg, beg - c.sbeg, end - c.sbeg, orient, label, score))

    aroot = Path(pos[0]).name
    if aroot.endswith(".bed"):
        aroot = aroot[:-4]
    out = bed.parent / (aroot + ".1ano")
    anom.write_ano_records(out, gdb, by_ctg,
                           command="bedtoano " + " ".join(argv))
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
