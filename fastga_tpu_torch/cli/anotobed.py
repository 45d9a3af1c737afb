# Copied from fastga_tpu/cli/anotobed.py; imports point at fastga_tpu_torch.
"""anotobed — .1ano to BED (ANOtoBED.c).

    python -m fastga_tpu_torch.cli.anotobed [-v] <source>[.1ano] [<target>[.bed]]
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom

USAGE = "[-v] <source:path>[.1ano] [ <target:path>[.bed] ]"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="v")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("anotobed", "expects source and optional "
                               "target", USAGE)
    gdb, by_ctg, prov = anom.read_ano_records(pos[0])

    sroot = Path(pos[0]).name
    if sroot.endswith(".1ano"):
        sroot = sroot[:-5]
    if len(pos) == 1:
        out = sys.stdout
        close = False
    else:
        tp = Path(pos[1])
        if tp.is_dir():
            out_path = tp / (sroot + ".bed")
        else:
            name = tp.name
            if name.endswith(".bed"):
                name = name[:-4]
            out_path = tp.parent / (name + ".bed")
        if opts["v"]:
            sys.stderr.write(f"\n  Creating bed file {out_path}\n")
        out = open(out_path, "w")
        close = True

    # provenance block goes to stdout even when -o names a file
    # (ANOtoBED.c:126-133 uses printf)
    import sys as _sys
    import time as _time
    _sys.stdout.write("# Provenance:\n")
    for pr in prov:
        _sys.stdout.write(f"#  {pr.command}  {pr.date}\n")
    _sys.stdout.write(f"#  anotobed {' '.join(argv)}  "
                      f"{_time.strftime('%Y-%m-%d_%H:%M:%S')}\n")

    for c, recs in enumerate(by_ctg):
        h = gdb.scaffolds[gdb.contigs[c].scaf].header
        for m in recs:
            # beg <= end always after the read swap, so strand is '+'
            # (the reference's orient flag is not re-applied here)
            out.write(f"{h}\t{m.beg}\t{m.end}\t")
            if m.label is not None:
                out.write(m.label)
            out.write(f"\t{m.score}\t{'+' if m.beg <= m.end else '-'}\n")
            if m.parse:
                out.write("# Parse:" + "".join(f" {p}" for p in m.parse)
                          + "\n")
    if close:
        out.close()
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
