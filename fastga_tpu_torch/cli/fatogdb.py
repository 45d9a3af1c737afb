# Copied from fastga_tpu/cli/fatogdb.py; imports point at fastga_tpu_torch.
"""fatogdb — FASTA(.gz) -> GDB (.1gdb + .bps [+ .1ano]) (FAtoGDB.c surface).

    python -m fastga_tpu_torch.cli.fatogdb [-v] [-L:<log>] [-n<int>]
        <source> [<target>]
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom
from ..io import gdb as gdbm

USAGE = ("[-v] [-L:<log:path>] [-n<int(0)>] <source:fasta> "
         "[<target:path>[.1gdb]]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="v", opts="n",
                                   str_opts="L")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("fatogdb", "expects 1 or 2 arguments", USAGE)
    src = Path(pos[0])
    target = Path(pos[1]) if len(pos) == 2 else _common._root(src)
    ncut = int(opts.get("n") or 0)
    gdb, masks = gdbm.create_gdb(src, target=target, ncut=ncut)
    if masks:
        root = gdbm.GDB.paths(target)[0]
        anom.write_ano(str(root)[:-5] + ".1ano", gdb, masks)
    stat = (f"  {gdb.nscaff} scaffolds, {gdb.ncontig} contigs, "
            f"{gdb.seqtot} bp"
            f"{', ' + str(len(masks)) + ' mask intervals' if masks else ''}"
            "\n")
    if opts["v"]:
        sys.stderr.write(stat)
    if opts.get("L"):
        with open(opts["L"], "a") as lf:
            lf.write("\nfatogdb " + " ".join(argv) + "\n" + stat)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
