# Copied from fastga_tpu/cli/gdbtofa.py; imports point at fastga_tpu_torch.
"""gdbtofa — GDB back to FASTA (reference GDBtoFA.c, inverse of FAtoGDB).

    python -m fastga_tpu_torch.cli.gdbtofa [-v] [-w<int(80)>] [#<mask>[.1ano]]
        <source>[.1gdb] [ @ | <target>[<fa_extn>] ]

Target rules (README.md:667-679): no target -> stdout uncompressed; '@' ->
rebuild at the recorded origin path/name; a directory -> origin name in
that directory; a file -> exactly that path (its extension, or the
origin's if none).
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom
from ..io import gdb as gdbm

USAGE = ("[-v] [-w<int(80)>] [#<mask>[.1ano]] <source:path>[.1gdb] "
         "[ @ | <target:path>[<fa_extn>|.1seq] ]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mfile = None
    rest = []
    for a in argv:
        if a.startswith("#"):
            mfile = a[1:]
        else:
            rest.append(a)
    opts, pos = _common.parse_args(rest, flags="vU", opts="w")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("gdbtofa", "expects source and optional "
                               "target", USAGE)
    width = _common.opt_int(opts, "w", 80)

    root = _common._root(Path(pos[0]))
    gdb = gdbm.read_gdb(root)

    masks = None
    if mfile is not None:
        mpath = Path(mfile) if mfile else Path(str(root) + ".1ano")
        masks = anom.read_ano(mpath, gdb)

    origin = Path(gdb.srcpath) if gdb.srcpath else None
    if len(pos) == 1:
        out = None
    else:
        tgt = pos[1]
        if tgt == "@":
            if origin is None:
                raise _common.ArgError("gdbtofa",
                                       "GDB records no origin path")
            out = origin
        else:
            tp = Path(tgt)
            if tp.is_dir():
                if origin is None:
                    raise _common.ArgError("gdbtofa",
                                           "GDB records no origin path")
                out = tp / origin.name
            else:
                if tp.suffix == "" and origin is not None:
                    ext = next((fa for fa in _common.FASTA_EXTS
                                if origin.name.endswith(fa)), "")
                    out = tp.parent / (tp.name + ext)
                else:
                    out = tp
    if opts["v"] and out is not None:
        sys.stderr.write(f"  Writing {out}\n")
    gdbm.gdb_to_fasta(gdb, out, width=width, masks=masks)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
