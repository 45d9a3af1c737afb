# Copied from fastga_tpu/cli/alnreset.py; imports point at fastga_tpu_torch.
"""alnreset — rewrite the source references of a .1aln (ALNreset.c).

    python -m fastga_tpu_torch.cli.alnreset [-T<int(8)>] <alignments>[.1aln]
        <source1>[.1gdb|<fa_extn>] [<source2>[...]]

Rewrites the db1/db2/cpath header references (record copy; all data lines
preserved).
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

from . import _common
from ..io import alncode, onecode
from ..io.onecode_binary import BinaryWriter, BinaryReader, open_any

USAGE = ("[-T<int(8)>] <alignments:path>[.1aln] "
         "<source1:path>[.1gdb|<fa_extn>] [<source2:path>[...]]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="", opts="T")
    if not 2 <= len(pos) <= 3:
        raise _common.ArgError("alnreset", "expects alignment and 1-2 "
                               "sources", USAGE)
    p = Path(pos[0])
    if not p.name.endswith(".1aln"):
        q = Path(str(p) + ".1aln")
        if q.exists():
            p = q
    r = open_any(p, alncode.ALN_SCHEMA)
    binary = isinstance(r, BinaryReader)
    lines = list(r)
    prov = list(r.provenance)
    r.close()

    def src_path(arg):
        t, sp = _common.infer_source(arg)
        return str(sp)

    tmp = p.parent / (p.name + ".reset.tmp")
    cls = BinaryWriter if binary else onecode.OneWriter
    w = cls(tmp, alncode.ALN_SCHEMA, "aln")
    for pr in prov:
        w.provenance.append(pr)
    w.add_provenance("alnreset", "0.1", "alnreset " + " ".join(argv))
    w.add_reference(src_path(pos[1]), 1)
    if len(pos) == 3:
        w.add_reference(src_path(pos[2]), 2)
    w.add_reference(os.getcwd(), 3)
    for ln in lines:
        w.write(ln.type, *ln.fields)
    w.close()
    os.replace(tmp, p)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
