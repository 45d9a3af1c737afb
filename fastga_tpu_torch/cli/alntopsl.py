# Copied from fastga_tpu/cli/alntopsl.py; imports point at fastga_tpu_torch.
"""alntopsl — .1aln to PSL converter (reference ALNtoPSL.c surface).

    python -m fastga_tpu_torch.cli.alntopsl [-T<int(8)>] <alignments>[.1aln]
"""

from __future__ import annotations

import sys

from . import _common
from ..io import psl
from ..utils import dna

USAGE = "[-T<int(8)>] <alignments:path>[.1aln]"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="", opts="T")
    if len(pos) != 1:
        raise _common.ArgError("alntopsl", "expects one .1aln argument",
                               USAGE)
    af, gdb1, gdb2 = _common.open_aln(pos[0], "alntopsl")
    nthreads = _common.opt_int(opts, "T", 8)

    def worker(ovls):
        acache = {}
        bcache = {}

        def get_a(c):
            if c not in acache:
                acache.clear()
                acache[c] = gdb1.get_contig(c)
            return acache[c]

        def get_b(c, comp):
            key = (c, comp)
            if key not in bcache:
                bcache.clear()
                s = gdb2.get_contig(c)
                bcache[key] = dna.revcomp(s) if comp else s
            return bcache[key]

        return [psl.psl_line(o, gdb1, gdb2, get_a(o.aread),
                             get_b(o.bread, o.bcomp), af.tspace)
                for o in ovls]

    out = sys.stdout
    for line in _common.run_sliced(af.overlaps, nthreads, worker):
        out.write(line + "\n")
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
