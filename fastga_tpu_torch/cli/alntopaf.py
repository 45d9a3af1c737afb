# Copied from fastga_tpu/cli/alntopaf.py; imports point at fastga_tpu_torch.
"""alntopaf — .1aln to PAF converter (reference ALNtoPAF.c surface).

    python -m fastga_tpu_torch.cli.alntopaf [-mxsSw] [-T<int(8)>] <alignments>[.1aln]

-m: cg:Z CIGAR with M ops; -x: cg:Z with =/X ops; -s: cs:Z short form;
-S: cs:Z long form; -w: swap query/target roles.  Exact-trace modes
reconstruct each alignment (Compute_Trace_PTS + Gap_Improver equivalents in
ops/tracerec).
"""

from __future__ import annotations

import sys

from . import _common
from ..io import paf
from ..utils import dna

USAGE = "[-mxsSw] [-T<int(8)>] <alignments:path>[.1aln]"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="mxsSw", opts="T")
    if len(pos) != 1:
        raise _common.ArgError("alntopaf", "expects one .1aln argument",
                               USAGE)
    if opts["m"] and opts["x"]:
        raise _common.ArgError("alntopaf", "-m and -x are exclusive", USAGE)
    if opts["s"] and opts["S"]:
        raise _common.ArgError("alntopaf", "-s and -S are exclusive", USAGE)

    af, gdb1, gdb2 = _common.open_aln(pos[0], "alntopaf")
    swap = opts["w"]
    exact = opts["m"] or opts["x"] or opts["s"] or opts["S"]
    out = sys.stdout

    if not exact:
        paf.write_paf(af.overlaps, gdb1, gdb2, out, swap=swap)
        return 0

    nthreads = _common.opt_int(opts, "T", 8)

    def worker(ovls):
        # per-slice contig caches (the reference's per-thread .bps units)
        cache = {}
        bcache = {}

        def get_a(c):
            if c not in cache:
                cache.clear()
                cache[c] = gdb1.get_contig(c)
            return cache[c]

        def get_b(c, comp):
            key = (c, comp)
            if key not in bcache:
                bcache.clear()
                s = gdb2.get_contig(c)
                bcache[key] = dna.revcomp(s) if comp else s
            return bcache[key]

        return [paf.paf_line_exact(
            o, gdb1, gdb2, get_a(o.aread), get_b(o.bread, o.bcomp),
            af.tspace, cigar_m=opts["m"], cigar_x=opts["x"],
            cs=opts["S"], cs_short=opts["s"], swap=swap)
            for o in ovls]

    for line in _common.run_sliced(af.overlaps, nthreads, worker):
        out.write(line + "\n")
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
