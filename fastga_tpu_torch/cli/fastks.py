# Port of fastga_tpu/cli/fastks.py; imports point at fastga_tpu_torch.
"""FastKS: adaptamer-length statistics between two genome indices.

Usage: fastks [-vk] [-b:<name>] [-T<int(8)>] [-P<dir>] <source1> <source2>

Prints the unique-mer / adapt-mer histograms of the adaptamer merge
between the two GIXs; -b additionally writes the per-A-entry adaptamer
length byte stream (reference FastKS.c:30-38,462-512).

Parity note: the reference binary streams the .gix with the wrong entry
stride (see ops/merge.adaptamer_kstats docstring), so its numbers do not
describe the genomes; this tool computes the documented statistics from
the correctly parsed index.

An index built here from a FASTA or a .1gdb (k = 40, -T8) comes from the
device GIX build (ops/device_pipeline.build_gix_device) on the card;
``main(argv, device="cpu")`` runs the kernels' plain versions.
"""

from __future__ import annotations

import sys

from . import _common
from ..models.aligner import resolve_device

USAGE = """Usage: fastks [-vk] [-b:<name>] [-T<int(8)>] [-P<dir($TMPDIR)>]
              <source1:path>[<precursor>] <source2:path>[<precursor>]"""


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # -b takes the form -b:<name>
    bname = None
    rest = []
    for a in argv:
        if a.startswith("-b:"):
            bname = a[3:]
        elif a == "-b":
            raise _common.ArgError("fastks", "-b requires -b:<name>", USAGE)
        else:
            rest.append(a)
    opts, pos = _common.parse_args(rest, flags="vk", opts="T", str_opts="P")
    if len(pos) != 2:
        raise _common.ArgError("fastks", "expects 2 source arguments",
                               USAGE)
    verbose = opts["v"]
    keep = opts["k"]
    nthreads = _common.opt_int(opts, "T", 8)
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        raise _common.ArgError("fastks", str(e))

    _, t1 = _common.resolve_genome(pos[0], nthreads, keep, verbose,
                                   device=dev)
    _, t2 = _common.resolve_genome(pos[1], nthreads, keep, verbose,
                                   device=dev)

    from ..ops.merge import adaptamer_kstats

    if verbose:
        sys.stderr.write("\n  Starting adaptive seed merge for G1\n")
    histu, histl, pbytes = adaptamer_kstats(t1, t2,
                                            want_bytes=bname is not None)
    if bname is not None:
        with open(bname, "wb") as f:
            f.write(pbytes)
    if verbose:
        sys.stderr.write("\r    Completed 100%\n")

    out = sys.stdout
    out.write("   K:  unique-mers   adapt-mers\n")
    for t in range(1, t1.kmer + 1):
        out.write(" %2d: %10d %10d\n" % (t, histu[t], histl[t]))
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
