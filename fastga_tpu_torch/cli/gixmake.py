"""gixmake — GDB/FASTA -> GIX index (GIXmake.c surface).

    python -m fastga_tpu_torch.cli.gixmake [-v] [-L:<log>] [-T<int>] [-P<dir>]
        [-k<int>] <source> (#<mask>)*

Port of fastga_tpu/cli/gixmake.py.  cli/_common.build_index builds the
index with its #mask bytes: on the card at k = 40 and -T8 (``main(argv,
device="cpu")`` runs the kernels' plain versions), else on the host.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import ano as anom
from ..io import gdb as gdbm
from ..io import gix as gixm
from ..models.aligner import resolve_device

USAGE = ("[-v] [-L:<log:path>] [-T<int(8)>] [-P<dir>] [-k<int(40)>] "
         "<source>[.1gdb|<fa>] (#<mask:.1ano>)*")


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="v", opts="Tk",
                                   str_opts="LP")
    srcs = [a for a in pos if not a.startswith("#")]
    mask_args = [a[1:] for a in pos if a.startswith("#")]
    if len(srcs) != 1:
        raise _common.ArgError("gixmake", "expects one source", USAGE)
    nthreads = int(opts.get("T") or 8)
    kmer = int(opts.get("k") or 40)
    dev = None
    if _common.index_on_card(kmer, nthreads):
        try:
            dev = resolve_device(device)
        except RuntimeError as e:
            raise _common.ArgError("gixmake", str(e))
    t, p = _common.infer_source(srcs[0])
    root = _common._root(p)
    if t == "fasta":
        gdb, masks = gdbm.create_gdb(p, target=root)
        if masks:
            anom.write_ano(str(root) + ".1ano", gdb, masks)
    else:
        gdb = gdbm.read_gdb(root)
        masks = None
    if mask_args:
        lists = []
        for m in mask_args:
            mp = m if m else str(root) + ".1ano"
            lists.append(anom.read_ano(mp, gdb))
        masks = anom.ano_union(lists)
    elif masks is None:
        ano_file = Path(str(root) + ".1ano")
        masks = anom.read_ano(ano_file, gdb) if ano_file.exists() else None

    table = _common.build_index(gdb, nthreads, dev,
                                masks if mask_args else None, kmer)
    gixm.write_gix(table, root, nthreads=nthreads)
    ktot = gdb.seqtot - (kmer - 1) * gdb.ncontig
    stat = (f"  Sampled: {table.n} ({100.0*table.n/ktot:.1f}%) "
            f"kmers/positions\n")
    if opts["v"]:
        sys.stderr.write(stat)
    if opts.get("L"):
        with open(opts["L"], "a") as lf:
            lf.write("\ngixmake " + " ".join(argv) + "\n" + stat)
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
