# Copied from fastga_tpu/cli/gixxfer.py; imports point at fastga_tpu_torch;
# `python -m` of this module prints the two tools' usage.
"""gixmv / gixcp — move or copy a GIX/GDB ensemble (GIXxfer.c, built as
GIXmv with -DMOVE and GIXcp without; Makefile:38-42).

    python -m fastga_tpu_torch.cli.gixmv [-vinf] <source> <target>
    python -m fastga_tpu_torch.cli.gixcp [-vinf] <source> <target>

Transfers the .gix stub + hidden .ktab parts and the .1gdb + .bps (+
.1ano) together so the ensemble never splits.  -n excludes the GDB.
``python -m fastga_tpu_torch.cli.gixxfer`` names the two tools and exits
1: which one to run says whether the ensemble moves.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

from . import _common

USAGE = "[-vinf] <source:path>[.1gdb|.gix] <target:path>[.1gdb|.gix]"


def _xfer(argv, move: bool, prog: str) -> int:
    opts, pos = _common.parse_args(argv, flags="vinfx")
    if len(pos) != 2:
        raise _common.ArgError(prog, "expects source and target", USAGE)
    verbose = opts["v"] and not opts["f"]
    no_gdb = opts["n"]
    sroot = _common._root(Path(pos[0]))
    tgt = Path(pos[1])
    if tgt.is_dir():
        troot = tgt / sroot.name
    else:
        troot = _common._root(tgt)

    pairs = []
    stub = Path(str(sroot) + ".gix")
    if stub.exists():
        pairs.append((stub, Path(str(troot) + ".gix")))
        p = 1
        while True:
            part = sroot.parent / f".{sroot.name}.ktab.{p}"
            if not part.exists():
                break
            pairs.append((part, troot.parent / f".{troot.name}.ktab.{p}"))
            p += 1
    if not no_gdb:
        for ext_src, ext_tgt in ((".1gdb", ".1gdb"), (".1ano", ".1ano")):
            f = Path(str(sroot) + ext_src)
            if f.exists():
                pairs.append((f, Path(str(troot) + ext_tgt)))
        bps = sroot.parent / f".{sroot.name}.bps"
        if bps.exists():
            pairs.append((bps, troot.parent / f".{troot.name}.bps"))
    if not pairs:
        raise _common.ArgError(prog, f"no GIX/GDB files for {pos[0]}")
    for src, dst in pairs:
        if verbose:
            sys.stderr.write(f"  {'moving' if move else 'copying'} "
                             f"{src} -> {dst}\n")
        if move:
            shutil.move(str(src), str(dst))
        else:
            shutil.copy2(str(src), str(dst))
    return 0


def main_mv(argv=None) -> int:
    return _xfer(sys.argv[1:] if argv is None else argv, True, "gixmv")


def main_cp(argv=None) -> int:
    return _xfer(sys.argv[1:] if argv is None else argv, False, "gixcp")


def main(argv=None) -> int:
    sys.stderr.write(f"gixxfer: run it as gixcp (copy) or gixmv (move)\n"
                     f"Usage: gixcp {USAGE}\n       gixmv {USAGE}\n")
    return 1


if __name__ == "__main__":
    _common.cli_exit(main)
