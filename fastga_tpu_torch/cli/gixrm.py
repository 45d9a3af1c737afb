# Copied from fastga_tpu/cli/gixrm.py; imports point at fastga_tpu_torch.
"""gixrm — remove a GIX/GDB ensemble (GIXrm.c).

    python -m fastga_tpu_torch.cli.gixrm [-vifg] <source>[.1gdb|.gix] ...

Deletes the visible .gix stub and hidden .ktab parts; with -g also the
.1gdb + hidden .bps (+ .1ano).  -v lists deletions, -i prompts per stub,
-f forces quietly.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common

USAGE = "[-vifg] <source:path>[.1gdb|.gix] ... "


def ensemble_files(root: Path, gdb_too: bool):
    """All existing files of the GIX (+GDB) ensemble for a root path."""
    name = root.name
    parent = root.parent
    out = []
    stub = parent / (name + ".gix")
    if stub.exists():
        out.append(stub)
    p = 1
    while True:
        part = parent / f".{name}.ktab.{p}"
        if not part.exists():
            break
        out.append(part)
        p += 1
    p = 1
    while True:
        part = parent / f".{name}.post.{p}"
        if not part.exists():
            break
        out.append(part)
        p += 1
    if gdb_too:
        for f in (parent / (name + ".1gdb"), parent / f".{name}.bps",
                  parent / (name + ".1ano")):
            if f.exists():
                out.append(f)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="vifg")
    if not pos:
        raise _common.ArgError("gixrm", "expects at least one source", USAGE)
    verbose, ask = opts["v"], opts["i"]
    if opts["f"]:
        verbose = ask = False
    for src in pos:
        root = _common._root(Path(src))
        files = ensemble_files(root, opts["g"])
        if not files:
            if not opts["f"]:
                sys.stderr.write(f"gixrm: no GIX/GDB files for {src}\n")
            continue
        if ask:
            sys.stderr.write(f"remove {root}? [y/N] ")
            sys.stderr.flush()
            if not sys.stdin.readline().strip().lower().startswith("y"):
                continue
        for f in files:
            if verbose:
                sys.stderr.write(f"  deleting {f}\n")
            f.unlink()
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
