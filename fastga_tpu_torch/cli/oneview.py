# Copied from fastga_tpu/cli/oneview.py; imports point at fastga_tpu_torch;
# a wrong argument count also prints the usage line.
"""oneview — ONEcode ascii<->binary converter/inspector (ONEview.c surface).

    python -m fastga_tpu_torch.cli.oneview [options] <onefile>
      -h --noHeader      skip the header in ascii output
      -H --headerOnly    only write the header
      -b --binary        write binary (default ascii)
      -o --output FILE   output file (default stdout)
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

from . import _common
from ..io import onecode
from ..io.onecode_binary import BinaryWriter, open_any

USAGE = "[-hHbv] [-o <output:path>] <onefile:path>"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    no_header = header_only = binary = False
    out_name = "-"
    pos = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--noHeader"):
            no_header = True
        elif a in ("-H", "--headerOnly"):
            header_only = True
        elif a in ("-b", "--binary"):
            binary = True
        elif a in ("-o", "--output"):
            i += 1
            out_name = argv[i]
        elif a in ("-v", "--verbose"):
            pass
        else:
            pos.append(a)
        i += 1
    if len(pos) != 1:
        raise _common.ArgError("oneview",
                               "need a single one-code file as argument",
                               USAGE)
    if binary:
        no_header = False
    if header_only:
        binary = False

    r = open_any(pos[0])
    if r.schema is None:
        raise _common.ArgError("oneview", f"{pos[0]} carries no schema")

    if binary:
        path = out_name if out_name != "-" else None
        if path is None:
            raise _common.ArgError("oneview",
                                   "-b requires -o (binary to a file)")
        w = BinaryWriter(path, r.schema, r.filetype)
    else:
        tmp = None
        if out_name == "-":
            tmp = tempfile.NamedTemporaryFile("w", delete=False,
                                              suffix=".one")
            path = tmp.name
            tmp.close()
        else:
            path = out_name
        w = onecode.OneWriter(path, r.schema, r.filetype)
    for p in r.provenance:
        w.provenance.append(p)
    w.add_provenance("oneview", "0.1", "oneview " + " ".join(argv))
    for ref in r.references:
        w.add_reference(ref.filename, ref.count)
    if not header_only:
        for line in r:
            w.write(line.type, *line.fields)
    w.close()
    r.close()

    if not binary and out_name == "-":
        text = Path(path).read_text()
        if no_header:
            # header lines all start with non-alphabetic chars
            lines = text.splitlines(keepends=True)
            datastart = next((k for k, ln in enumerate(lines)
                              if ln[:1].isalpha()), len(lines))
            sys.stdout.write("".join(lines[datastart:]))
        else:
            sys.stdout.write(text)
        Path(path).unlink()
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
