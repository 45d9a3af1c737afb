# Copied from fastga_tpu/cli/gixshow.py; imports point at fastga_tpu_torch.
"""gixshow — dump GIX k-mers and positions (GIXshow.c, new format).

    python -m fastga_tpu_torch.cli.gixshow <source>[.gix] [<address>[-<address>]]

<address> is an integer entry index or a DNA string prefix; a string used
as a range end selects through the last k-mer with that prefix
(Interpret GIXshow.c:520-570).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from . import _common
from ..io import gix as gixm

USAGE = "<source>[.gix] [ <address>[-<address>] ] "

_BASES = "acgt"


def _kmer_string(t, i: int) -> str:
    """Entry i's k-mer as lower-case text."""
    row = t.kmer_codes(i)
    return "".join(_BASES[c] for c in row)


def _interpret(n, kmer, lookup, x: str, beg: bool) -> int:
    """Address -> entry index; ``lookup(codes)`` returns the first
    index >= the padded probe (Interpret GIXshow.c:520-570)."""
    try:
        d = int(x)
    except ValueError:
        d = None
    if d is not None:
        if d >= n:
            raise _common.ArgError("gixshow", f"Index {x} is out of bounds")
        return d if beg else d + 1
    x = x.lower()
    if any(c not in "acgt" for c in x):
        raise _common.ArgError("gixshow", f"String {x} is not dna (acgt)")
    if len(x) > kmer:
        raise _common.ArgError("gixshow", f"String {x} is longer than "
                               f"k-mer size ({kmer})")
    probe = list(x)
    if not beg:
        i = len(probe) - 1
        while i >= 0 and probe[i] == "t":
            i -= 1
        if i < 0:
            return n
        probe[i] = _BASES[_BASES.index(probe[i]) + 1]
        probe = probe[:i + 1]
    s = "".join(probe) + "a" * (kmer - len(probe))
    codes = np.array([_BASES.index(c) for c in s], np.uint8)
    return lookup(codes)


def _addr_range(pos, n, kmer, lookup):
    if len(pos) == 1:
        return 0, n
    x = pos[1]
    if "-" in x:
        a, b = x.split("-", 1)
        return (_interpret(n, kmer, lookup, a, True),
                _interpret(n, kmer, lookup, b, False))
    return (_interpret(n, kmer, lookup, x, True),
            _interpret(n, kmer, lookup, x, False))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="")
    if not 1 <= len(pos) <= 2:
        raise _common.ArgError("gixshow", "expects source and optional "
                               "address range", USAGE)
    root = _common._root(Path(pos[0]))
    out = sys.stdout
    try:
        s = gixm.KmerStream(root)
    except ValueError:
        # old-format (<= v1.2) GIX: in-memory table path
        t = gixm.read_gix(root)
        bidx, eidx = _addr_range(pos, t.n, t.kmer, t.searchsorted)
        perm = np.asarray(t.perm)
        out.write(f"  Index: K-mer{'':{t.kmer - 5}} mask lcp sign contig"
                  f" |  position\n")
        for i in range(bidx, eidx):
            out.write(f" {i:6d}: {_kmer_string(t, i)}")
            mb = int(t.maskb[i])
            out.write("   *" if mb == 0 else f" {mb:3d}")
            lc = int(t.lcp[i])
            out.write("   *" if lc == t.kmer else f" {lc:3d}")
            sign = "-" if t.comp[i] else "+"
            out.write(f"    {sign}  {perm[int(t.cont[i])]:4d}   "
                      f"| {int(t.post[i]):9d}\n")
        return 0

    # new format: stream through the bounded cursor (the index never
    # materializes in RAM — GIXshow.c walks its Kmer_Stream the same way)
    with s:
        bidx, eidx = _addr_range(pos, s.nels, s.kmer, s.goto_kmer)
        perm = np.asarray(s.perm)
        out.write(f"  Index: K-mer{'':{s.kmer - 5}} mask lcp sign contig"
                  f" |  position\n")
        if bidx < eidx:
            s.goto_index(bidx)
        i = bidx
        while i < eidx:
            codes = s.kmer_codes()
            txt = "".join(_BASES[c] for c in codes)
            out.write(f" {i:6d}: {txt}")
            mb = s.maskb
            out.write("   *" if mb == 0 else f" {mb:3d}")
            lc = s.lcp
            out.write("   *" if lc == s.kmer else f" {lc:3d}")
            sign = "-" if s.comp else "+"
            out.write(f"    {sign}  {perm[int(s.cont)]:4d}   "
                      f"| {int(s.post):9d}\n")
            i += 1
            if i < eidx:
                s.next()
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
