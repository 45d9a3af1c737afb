# Copied from fastga_tpu/cli/alnchain.py; imports point at fastga_tpu_torch.
"""alnchain — chain filter toward 1-to-1 alignment (ALNchain.c surface).

    python -m fastga_tpu_torch.cli.alnchain [-v] [-g<int(10000)>] [-l<int(10000)>]
        [-p<float(.1)>] [-q<float(.1)>] [-z<int(1000)>] [-s<int(10000)>]
        [-n<int(1)>] [-c<float(.5)>] [-e<float(0)>] [-f<int(1000)>]
        [-o<output>[.1aln]] <alignments>[.1aln]

Default output <root>.chain.1aln.  Works in scaffold coordinates, chains
per (B-scaffold, strand) within each A-scaffold group, then filters
chains adding too little novel coverage.
"""

from __future__ import annotations

import sys
from pathlib import Path

from . import _common
from ..io import alncode, onecode
from ..io.onecode_binary import BinaryReader, BinaryWriter, open_any
from ..ops import chainfilter as cf

USAGE = ("[-v] [-g<int(10000)>] [-l<int(10000)>] [-p<float(.1)>] "
         "[-q<float(.1)>] [-z<int(1000)>] [-s<int(10000)>] [-n<int(1)>] "
         "[-c<float(.5)>] [-e<float(0)>] [-f<int(1000)>] "
         "[-o<output:path>[.1aln]] <alignments:path>[.1aln]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts, pos = _common.parse_args(argv, flags="v", opts="glpqzsncef",
                                   str_opts="o")
    if len(pos) != 1:
        raise _common.ArgError("alnchain", "expects one .1aln", USAGE)
    max_gap = _common.opt_int(opts, "g", 10000)
    max_ovl = _common.opt_int(opts, "l", 10000)
    pen_gap = _common.opt_float(opts, "p", 0.1)
    pen_ovl = _common.opt_float(opts, "q", 0.1)
    max_drop = _common.opt_int(opts, "z", 1000)
    min_score = _common.opt_int(opts, "s", 10000)
    min_frag = _common.opt_int(opts, "n", 1)
    max_cov = _common.opt_float(opts, "c", 0.5)
    min_ext = _common.opt_float(opts, "e", 0.0)
    fz_merge = _common.opt_int(opts, "f", 1000)

    p = Path(pos[0])
    if not p.name.endswith(".1aln"):
        q = Path(str(p) + ".1aln")
        if q.exists():
            p = q
    af, gdb1, gdb2 = _common.open_aln(str(p), "alnchain")
    actg, ascf = gdb1.contigs, gdb1.scaffolds
    bctg, bscf = gdb2.contigs, gdb2.scaffolds

    out = opts.get("o")
    if out:
        if not out.endswith(".1aln"):
            out += ".1aln"
    else:
        name = p.name[:-5]
        out = str(p.parent / (name + ".chain.1aln"))

    # build node list per record in scaffold coordinates
    def make_node(i, o):
        apulse = actg[o.aread].sbeg
        bpulse = bctg[o.bread].sbeg
        b = bctg[o.bread].scaf << 1
        if o.bcomp:
            b |= 1
            boff = bpulse + bctg[o.bread].clen
            blen = bscf[bctg[o.bread].scaf].slen
            bb = blen - (boff - o.bbpos)
            be = blen - (boff - o.bepos)
        else:
            bb = o.bbpos + bpulse
            be = o.bepos + bpulse
        n = cf.Node(bread=b, abpos=o.abpos + apulse, aepos=o.aepos + apulse,
                    bbpos=bb, bepos=be, which=i)
        n.score = n.aln_size()
        return n

    survivors = []
    nchain = nalign = 0
    i = 0
    novl = len(af.overlaps)
    while i < novl:
        ascaf = actg[af.overlaps[i].aread].scaf
        j = i
        while j < novl and actg[af.overlaps[j].aread].scaf == ascaf:
            j += 1
        nodes = [make_node(k, af.overlaps[k]) for k in range(i, j)]
        nodes.sort(key=lambda n: (n.bread, n.abpos))
        alen = ascf[ascaf].slen

        # chain per (bscaf, strand) run
        k = 0
        for m in range(1, len(nodes) + 1):
            if m == len(nodes) or nodes[m].bread != nodes[k].bread:
                cf.local_chain(nodes[k:m], max_gap, max_ovl, pen_gap,
                               pen_ovl, max_drop, min_frag, min_score)
                k = m
        # filter per bscaf run
        k = 0
        for m in range(1, len(nodes) + 1):
            if m == len(nodes) or (nodes[m].bread >> 1) != \
                    (nodes[k].bread >> 1):
                cf.filter_chains(nodes[k:m], alen,
                                 lambda bs: bscf[bs].slen,
                                 max_cov, min_ext, fz_merge)
                k = m

        # mark survivors: heads + their chain members
        for n in nodes:
            if n.active != cf.HEAD:
                n.active = 0
        for n in nodes:
            if n.active != cf.HEAD:
                continue
            nchain += 1
            nalign += 1
            node = n.next
            while node is not None:
                node.active = cf.INTERNAL
                node = node.next
                nalign += 1
        survivors.extend(n.which for n in nodes if n.active)
        i = j

    # copy surviving records (with their companion lines) to the output
    r = open_any(p, alncode.ALN_SCHEMA)
    binary = isinstance(r, BinaryReader)
    lines = list(r)
    prov = list(r.provenance)
    refs = list(r.references)
    r.close()
    # index record boundaries
    starts = [k for k, ln in enumerate(lines) if ln.type == "A"]
    starts.append(len(lines))
    head_end = starts[0] if starts else len(lines)

    cls = BinaryWriter if binary else onecode.OneWriter
    w = cls(out, alncode.ALN_SCHEMA, "aln")
    for pr in prov:
        w.provenance.append(pr)
    w.add_provenance("alnchain", "0.1", "alnchain " + " ".join(argv))
    for ref in refs:
        w.add_reference(ref.filename, ref.count)
    for ln in lines[:head_end]:
        w.write(ln.type, *ln.fields)
    for which in survivors:
        for ln in lines[starts[which]:starts[which + 1]]:
            w.write(ln.type, *ln.fields)
    w.close()

    sys.stderr.write(f"alnchain: retained {nalign} alignments in "
                     f"{nchain} chains\n")
    return 0


if __name__ == "__main__":
    _common.cli_exit(main)
