# Copied from fastga_tpu/io/alncode.py; imports point at fastga_tpu_torch.
""".1aln — ONEcode alignment files: schema, Overlap records, read/write.

Mirrors the reference's alncode.c (schema text alncode.c:19-52; record IO
Write_Aln_Overlap/Trace alncode.c:272-305; header open_Aln_Write 239-270) and
GDB skeleton embedding (Write_Skeleton GDB.c:2065-2092).

Conventions: one `A` object per alignment with scaffold-agnostic *contig*
ids and contig coordinates; `R` flags B reverse-complement (b coords are in
B-complement space); `D` diffs; `T` the per-trace-interval B advances;
`X` the per-interval diff counts; global `t` line = trace spacing (100).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path as _P
from typing import List, Optional, Tuple

import numpy as np

from . import onecode
from .gdb import GDB, Contig, Scaffold

ALN_SCHEMA_TEXT = """\
P 3 aln
D t 1 3 INT
O g 0
G S
O S 1 6 STRING
D G 1 3 INT
D C 1 3 INT
O a 0
G A
D p 2 3 INT 3 INT
O A 6 3 INT 3 INT 3 INT 3 INT 3 INT 3 INT
D L 2 3 INT 3 INT
D R 0
D D 1 3 INT
D T 1 8 INT_LIST
D X 1 8 INT_LIST
D Q 1 3 INT
D E 1 3 INT
D Z 1 6 STRING
D U 1 3 INT
"""

ALN_SCHEMA = onecode.OneSchema.from_text(ALN_SCHEMA_TEXT)["aln"]

COMP_FLAG = 0x1


@dataclass
class Overlap:
    """One local alignment (align.h Overlap/Path semantics).

    ``bcomp``: b coordinates are in B-complement space (the `R` line).
    ``trace``: list of (diffs, b-advance) per trace interval.
    """
    aread: int
    bread: int
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    diffs: int
    bcomp: bool
    trace: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def alen_span(self):
        return self.aepos - self.abpos


class AlnWriter:
    def __init__(self, path, tspace: int, db1_name: str,
                 db2_name: Optional[str], cpath: str,
                 prog: str = "fastga_tpu", version: str = "0.1",
                 command: str = "", binary: bool = True):
        """``binary`` matches the reference default (FastGA writes binary
        .1aln); pass False for the ASCII form."""
        if binary:
            from .onecode_binary import BinaryWriter
            self.w = BinaryWriter(path, ALN_SCHEMA, "aln")
        else:
            self.w = onecode.OneWriter(path, ALN_SCHEMA, "aln")
        self.w.add_provenance(prog, version, command or prog)
        self.w.add_reference(db1_name, 1)
        if db2_name is not None:
            self.w.add_reference(db2_name, 2)
        if cpath:
            self.w.add_reference(cpath, 3)
        self.w.write("t", tspace)

    def write_skeleton(self, gdb: GDB):
        self.w.write("g")
        for s in gdb.scaffolds:
            self.w.write("S", s.header)
            spos = 0
            for c in range(s.fctg, s.ectg):
                ctg = gdb.contigs[c]
                if ctg.sbeg > spos:
                    self.w.write("G", ctg.sbeg - spos)
                self.w.write("C", ctg.clen)
                spos = ctg.sbeg + ctg.clen
            if s.slen > spos:
                self.w.write("G", s.slen - spos)

    def write_overlap(self, o: Overlap):
        self.w.write("A", o.aread, o.abpos, o.aepos,
                     o.bread, o.bbpos, o.bepos)
        if o.bcomp:
            self.w.write("R")
        self.w.write("D", o.diffs)
        self.w.write("T", [b for _, b in o.trace])
        self.w.write("X", [d for d, _ in o.trace])

    def close(self):
        self.w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclass
class AlnFile:
    tspace: int
    overlaps: List[Overlap]
    skeletons: List[GDB]
    db1_name: str = ""
    db2_name: str = ""
    cpath: str = ""
    provenance: list = field(default_factory=list)


def read_aln(path) -> AlnFile:
    from .onecode_binary import open_any
    r = open_any(_P(path), ALN_SCHEMA)
    tspace = 100
    overlaps: List[Overlap] = []
    skeletons: List[GDB] = []
    cur: Optional[Overlap] = None
    gdb: Optional[GDB] = None
    scaf: Optional[Scaffold] = None
    spos = 0
    boff = 0

    def close_scaffold():
        nonlocal scaf
        if gdb is not None and scaf is not None:
            scaf.slen = spos
            scaf.ectg = gdb.ncontig

    for line in r:
        t = line.type
        if t == "t":
            tspace = line.fields[0]
        elif t == "g":
            close_scaffold()
            scaf = None
            gdb = GDB()
            skeletons.append(gdb)
            boff = 0
        elif t == "S" and gdb is not None:
            close_scaffold()
            scaf = Scaffold(0, gdb.ncontig, gdb.ncontig, line.fields[0])
            gdb.scaffolds.append(scaf)
            spos = 0
        elif t == "G" and gdb is not None:
            spos += line.fields[0]
        elif t == "C" and gdb is not None:
            clen = line.fields[0]
            gdb.contigs.append(Contig(clen, spos, boff, gdb.nscaff - 1))
            boff += (clen + 3) // 4
            spos += clen
            gdb.seqtot += clen
            gdb.maxctg = max(gdb.maxctg, clen)
        elif t == "A":
            close_scaffold()
            scaf = None
            gdb = None
            f = line.fields
            cur = Overlap(f[0], f[3], f[1], f[2], f[4], f[5], 0, False)
            overlaps.append(cur)
        elif t == "R" and cur is not None:
            cur.bcomp = True
        elif t == "D" and cur is not None:
            cur.diffs = line.fields[0]
        elif t == "T" and cur is not None:
            cur.trace = [(0, b) for b in line.fields[0]]
        elif t == "X" and cur is not None:
            cur.trace = [(d, b) for d, (_, b) in
                         zip(line.fields[0], cur.trace)]
    close_scaffold()

    out = AlnFile(tspace=tspace, overlaps=overlaps, skeletons=skeletons,
                  provenance=r.provenance)
    for ref in r.references:
        if ref.count == 1:
            out.db1_name = ref.filename
        elif ref.count == 2:
            out.db2_name = ref.filename
        elif ref.count == 3:
            out.cpath = ref.filename
    r.close()
    return out
