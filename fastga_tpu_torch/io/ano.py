# Copied from fastga_tpu/io/ano.py; imports point at fastga_tpu_torch.
""".1ano — ONEcode mask/annotation interval files (ANO.c equivalent).

Schema per ANO.c:33-48: optional GDB skeleton group, then `M` lines with
(scaffold index, beg, end) in scaffold coordinates, with optional `L` label /
`X` score / `P` partition lines.  In core we keep contig-relative sorted
intervals (ANO.h:25-51); conversion scaffold<->contig happens at IO
boundaries like Read_ANO (ANO.c:105).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from . import onecode
from .gdb import GDB, MaskIval, Scaffold, Contig

ANO_SCHEMA_TEXT = """\
P 3 ano
O g 0
G S
O S 1 6 STRING
D G 1 3 INT
D C 1 3 INT
O M 3 3 INT 3 INT 3 INT
D L 1 6 STRING
D X 1 3 INT
D P 1 8 INT_LIST
"""

ANO_SCHEMA = onecode.OneSchema.from_text(ANO_SCHEMA_TEXT)["ano"]


def ano_path(path) -> Path:
    p = Path(path)
    if not p.name.endswith(".1ano"):
        p = p.parent / (p.name + ".1ano")
    return p


def write_ano(path, gdb: GDB, masks: Sequence[MaskIval],
              with_skeleton: bool = True, command: str = "") -> Path:
    """Write contig-relative mask intervals as a .1ano (scaffold coords)."""
    p = ano_path(path)
    w = onecode.OneWriter(p, ANO_SCHEMA, "ano")
    w.add_provenance("fastga_tpu", "0.1", command or "write_ano")
    # the source reference is load-bearing: the reference Read_ANO
    # dereferences oneFile->reference[0] unconditionally
    if gdb.srcpath:
        w.add_reference(gdb.srcpath, 1)
    if with_skeleton:
        w.write("g")
        for s in gdb.scaffolds:
            w.write("S", s.header)
            spos = 0
            for c in range(s.fctg, s.ectg):
                ctg = gdb.contigs[c]
                if ctg.sbeg > spos:
                    w.write("G", ctg.sbeg - spos)
                w.write("C", ctg.clen)
                spos = ctg.sbeg + ctg.clen
            if s.slen > spos:
                w.write("G", s.slen - spos)
    for m in sorted(masks, key=lambda m: (gdb.contigs[m.contig].scaf,
                                          gdb.contigs[m.contig].sbeg + m.beg)):
        ctg = gdb.contigs[m.contig]
        w.write("M", ctg.scaf, ctg.sbeg + m.beg, ctg.sbeg + m.end)
    w.close()
    return p


def read_ano(path, gdb: GDB) -> List[MaskIval]:
    """Read a .1ano and convert to contig-relative intervals.

    Intervals are clipped to contigs (portions falling into gaps are
    dropped), then sorted per contig by beg (Read_ANO semantics).
    """
    p = ano_path(path)
    from .onecode_binary import open_any
    r = open_any(p, ANO_SCHEMA)
    out: List[MaskIval] = []
    # map scaffold -> its contigs, for coordinate conversion
    by_scaf: dict = {}
    for ci, c in enumerate(gdb.contigs):
        by_scaf.setdefault(c.scaf, []).append(ci)
    for line in r:
        if line.type != "M":
            continue
        s, beg, end = line.fields
        for ci in by_scaf.get(s, []):
            c = gdb.contigs[ci]
            lo = max(beg, c.sbeg)
            hi = min(end, c.sbeg + c.clen)
            if lo < hi:
                out.append(MaskIval(ci, lo - c.sbeg, hi - c.sbeg))
    r.close()
    out.sort(key=lambda m: (m.contig, m.beg))
    return out


@dataclass
class AnoRecord:
    """Full annotation interval (ANO_PAIR ANO.h:25-40): contig-relative
    coordinates after Read_ANO conversion; `end` may extend past the contig
    (intervals spanning gaps are assigned to the contig containing beg)."""
    contig: int
    beg: int
    end: int
    orient: int = 0     # 1 if the M line had beg > end
    label: Optional[str] = None
    score: int = 0
    parse: Optional[List[int]] = None


def read_ano_records(path, gdb: Optional[GDB] = None):
    """Full .1ano read (Read_ANO ANO.c:105-530): returns (gdb, per-contig
    record lists, provenance).  If ``gdb`` is None the embedded skeleton is
    used."""
    from .onecode_binary import open_any

    p = ano_path(path)
    r = open_any(p, ANO_SCHEMA)
    skel: Optional[GDB] = None if gdb is None else gdb
    recs: List[AnoRecord] = []
    scaf: Optional[Scaffold] = None
    spos = 0
    boff = 0
    building = gdb is None
    sk = None
    for line in r:
        t = line.type
        if t == "g" and building:
            from .gdb import GDB as _GDB
            sk = _GDB()
            skel = sk
        elif t == "S" and building and sk is not None:
            if scaf is not None:
                scaf.slen = spos
                scaf.ectg = sk.ncontig
            scaf = Scaffold(0, sk.ncontig, sk.ncontig, line.fields[0])
            sk.scaffolds.append(scaf)
            spos = 0
        elif t == "G" and building and sk is not None:
            spos += line.fields[0]
        elif t == "C" and building and sk is not None:
            clen = line.fields[0]
            sk.contigs.append(Contig(clen, spos, boff, sk.nscaff - 1))
            boff += (clen + 3) // 4
            spos += clen
            sk.seqtot += clen
            sk.maxctg = max(sk.maxctg, clen)
        elif t == "M":
            s, beg, end = line.fields
            if beg < end:
                recs.append(AnoRecord(s, beg, end, 0))
            else:
                recs.append(AnoRecord(s, end, beg, 1))
        elif t == "L" and recs:
            recs[-1].label = line.fields[0]
        elif t == "X" and recs:
            recs[-1].score = line.fields[0]
        elif t == "P" and recs:
            recs[-1].parse = list(line.fields[0])
    if building and scaf is not None and sk is not None:
        scaf.slen = spos
        scaf.ectg = sk.ncontig
    prov = r.provenance
    r.close()
    if skel is None:
        raise ValueError(f"{p}: no GDB skeleton and none supplied")

    # per-scaffold sort by beg, then scaffold -> contig coordinates:
    # each interval goes to the contig containing beg (end may overhang)
    recs.sort(key=lambda m: (m.contig, m.beg))
    by_ctg: List[List[AnoRecord]] = [[] for _ in range(skel.ncontig)]
    for m in recs:
        s = skel.scaffolds[m.contig]
        # the contig whose [sbeg, next sbeg) window contains beg
        # (ANO.c:460-487: gap positions attach to the preceding contig)
        ctg = s.fctg
        while ctg + 1 < s.ectg and m.beg >= skel.contigs[ctg + 1].sbeg:
            ctg += 1
        c = skel.contigs[ctg]
        by_ctg[ctg].append(AnoRecord(ctg, m.beg - c.sbeg, m.end - c.sbeg,
                                     m.orient, m.label, m.score, m.parse))
    return skel, by_ctg, prov


def write_ano_records(path, gdb: GDB, by_ctg: Sequence[List[AnoRecord]],
                      command: str = "", with_skeleton: bool = True,
                      srcpath: str = "") -> Path:
    """Write full annotation records (scaffold coords, orient via swapped
    beg/end, L/X/P companion lines)."""
    p = ano_path(path)
    w = onecode.OneWriter(p, ANO_SCHEMA, "ano")
    w.add_provenance("fastga_tpu", "0.1", command or "write_ano")
    src = srcpath or gdb.srcpath
    if src:
        w.add_reference(src, 1)
    if with_skeleton:
        w.write("g")
        for s in gdb.scaffolds:
            w.write("S", s.header)
            spos = 0
            for c in range(s.fctg, s.ectg):
                ctg = gdb.contigs[c]
                if ctg.sbeg > spos:
                    w.write("G", ctg.sbeg - spos)
                w.write("C", ctg.clen)
                spos = ctg.sbeg + ctg.clen
            if s.slen > spos:
                w.write("G", s.slen - spos)
    for ctg_recs in by_ctg:
        for m in ctg_recs:
            c = gdb.contigs[m.contig]
            b, e = m.beg + c.sbeg, m.end + c.sbeg
            if m.orient:
                b, e = e, b
            w.write("M", c.scaf, b, e)
            if m.label is not None:
                w.write("L", m.label)
            if m.score > 0:
                w.write("X", m.score)
            if m.parse:
                w.write("P", m.parse)
    w.close()
    return p


def ano_union(mask_lists: Sequence[List[MaskIval]]) -> List[MaskIval]:
    """Union of several mask sets (ANO_Union ANO.c:641)."""
    allm = sorted((m for ml in mask_lists for m in ml),
                  key=lambda m: (m.contig, m.beg))
    out: List[MaskIval] = []
    for m in allm:
        if out and out[-1].contig == m.contig and m.beg <= out[-1].end:
            if m.end > out[-1].end:
                out[-1] = MaskIval(m.contig, out[-1].beg, m.end)
        else:
            out.append(MaskIval(m.contig, m.beg, m.end))
    return out
