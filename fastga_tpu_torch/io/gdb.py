# Port of fastga_tpu/io/gdb.py; imports point at fastga_tpu_torch, and
# create_gdb parses FASTA in one native pass (native/fagdb.c).
"""GDB — genome database: `.1gdb` ONEcode skeleton + hidden `.bps` 2-bit store.

Clean-room equivalent of the reference's GDB.c:

- Create from FASTA(.gz) with N-run contig splitting (Create_GDB GDB.c:442-1050),
  in one pass of ``native/fagdb.c`` over the file's bytes, or in the numpy
  body below when that library cannot be built:
  runs of non-acgt characters shorter than ``ncut`` become 'a' bases inside the
  contig, runs >= ``ncut`` split contigs and are recorded as scaffold gaps;
  trailing non-acgt runs of a scaffold are dropped; lower-case runs become
  soft-mask intervals in contig coordinates, discarded if the *whole* input is
  lower-case (the ``allow`` rule GDB.c:990-1005,1056).
- `.1gdb` skeleton emission order matches Write_GDB (GDB.c:1589-1614):
  `f` base-frequency line, then per scaffold an `S` header line followed by
  alternating `G` gap / `C` contig length lines.
- `.bps` packs each contig 2-bit (base i at bit 2*(i%4)), each contig starting
  on a fresh byte; `boff` is that byte offset (GDB.c:880-980).

The in-memory model mirrors GDB.h:28-88 (GDB_CONTIG {clen,sbeg,boff,scaf},
GDB_SCAFFOLD {slen,fctg,ectg,header}).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..utils import dna, prof
from . import onecode

GDB_SCHEMA_TEXT = """\
P 3 gdb
D f 4 4 REAL 4 REAL 4 REAL 4 REAL
D u 0
O S 1 6 STRING
D G 1 3 INT
D C 1 3 INT
D M 1 8 INT_LIST
"""

GDB_SCHEMA = onecode.OneSchema.from_text(GDB_SCHEMA_TEXT)["gdb"]


@dataclass
class Scaffold:
    slen: int          # total scaffold length incl. gaps
    fctg: int          # first contig index
    ectg: int          # one past last contig index
    header: str


@dataclass
class Contig:
    clen: int          # contig length in bases
    sbeg: int          # start within scaffold
    boff: int          # byte offset in .bps
    scaf: int          # owning scaffold index


@dataclass
class MaskIval:
    contig: int
    beg: int           # contig-relative
    end: int


class GDB:
    def __init__(self):
        self.scaffolds: List[Scaffold] = []
        self.contigs: List[Contig] = []
        self.freq = np.full(4, 0.25)
        self.seqtot = 0
        self.maxctg = 0
        self.srcpath = ""
        self.bps_path: Optional[Path] = None
        self._bps: Optional[np.ndarray] = None  # packed bytes, memory-resident

    # -- properties ---------------------------------------------------------

    @property
    def nscaff(self) -> int:
        return len(self.scaffolds)

    @property
    def ncontig(self) -> int:
        return len(self.contigs)

    def contig_lengths(self) -> np.ndarray:
        return np.array([c.clen for c in self.contigs], dtype=np.int64)

    # -- sequence access ----------------------------------------------------

    def _packed(self) -> np.ndarray:
        if self._bps is None:
            self._bps = np.fromfile(self.bps_path, dtype=np.uint8)
        return self._bps

    def get_contig(self, i: int) -> np.ndarray:
        """Numeric codes (uint8 in [0,3]) of contig i (Get_Contig NUMERIC)."""
        c = self.contigs[i]
        nbytes = (c.clen + 3) // 4
        packed = self._packed()[c.boff : c.boff + nbytes]
        return dna.uncompress(packed, c.clen)

    def get_contig_piece(self, i: int, beg: int, end: int) -> np.ndarray:
        c = self.contigs[i]
        b0 = c.boff + beg // 4
        b1 = c.boff + (end + 3) // 4
        packed = self._packed()[b0:b1]
        return dna.uncompress(packed, end - beg, beg % 4)

    # -- path conventions ---------------------------------------------------

    @staticmethod
    def paths(path) -> Tuple[Path, Path]:
        """(skeleton path, hidden .bps path) for a GDB root or .1gdb path."""
        p = Path(path)
        name = p.name
        for ext in (".1gdb", ".gdb"):
            if name.endswith(ext):
                name = name[: -len(ext)]
                break
        skel = p.parent / (name + ".1gdb")
        bps = p.parent / ("." + name + ".bps")
        return skel, bps


# -- FASTA -> GDB ------------------------------------------------------------


def _read_fasta(path) -> bytes:
    """The bytes of a FASTA(.gz) file, which must start with a header."""
    p = Path(path)
    opener = gzip.open if p.suffix == ".gz" or _is_gzip(p) else open
    with opener(p, "rb") as f:
        data = f.read()
    if not data.startswith(b">"):
        raise ValueError(f"{path}: first FASTA header missing")
    return data


def _header(data: bytes, beg: int, end: int) -> str:
    return data[beg:end].strip().decode("utf-8", "replace")


def _read_fasta_scaffolds(path) -> List[Tuple[str, np.ndarray]]:
    """Parse FASTA(.gz) into (header, raw ASCII byte array) per scaffold."""
    data = _read_fasta(path)
    buf = np.frombuffer(data, dtype=np.uint8)
    nl = np.flatnonzero(buf == ord("\n"))
    # line starts
    starts = np.concatenate([[0], nl + 1])
    if starts[-1] >= len(buf):
        starts = starts[:-1]
    hdr_mask = buf[starts] == ord(">")
    hdr_starts = starts[hdr_mask]
    scaffolds = []
    bounds = np.append(hdr_starts, len(buf))
    for k in range(len(hdr_starts)):
        s0 = hdr_starts[k]
        e0 = bounds[k + 1]
        line_end = data.find(b"\n", s0, e0)
        if line_end < 0:
            line_end = e0
        header = _header(data, s0 + 1, line_end)
        seq = buf[line_end + 1 : e0]
        seq = seq[(seq != ord("\n")) & (seq != ord("\r"))]
        scaffolds.append((header, seq))
    return scaffolds


def _is_gzip(p: Path) -> bool:
    with open(p, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _runs(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run-length encode a boolean array: (values, starts, lengths)."""
    if len(mask) == 0:
        z = np.zeros(0, dtype=np.int64)
        return z.astype(bool), z, z
    change = np.flatnonzero(mask[1:] != mask[:-1]) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(mask)]])
    return mask[starts], starts, ends - starts


def create_gdb(fasta_path, target=None, ncut: int = 0,
               ) -> Tuple[GDB, List[MaskIval]]:
    """FASTA -> GDB (.1gdb + .bps written if ``target`` given).

    Returns (gdb, soft-mask intervals).  Semantics per Create_GDB: non-acgt
    runs < ncut kept as 'a' in-contig, >= ncut split contigs as gaps, trailing
    runs dropped, all-lowercase input yields no masks.
    """
    with prof.span("gdb.create"):
        gdb = GDB()
        gdb.srcpath = str(Path(fasta_path).resolve())
        lib = native.get_fagdb()
        if lib is not None:
            masks = _parse_native(lib, gdb, fasta_path, ncut)
        else:
            masks = _parse_numpy(gdb, fasta_path, ncut)
        if target is not None:
            write_gdb(gdb, target)
        return gdb, masks


def _rows(ptr, n: int, width: int) -> np.ndarray:
    """A copy of ``n`` rows of ``width`` from a C buffer."""
    if n == 0:
        return np.zeros((0, width), dtype=np.int64)
    return np.ctypeslib.as_array(ptr, shape=(n, width)).copy()


def _parse_native(lib, gdb: GDB, fasta_path, ncut: int) -> List[MaskIval]:
    """Fill ``gdb`` from native/fagdb.c's one pass; return the masks."""
    data = _read_fasta(fasta_path)
    h = lib.fag_new()
    if not h:
        raise MemoryError("fag_new")
    try:
        rc = lib.fag_parse(h, data, len(data), ncut)
        r = h.contents
        scaf = _rows(r.scaf, r.nscaf, 5)
        if rc == 1:
            header = _header(data, int(scaf[-1, 0]), int(scaf[-1, 1]))
            raise ValueError(
                f"{fasta_path}: scaffold '{header}' has no sequence")
        if rc:  # -1, out of memory (2, no first '>', is ruled out above)
            raise MemoryError(f"fag_parse returned {rc}")
        ctg = _rows(r.ctg, r.nctg, 4)
        mask = _rows(r.mask, r.nmask, 3)
        gdb._bps = (np.ctypeslib.as_array(r.bps, shape=(r.nbps,)).copy()
                    if r.nbps else np.zeros(0, dtype=np.uint8))
        counts = np.array(r.counts[:], dtype=np.int64)
        gdb.maxctg = int(r.maxctg)
        saw_upper = bool(r.saw_upper)
    finally:
        lib.fag_free(h)
    prof.count("gdb.native_parses")
    gdb.scaffolds = [Scaffold(slen, fctg, ectg, _header(data, hb, he))
                     for hb, he, slen, fctg, ectg in scaf.tolist()]
    gdb.contigs = [Contig(*row) for row in ctg.tolist()]
    gdb.seqtot = int(counts.sum())
    if gdb.seqtot > 0:
        gdb.freq = counts / gdb.seqtot
    if not saw_upper:
        return []
    return [MaskIval(*row) for row in mask.tolist()]


def _parse_numpy(gdb: GDB, fasta_path, ncut: int) -> List[MaskIval]:
    """Fill ``gdb`` by whole-array numpy passes; return the masks."""
    masks: List[MaskIval] = []
    counts = np.zeros(4, dtype=np.int64)
    packed_chunks: List[np.ndarray] = []
    boff = 0
    saw_upper = False

    for header, raw in _read_fasta_scaffolds(fasta_path):
        codes = dna.ASCII_TO_CODE[raw]
        is_base = codes < 4
        # drop trailing non-acgt run (the reference drops it from slen
        # entirely)
        nb = len(raw)
        if nb and not is_base[-1]:
            # find last base
            idx = np.flatnonzero(is_base)
            nb = int(idx[-1]) + 1 if len(idx) else 0
            raw = raw[:nb]
            codes = codes[:nb]
            is_base = is_base[:nb]
        if nb == 0:
            raise ValueError(
                f"{fasta_path}: scaffold '{header}' has no sequence")

        lower = dna.IS_LOWER[raw]
        saw_upper = saw_upper or bool((is_base & ~lower).any())

        vals, starts, lens = _runs(is_base)
        fctg = gdb.ncontig
        spos = 0
        # assemble contigs: consecutive base-runs merged across short
        # N-runs
        cur_codes: List[np.ndarray] = []
        cur_lower: List[np.ndarray] = []
        cur_sbeg = 0

        def flush_contig():
            nonlocal boff, spos
            if cur_codes:
                cc = np.concatenate(cur_codes)
                ll = np.concatenate(cur_lower)
            else:
                cc = np.zeros(0, dtype=np.uint8)
                ll = np.zeros(0, dtype=bool)
            ci = gdb.ncontig
            gdb.contigs.append(Contig(len(cc), cur_sbeg, boff, gdb.nscaff))
            if len(cc):
                counts[:] += np.bincount(cc, minlength=4)[:4]
                pk = dna.compress(cc)
                packed_chunks.append(pk)
                boff += len(pk)
                gdb.maxctg = max(gdb.maxctg, len(cc))
                mv, ms, mlen = _runs(ll)
                for v, s0, l0 in zip(mv, ms, mlen):
                    if v:
                        masks.append(MaskIval(ci, int(s0), int(s0 + l0)))

        i = 0
        nruns = len(vals)
        while i < nruns:
            v, s0, l0 = bool(vals[i]), int(starts[i]), int(lens[i])
            if v:
                cur_codes.append(codes[s0 : s0 + l0])
                cur_lower.append(lower[s0 : s0 + l0])
            else:
                if l0 < ncut:
                    # short N-run kept as 'a' bases, counted as base 0
                    cur_codes.append(np.zeros(l0, dtype=np.uint8))
                    cur_lower.append(np.zeros(l0, dtype=bool))
                else:
                    flush_contig()
                    spos = s0 + l0
                    cur_sbeg = spos
                    cur_codes, cur_lower = [], []
            i += 1
        flush_contig()
        gdb.scaffolds.append(Scaffold(nb, fctg, gdb.ncontig, header))

    if not saw_upper:
        masks = []

    gdb.seqtot = int(counts.sum())
    if gdb.seqtot > 0:
        gdb.freq = counts / gdb.seqtot
    gdb._bps = (np.concatenate(packed_chunks) if packed_chunks
                else np.zeros(0, dtype=np.uint8))
    return masks


def write_gdb(gdb: GDB, target, provenance_cmd: str = "") -> Path:
    """Write `.1gdb` skeleton + `.bps` (Write_GDB GDB.c:1529-1614)."""
    skel, bps = GDB.paths(target)
    gdb._packed().tofile(bps)
    gdb.bps_path = bps
    w = onecode.OneWriter(skel, GDB_SCHEMA, "gdb")
    w.add_provenance("fastga_tpu", "0.1", provenance_cmd or "write_gdb")
    w.add_reference(gdb.srcpath, 1)
    w.write("f", *[float(x) for x in gdb.freq])
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
    w.close()
    return skel


def read_gdb(path) -> GDB:
    """Read a `.1gdb` skeleton (+ locate `.bps`)."""
    skel, bps = GDB.paths(path)
    gdb = GDB()
    gdb.bps_path = bps
    from .onecode_binary import open_any
    r = open_any(skel, GDB_SCHEMA)
    if r.references:
        gdb.srcpath = r.references[0].filename
    boff = 0
    spos = 0
    cur_scaf = -1
    for line in r:
        if line.type == "f":
            gdb.freq = np.array(line.fields, dtype=np.float64)
        elif line.type == "S":
            if cur_scaf >= 0:
                gdb.scaffolds[cur_scaf].slen = spos
                gdb.scaffolds[cur_scaf].ectg = gdb.ncontig
            gdb.scaffolds.append(Scaffold(0, gdb.ncontig, gdb.ncontig,
                                          line.fields[0]))
            cur_scaf += 1
            spos = 0
        elif line.type == "G":
            spos += line.fields[0]
        elif line.type == "C":
            clen = line.fields[0]
            gdb.contigs.append(Contig(clen, spos, boff, cur_scaf))
            boff += (clen + 3) // 4
            spos += clen
            gdb.maxctg = max(gdb.maxctg, clen)
            gdb.seqtot += clen
    if cur_scaf >= 0:
        gdb.scaffolds[cur_scaf].slen = spos
        gdb.scaffolds[cur_scaf].ectg = gdb.ncontig
    r.close()
    return gdb


def gdb_to_fasta(gdb: GDB, out_path, width: int = 80,
                 masks: Optional[List[MaskIval]] = None):
    """GDB -> FASTA (GDBtoFA equivalent). Gaps re-emitted as N runs.
    Without ``masks`` output is all lower-case; with them it is upper-case
    except masked intervals (GDBtoFA.c:209-212 UPPER selection).
    ``out_path`` None streams to stdout; a .gz suffix gzip-compresses."""
    import contextlib
    import gzip
    import sys

    if out_path is None:
        # fall back to the text stream when stdout is redirected to an
        # in-memory buffer (tests)
        class _B:
            def write(self, b):
                sys.stdout.write(b.decode())

            def close(self):
                pass

        ctx = contextlib.nullcontext(getattr(sys.stdout, "buffer", _B()))
    elif str(out_path).endswith(".gz"):
        ctx = gzip.open(out_path, "wb")
    else:
        ctx = open(out_path, "wb")
    upper = masks is not None
    gapch = ord("N") if upper else ord("n")
    table = dna.CODE_TO_UPPER if upper else dna.CODE_TO_LOWER
    mask_by_ctg = {}
    if masks:
        for m in masks:
            mask_by_ctg.setdefault(m.contig, []).append((m.beg, m.end))
    with ctx as f:
        for s in gdb.scaffolds:
            f.write(b">" + s.header.encode() + b"\n")
            parts = []
            spos = 0
            for ci in range(s.fctg, s.ectg):
                c = gdb.contigs[ci]
                if c.sbeg > spos:
                    parts.append(np.full(c.sbeg - spos, gapch, dtype=np.uint8))
                codes = gdb.get_contig(ci)
                ascii_seq = table[codes].copy()
                for b, e in mask_by_ctg.get(ci, []):
                    ascii_seq[b:e] += 32  # lower-case
                parts.append(ascii_seq)
                spos = c.sbeg + c.clen
            if s.slen > spos:
                parts.append(np.full(s.slen - spos, gapch, dtype=np.uint8))
            seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width].tobytes())
                f.write(b"\n")
