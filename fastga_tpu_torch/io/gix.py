# Copied from fastga_tpu/io/gix.py; imports point at fastga_tpu_torch.
"""GIX — syncmer-sampled k-mer genome index: build, read, write.

In-memory ``GixTable`` holds the fully sorted entry arrays (the device merge
consumes these directly); on-disk layout matches the reference "new" (v1.3+)
GIX format exactly (GIXmake.c k_sort:1445-1580):

`.gix` stub (native-endian):
    int kmer, int nparts, int minval=1, int ibyte=3,
    int64[2^24] cumulative prefix counts,
    int post_bytes, int cont_bytes, int nparts, int64 maxpre,
    int freq=0, int ncontig, int perm[ncontig], int64 -1 sentinel

`.X.ktab.<p>` part files (p = 1..nparts):
    int kmer, int64 nents, then nents entries of
    [suffix 7B (bases 12..39, big-endian/byte)] [mask 1B] [lcp 1B]
    [post little-endian post_bytes] [cont little-endian cont_bytes,
     top bit of last byte = reverse-complement flag]

Entry semantics: one entry per (syncmer position, orientation); `post` is the
contig-relative start of a forward 40-mer, or the exclusive *end* of a
reverse-complement 40-mer (= syncmer pos + 12, setup_thread_plain
GIXmake.c:925-941); `cont` is the rank of the contig in descending-length
order (Perm maps rank -> original contig id, GIXmake.c:1950-1963); `lcp` is
the base-length of the longest common prefix with the predecessor entry's
k-mer (first of a duplicate group), or 40 for subsequent duplicates
(compress_thread GIXmake.c:1211-1260).

Parity note: within duplicate-k-mer groups the reference's order is its
(unstable) thread-radix-sort order; we use deterministic (cont, post, comp)
order instead.  The reference's Ksplit part boundaries are histogram-trained;
we balance actual bucket counts.  Both only affect part-file byte layout, not
index semantics.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from ..ops import syncmer
from ..ops.constants import COMP, KMER, LCPB
from ..utils import prof
from .gdb import GDB

PREFIX_BITS = 24
NPREFIX = 1 << PREFIX_BITS
KBYTES = KMER // 4  # 10


@dataclass
class GixTable:
    kmer: int
    # sorted entry arrays (all length n):
    kbytes: np.ndarray        # uint8[n, KBYTES] big-endian k-mer bytes
    post: np.ndarray          # int32[n] contig-relative position
    cont: np.ndarray          # int32[n] length-rank of contig
    comp: np.ndarray          # bool[n] reverse-complement flag
    lcp: np.ndarray           # uint8[n]
    maskb: np.ndarray         # uint8[n] masked-prefix length
    prefix_index: np.ndarray  # int64[2^24+1] panel offsets (cumulative)
    perm: np.ndarray          # int32[ncontig] rank -> original contig
    post_bytes: int
    cont_bytes: int
    freq: int = 0
    seqtot: int = 0   # effective total bp (incl. short-GDB fake contigs)

    @property
    def n(self) -> int:
        return len(self.post)

    def kmer_codes(self, i: int) -> np.ndarray:
        """Entry i's k-mer as base codes (big-endian within byte)."""
        kb = self.kbytes[i]
        out = np.empty(self.kmer, np.uint8)
        out[0::4] = (kb >> 6) & 3
        out[1::4] = (kb >> 4) & 3
        out[2::4] = (kb >> 2) & 3
        out[3::4] = kb & 3
        return out

    def searchsorted(self, codes: np.ndarray) -> int:
        """Index of the first entry >= the given full-k-mer base codes."""
        import bisect
        q = codes.reshape(-1, 4)
        probe = bytes((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2)
                      | q[:, 3])
        rows = self.kbytes

        class _V:
            def __getitem__(self, k):
                return rows[k].tobytes()

            def __len__(self):
                return len(rows)

        return bisect.bisect_left(_V(), probe)

    def khi_klo(self) -> Tuple[np.ndarray, np.ndarray]:
        """k-mer packed as (uint64 bases 0..31, uint16 bases 32..39)."""
        kb = self.kbytes
        khi = kb[:, :8].copy().view(">u8").reshape(-1).astype(np.uint64)
        klo = kb[:, 8:10].copy().view(">u2").reshape(-1).astype(np.uint16)
        return khi, klo


def _length_perm(contig_lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Descending-length stable permutation + inverse (LSORT GIXmake.c:1628)."""
    perm = np.argsort(-contig_lens, kind="stable").astype(np.int32)
    invp = np.empty_like(perm)
    invp[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, invp


def contig_order(lens: np.ndarray, nthreads: int = 8, kmer: int = KMER):
    """A GIX table's contig order: short_GDB_fix (GIXmake.c:1605-1624: a
    GDB with fewer contigs than threads gets fake ``kmer``-length contigs
    that emit no entries but appear in the persisted perm/ncontig), then
    the descending-length stable permutation.  Returns (padded lengths,
    perm, inverse perm)."""
    nfake = max(0, nthreads - len(lens))
    lens_eff = np.concatenate([lens, np.full(nfake, kmer, dtype=np.int64)])
    return (lens_eff,) + _length_perm(lens_eff)


def _bytes_for(maxval: int) -> int:
    b, cum = 0, 1
    while cum < maxval:
        cum *= 256
        b += 1
    return max(b, 1)


def build_gix(gdb: GDB, kmer: int = KMER, masks=None,
              nthreads: int = 8) -> GixTable:
    """GDB -> sorted GIX table (GIXmake equivalent).

    ``masks``: optional list of io.gdb.MaskIval for masked-prefix bytes;
    a masked table counts under ``gix.host_tables`` (its partner
    ``gix.card_tables`` counts the masked tables built on the card by
    ops.device_pipeline.build_gix_device).
    ``nthreads``: reference -T; only affects the short-GDB fake-contig
    padding (``contig_order``) and the NPARTS choice at write time.
    """
    assert kmer % 4 == 0
    with prof.span("gix.build"):
        kb = kmer // 4
        lens = gdb.contig_lengths()
        lens_eff, perm, invp = contig_order(lens, nthreads, kmer)

        mask_by_ctg = {}
        if masks:
            for m in masks:
                mask_by_ctg.setdefault(m.contig, []).append((m.beg, m.end))

        with prof.span("gix.entries"):
            kbytes, post, cont, comp, maskb = _entries(gdb, lens, invp,
                                                       mask_by_ctg, kmer)
        with prof.span("gix.sort"):
            kbytes, post, cont, comp, maskb = _sort_entries(
                kbytes, post, cont, comp, maskb)
        with prof.span("gix.lcp"):
            lcp = _compute_lcp(kbytes, kmer)
            prefix_index = _prefix_index(kbytes)
        prof.count("gix.entries", len(post))
        if masks:
            prof.count("gix.host_tables")

        return GixTable(
            kmer=kmer, kbytes=kbytes, post=post, cont=cont, comp=comp,
            lcp=lcp, maskb=maskb, prefix_index=prefix_index, perm=perm,
            post_bytes=_bytes_for(int(lens_eff.max()) if len(lens_eff)
                                  else 1),
            cont_bytes=_bytes_for(2 * len(lens_eff)),
            seqtot=gdb.seqtot + (len(lens_eff) - len(lens)) * kmer,
        )


def _entries(gdb, lens, invp, mask_by_ctg, kmer):
    """Every contig's syncmer entries, unsorted: (k-mer bytes, post, contig
    rank, comp, masked-prefix byte)."""
    kb = kmer // 4
    all_bytes: List[np.ndarray] = []
    all_post: List[np.ndarray] = []
    all_cont: List[np.ndarray] = []
    all_comp: List[np.ndarray] = []
    all_maskb: List[np.ndarray] = []

    for r in range(gdb.ncontig):
        clen = int(lens[r])
        if clen < kmer:
            continue
        bases = gdb.get_contig(r)
        fwd, rc = syncmer.index_entries(bases, kmer)
        nb = syncmer.pack4(bases)  # big-endian byte at each position
        # forward k-mer bytes: nb[j + 4t], t=0..kb-1
        if len(fwd):
            idx = fwd[:, None] + 4 * np.arange(kb)[None, :]
            all_bytes.append(nb[idx])
            all_post.append(fwd.astype(np.int32))
            all_cont.append(np.full(len(fwd), invp[r], dtype=np.int32))
            all_comp.append(np.zeros(len(fwd), dtype=bool))
        # rc k-mer bytes: COMP[nb[post - 4 - 4t]], t=0..kb-1
        if len(rc):
            idx = rc[:, None] - 4 - 4 * np.arange(kb)[None, :]
            all_bytes.append(COMP[nb[idx]])
            all_post.append(rc.astype(np.int32))
            all_cont.append(np.full(len(rc), invp[r], dtype=np.int32))
            all_comp.append(np.ones(len(rc), dtype=bool))
        nf, nr = len(fwd), len(rc)
        if mask_by_ctg.get(r):
            with prof.span("gix.maskb"):
                cov = np.zeros(clen + 1, dtype=np.int8)
                for b, e in mask_by_ctg[r]:
                    cov[b:e] = 1
                mb_f = _masked_prefix(cov, fwd, kmer, False)
                mb_r = _masked_prefix(cov, rc, kmer, True)
        else:
            mb_f = np.zeros(nf, dtype=np.uint8)
            mb_r = np.zeros(nr, dtype=np.uint8)
        if nf:
            all_maskb.append(mb_f)
        if nr:
            all_maskb.append(mb_r)

    if not all_bytes:
        return (np.zeros((0, kb), dtype=np.uint8), np.zeros(0, np.int32),
                np.zeros(0, np.int32), np.zeros(0, bool),
                np.zeros(0, np.uint8))
    return (np.concatenate(all_bytes), np.concatenate(all_post),
            np.concatenate(all_cont), np.concatenate(all_comp),
            np.concatenate(all_maskb))


def _sort_entries(kbytes, post, cont, comp, maskb):
    """The entries in the table's order, (kmer, cont, post, comp): two
    stable argsorts -- the tie key (cont, post, comp) packs into int64,
    then khi+klo as a second stable pass -- instead of a 5-key lexsort."""
    kb = kbytes.shape[1]
    khi = kbytes[:, :8].copy().view(">u8").reshape(-1)
    klo = (kbytes[:, 8:kb].copy().view(f">u{max(kb-8,1)}").reshape(-1)
           if kb > 8 else np.zeros(len(post), dtype=np.uint8))
    nent = len(post)
    pmax = int(post.max()) + 1 if nent else 1
    cmax = int(cont.max()) + 1 if nent else 1
    if nent and cmax * pmax * 2 < (1 << 62) and kb <= 12:
        tie = ((cont.astype(np.int64) * pmax + post) << 1) | comp
        o1 = np.argsort(tie, kind="stable")
        # second pass: stable by (khi, klo) — pack klo (<= 4 bytes) into
        # the low bits when khi < 2^48 is not guaranteed, so sort klo
        # then khi (both stable)
        o2 = o1[np.argsort(klo[o1].astype(np.uint64), kind="stable")]
        order = o2[np.argsort(khi[o2], kind="stable")]
    else:
        order = np.lexsort((comp, post, cont, klo, khi))
    return (kbytes[order], post[order], cont[order], comp[order],
            maskb[order])

def _masked_prefix(cov: np.ndarray, posts: np.ndarray, kmer: int,
                   is_rc: bool) -> np.ndarray:
    """Masked-prefix length byte: # of leading k-mer bases soft-masked.

    For a forward entry at post j the k-mer occupies [j, j+kmer); its leading
    bases in sequence order.  For an RC entry with post p the k-mer occupies
    [p-kmer, p) and its leading bases run backward from p-1.
    """
    if len(posts) == 0:
        return np.zeros(0, dtype=np.uint8)
    # prefix run length of 1s from a starting point, capped at kmer
    out = np.zeros(len(posts), dtype=np.uint8)
    run = _runlen_of_ones(cov)
    if is_rc:
        runr = _runlen_of_ones(cov[::-1])
        n = len(cov)
        out = np.minimum(runr[n - posts], kmer).astype(np.uint8)
    else:
        out = np.minimum(run[posts], kmer).astype(np.uint8)
    return out


def _runlen_of_ones(cov: np.ndarray) -> np.ndarray:
    """r[i] = length of the run of 1s starting at i (0 if cov[i]==0)."""
    n = len(cov)
    r = np.zeros(n + 1, dtype=np.int64)
    # compute via reverse scan in vector form: group ids by change points
    c = cov.astype(np.int64)
    rev = c[::-1]
    cs = np.cumsum(rev)
    reset = np.where(rev == 0, cs, 0)
    run_rev = cs - np.maximum.accumulate(reset)
    r[:n] = run_rev[::-1]
    return r


def _compute_lcp(kbytes: np.ndarray, kmer: int) -> np.ndarray:
    n = len(kbytes)
    lcp = np.zeros(n, dtype=np.uint8)
    if n <= 1:
        return lcp
    a, b = kbytes[:-1], kbytes[1:]
    neq = a != b
    anydiff = neq.any(axis=1)
    first = np.argmax(neq, axis=1)
    xorb = a[np.arange(n - 1), first] ^ b[np.arange(n - 1), first]
    inbyte = LCPB[xorb]
    val = np.where(anydiff, 4 * first + inbyte, kmer)
    # duplicates get 40 (the "full match" marker, compress_thread)
    lcp[1:] = val.astype(np.uint8)
    lcp[0] = 0
    return lcp


def _prefix_index(kbytes: np.ndarray) -> np.ndarray:
    n = len(kbytes)
    pre = np.zeros(NPREFIX + 1, dtype=np.int64)
    if n:
        p24 = ((kbytes[:, 0].astype(np.int64) << 16)
               | (kbytes[:, 1].astype(np.int64) << 8)
               | kbytes[:, 2].astype(np.int64))
        counts = np.bincount(p24, minlength=NPREFIX)
        pre[1:] = np.cumsum(counts)
    return pre


# -- on-disk ------------------------------------------------------------------


def gix_paths(path) -> Tuple[Path, Path]:
    """(stub path, part-file prefix) for a GIX root or .gix path."""
    p = Path(path)
    name = p.name
    if name.endswith(".gix"):
        name = name[:-4]
    return p.parent / (name + ".gix"), p.parent / ("." + name + ".ktab.")


def write_gix(t: GixTable, path, nthreads: int = 8):
    """Write `.gix` stub + `.ktab.<p>` parts (reference new-format layout)."""
    stub, part_prefix = gix_paths(path)
    ncontig = len(t.perm)
    kb = t.kmer // 4

    # NPARTS via the reference's 4GB-sort sizing (GIXmake.c:1907-1920)
    nels = 0x100000000 // (t.cont_bytes + t.post_bytes + kb + 2)
    tot = t.seqtot if t.seqtot else t.n
    nbit = int((0.81 * (tot - (t.kmer - 1) * ncontig)) / nels) if nels else 0
    nparts = ((max(nbit, 1) - 1) // nthreads + 1) * nthreads
    nparts = min(max(nparts, 8), 64)

    # split entries into nparts at 10-bit bucket boundaries, balanced
    if t.n:
        b10 = ((t.kbytes[:, 0].astype(np.int64) << 2)
               | (t.kbytes[:, 1].astype(np.int64) >> 6))
        bcounts = np.bincount(b10, minlength=1024)
    else:
        bcounts = np.zeros(1024, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(bcounts)])
    targets = (np.arange(1, nparts) * t.n) // nparts
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cum[cuts], [t.n]]).astype(np.int64)

    ebytes = _entry_bytes(t)
    esz = ebytes.shape[1]
    for p in range(nparts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        with open(f"{part_prefix}{p+1}", "wb") as f:
            f.write(struct.pack("<i", t.kmer))
            f.write(struct.pack("<q", hi - lo))
            ebytes[lo:hi].tofile(f)

    counts = np.diff(t.prefix_index)
    maxpre = int(counts.max()) if t.n else 0
    with open(stub, "wb") as f:
        f.write(struct.pack("<iiii", t.kmer, nparts, 1, 3))
        np.cumsum(counts).astype("<i8").tofile(f)
        f.write(struct.pack("<iii", t.post_bytes, t.cont_bytes, nparts))
        f.write(struct.pack("<q", maxpre))
        f.write(struct.pack("<ii", t.freq, ncontig))
        t.perm.astype("<i4").tofile(f)
        f.write(struct.pack("<q", -1))
    return stub


def _entry_bytes(t: GixTable) -> np.ndarray:
    """Serialize entries: [suffix kb-3][mask][lcp][post le][cont le+flag]."""
    kb = t.kmer // 4
    n = t.n
    esz = (kb - 3) + 2 + t.post_bytes + t.cont_bytes
    out = np.zeros((n, esz), dtype=np.uint8)
    out[:, : kb - 3] = t.kbytes[:, 3:kb]
    out[:, kb - 3] = t.maskb
    out[:, kb - 2] = t.lcp
    o = kb - 1
    pv = t.post.astype(np.uint64)
    for i in range(t.post_bytes):
        out[:, o + i] = (pv >> (8 * i)).astype(np.uint8)
    o += t.post_bytes
    cv = (t.cont.astype(np.uint64)
          | (t.comp.astype(np.uint64) << (8 * t.cont_bytes - 1)))
    for i in range(t.cont_bytes):
        out[:, o + i] = (cv >> (8 * i)).astype(np.uint8)
    return out


def _read_stub(stub):
    """Parse a .gix stub; returns a dict of header fields (layout
    written by GIXmake.c:1542-1580, read by FastGA.c:273-344)."""
    with open(stub, "rb") as f:
        kmer, nparts, minval, ibyte = struct.unpack("<iiii", f.read(16))
        assert ibyte == 3 and minval == 1, "unrecognized GIX stub"
        cumpre = np.fromfile(f, dtype="<i8", count=NPREFIX)
        post_bytes, cont_bytes, nparts2 = struct.unpack("<iii", f.read(12))
        (maxpre,) = struct.unpack("<q", f.read(8))
        freq, ncontig = struct.unpack("<ii", f.read(8))
        perm = np.fromfile(f, dtype="<i4", count=ncontig)
        (sentinel,) = struct.unpack("<q", f.read(8))
    prefix_index = np.zeros(NPREFIX + 1, dtype=np.int64)
    prefix_index[1:] = cumpre
    return dict(kmer=kmer, nparts=nparts, cumpre=cumpre,
                prefix_index=prefix_index, post_bytes=post_bytes,
                cont_bytes=cont_bytes, freq=freq, ncontig=ncontig,
                perm=perm, new_format=(sentinel == -1))


def _decode_entry_rows(e, kb, post_bytes, cont_bytes):
    """Decode raw ktab entry rows [suffix kb-3][mask][lcp][post le]
    [cont le+flag] into column arrays (suffix, maskb, lcp, post, cont,
    comp)."""
    n = len(e)
    maskb = e[:, kb - 3].copy()
    lcp = e[:, kb - 2].copy()
    o = kb - 1
    post = np.zeros(n, dtype=np.int64)
    for i in range(post_bytes):
        post |= e[:, o + i].astype(np.int64) << (8 * i)
    o += post_bytes
    cv = np.zeros(n, dtype=np.int64)
    for i in range(cont_bytes):
        cv |= e[:, o + i].astype(np.int64) << (8 * i)
    flag = 1 << (8 * cont_bytes - 1)
    comp = (cv & flag) != 0
    cont = (cv & (flag - 1)).astype(np.int32)
    return e[:, : kb - 3], maskb, lcp, post, cont, comp


def read_gix(path) -> GixTable:
    stub, part_prefix = gix_paths(path)
    h = _read_stub(stub)
    kmer, nparts = h["kmer"], h["nparts"]
    post_bytes, cont_bytes = h["post_bytes"], h["cont_bytes"]
    if not h["new_format"]:
        # pre-v1.3 "old" GIX: counts in the ktab, posts in separate
        # .post part files (FastGA.c:273-344 Open_Post_List;
        # old_merge_thread 1027-1546; GIXshow.c Print_Index_Old)
        return _read_gix_old(stub, part_prefix, kmer, nparts, h["cumpre"],
                             post_bytes, cont_bytes, h["freq"],
                             h["ncontig"], h["perm"])

    kb = kmer // 4
    esz = (kb - 3) + 2 + post_bytes + cont_bytes
    chunks = []
    for p in range(nparts):
        with open(f"{part_prefix}{p+1}", "rb") as f:
            (k2,) = struct.unpack("<i", f.read(4))
            (nents,) = struct.unpack("<q", f.read(8))
            chunks.append(np.fromfile(f, dtype=np.uint8
                                      ).reshape(nents, esz))
    e = np.concatenate(chunks) if chunks else np.zeros((0, esz), np.uint8)
    n = len(e)

    prefix_index = h["prefix_index"]
    # reconstruct full k-mer bytes: prefix from panel id + suffix from entry
    kbytes = np.zeros((n, kb), dtype=np.uint8)
    suf, maskb, lcp, post, cont, comp = _decode_entry_rows(
        e, kb, post_bytes, cont_bytes)
    if n:
        p24 = np.repeat(np.arange(NPREFIX, dtype=np.int64),
                        np.diff(prefix_index))
        kbytes[:, 0] = (p24 >> 16).astype(np.uint8)
        kbytes[:, 1] = (p24 >> 8).astype(np.uint8)
        kbytes[:, 2] = p24.astype(np.uint8)
        kbytes[:, 3:] = suf

    return GixTable(kmer=kmer, kbytes=kbytes, post=post.astype(np.int32),
                    cont=cont, comp=comp, lcp=lcp, maskb=maskb,
                    prefix_index=prefix_index, perm=h["perm"],
                    post_bytes=post_bytes, cont_bytes=cont_bytes,
                    freq=h["freq"])


class KmerStream:
    """Streaming cursor over an on-disk new-format GIX with bounded
    memory: the out-of-core analog of libfastk's Kmer_Stream
    (Open_Kmer_Stream libfastk.c:785-907, First/Next_Kmer_Entry,
    GoTo_Kmer_Index libfastk.c:1272, Clone_Kmer_Stream libfastk.c:909).
    Only the 2^24-entry prefix table plus one ``bufents``-entry read
    buffer are resident (the reference likewise keeps the full prefix
    table and a part-file read buffer).

    Iteration:   s.first() / while not s.eof: ... s.next()
    Random:      s.goto_index(i); s.goto_kmer(codes) -> first idx >= codes
    Batched:     s.entries(beg, end) yields decoded column-array chunks.
    Current entry accessors: idx, kmer_codes(), post, cont, comp, lcp,
    maskb (values mirror GixTable columns).
    """

    def __init__(self, path, bufents: int = 1 << 16):
        self._path = path
        stub, part_prefix = gix_paths(path)
        h = _read_stub(stub)
        if not h["new_format"]:
            raise ValueError(
                "KmerStream requires a new-format (v1.3+) GIX; use "
                "read_gix() for old-format indices")
        self.kmer = h["kmer"]
        self.post_bytes = h["post_bytes"]
        self.cont_bytes = h["cont_bytes"]
        self.freq = h["freq"]
        self.perm = h["perm"]
        self.prefix_index = h["prefix_index"]
        self.nels = int(self.prefix_index[-1])
        self._kb = self.kmer // 4
        self._esz = (self._kb - 3) + 2 + self.post_bytes + self.cont_bytes
        self._bufents = max(int(bufents), 1)
        # part boundaries in global entry index space
        self._parts = []
        self._pstart = [0]
        for p in range(h["nparts"]):
            fn = f"{part_prefix}{p+1}"
            with open(fn, "rb") as f:
                f.seek(4)
                (nents,) = struct.unpack("<q", f.read(8))
            self._parts.append(fn)
            self._pstart.append(self._pstart[-1] + int(nents))
        if self._pstart[-1] != self.nels:
            raise ValueError("GIX part sizes disagree with stub prefix "
                             "table")
        self._pstart = np.asarray(self._pstart, np.int64)
        self._f = None
        self._fpart = -1
        self._buf = np.zeros((0, self._esz), np.uint8)
        self._buf0 = 0          # global index of buffer row 0
        self.idx = -1           # current entry (before first())
        self._cpre = 0

    # -- position --------------------------------------------------------

    @property
    def eof(self) -> bool:
        return self.idx >= self.nels

    def first(self):
        self.goto_index(0)
        return self

    def next(self) -> bool:
        """Advance; returns False once past the last entry."""
        self.idx += 1
        if self.idx >= self.nels:
            return False
        pi = self.prefix_index
        while pi[self._cpre + 1] <= self.idx:
            self._cpre += 1
        return True

    def goto_index(self, i: int):
        """Position on global entry index i (0 <= i <= nels)."""
        if not 0 <= i <= self.nels:
            raise IndexError(f"entry index {i} out of range")
        self.idx = int(i)
        if self.idx < self.nels:
            self._cpre = int(np.searchsorted(self.prefix_index, self.idx,
                                             side="right") - 1)
        return self

    def goto_kmer(self, codes: np.ndarray) -> int:
        """Position on the first entry whose k-mer >= the given base
        codes (padded with 'a' to k); returns that index (== nels when
        past the end).  In-panel binary search through the read buffer
        (GoTo_Kmer_String libfastk.c:1297+)."""
        q = np.zeros(self.kmer, np.uint8)
        q[:len(codes)] = codes[:self.kmer]
        p24 = int(q[0]) << 22 | int(q[1]) << 20 | int(q[2]) << 18 \
            | int(q[3]) << 16 | int(q[4]) << 14 | int(q[5]) << 12 \
            | int(q[6]) << 10 | int(q[7]) << 8 | int(q[8]) << 6 \
            | int(q[9]) << 4 | int(q[10]) << 2 | int(q[11])
        lo = int(self.prefix_index[p24])
        hi = int(self.prefix_index[p24 + 1])
        qr = q[12:].reshape(-1, 4)
        probe = bytes((qr[:, 0] << 6) | (qr[:, 1] << 4) | (qr[:, 2] << 2)
                      | qr[:, 3])
        while lo < hi:
            mid = (lo + hi) // 2
            if self._row(mid)[: self._kb - 3].tobytes() < probe:
                lo = mid + 1
            else:
                hi = mid
        return self.goto_index(lo).idx

    def clone(self) -> "KmerStream":
        """Independent cursor at the same position (Clone_Kmer_Stream
        libfastk.c:909: threads share the index, not the file unit)."""
        c = KmerStream(self._path, self._bufents)
        if 0 <= self.idx < self.nels:
            c.goto_index(self.idx)
        else:
            c.idx = self.idx
        return c

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
            self._fpart = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- raw row access --------------------------------------------------

    def _row(self, i: int) -> np.ndarray:
        if not (self._buf0 <= i < self._buf0 + len(self._buf)):
            self._fill(i)
        return self._buf[i - self._buf0]

    def _fill(self, i: int):
        p = int(np.searchsorted(self._pstart, i, side="right") - 1)
        if p != self._fpart:
            self.close()
            self._f = open(self._parts[p], "rb")
            self._fpart = p
        off = i - int(self._pstart[p])
        want = min(self._bufents, int(self._pstart[p + 1]) - i)
        self._f.seek(12 + off * self._esz)
        raw = np.fromfile(self._f, np.uint8, want * self._esz)
        self._buf = raw.reshape(-1, self._esz)
        self._buf0 = i

    # -- current-entry accessors ----------------------------------------

    def _cur(self) -> np.ndarray:
        if not 0 <= self.idx < self.nels:
            raise IndexError("cursor not on an entry (call first())")
        return self._row(self.idx)

    def kmer_codes(self) -> np.ndarray:
        """Current k-mer as base codes 0..3."""
        out = np.empty(self.kmer, np.uint8)
        p = self._cpre
        for j in range(12):
            out[j] = (p >> (22 - 2 * j)) & 3
        sfx = self._cur()[: self._kb - 3]
        out[12 + 0::4] = (sfx >> 6) & 3
        out[12 + 1::4] = (sfx >> 4) & 3
        out[12 + 2::4] = (sfx >> 2) & 3
        out[12 + 3::4] = sfx & 3
        return out

    def _decode1(self):
        e = self._cur().reshape(1, -1)
        return _decode_entry_rows(e, self._kb, self.post_bytes,
                                  self.cont_bytes)

    @property
    def maskb(self) -> int:
        return int(self._cur()[self._kb - 3])

    @property
    def lcp(self) -> int:
        return int(self._cur()[self._kb - 2])

    @property
    def post(self) -> int:
        return int(self._decode1()[3][0])

    @property
    def cont(self) -> int:
        return int(self._decode1()[4][0])

    @property
    def comp(self) -> bool:
        return bool(self._decode1()[5][0])

    # -- batched decode --------------------------------------------------

    def entries(self, beg: int = 0, end: Optional[int] = None,
                chunk: Optional[int] = None):
        """Yield (idx0, suffix, maskb, lcp, post, cont, comp) decoded
        column-array chunks for entries [beg, end) without loading the
        table; chunks never span part files."""
        end = self.nels if end is None else min(end, self.nels)
        chunk = chunk or self._bufents
        i = beg
        while i < end:
            p = int(np.searchsorted(self._pstart, i, side="right") - 1)
            stop = min(end, int(self._pstart[p + 1]), i + chunk)
            with open(self._parts[p], "rb") as f:
                f.seek(12 + (i - int(self._pstart[p])) * self._esz)
                raw = np.fromfile(f, np.uint8, (stop - i) * self._esz)
            rows = raw.reshape(-1, self._esz)
            yield (i,) + _decode_entry_rows(rows, self._kb,
                                            self.post_bytes,
                                            self.cont_bytes)
            i = stop


def _read_gix_old(stub, part_prefix, kmer, nparts, cumpre, post_bytes,
                  cont_bytes, freq, ncontig, perm) -> GixTable:
    """Old (<= v1.2) GIX: `.ktab.<p>` entries are [suffix kb-3 bytes]
    [count byte][lcp byte]; positions live in `.X.post.<p>` files as
    (post_bytes + cont_bytes)-byte records in ktab order."""
    kb = kmer // 4
    esz = (kb - 3) + 2
    chunks = []
    for p in range(nparts):
        with open(f"{part_prefix}{p+1}", "rb") as f:
            struct.unpack("<i", f.read(4))
            (nents,) = struct.unpack("<q", f.read(8))
            chunks.append(np.fromfile(f, dtype=np.uint8,
                                      count=nents * esz).reshape(nents,
                                                                 esz))
    e = np.concatenate(chunks) if chunks else np.zeros((0, esz), np.uint8)
    nk = len(e)
    counts = e[:, kb - 3].astype(np.int64)
    lcp_k = e[:, kb - 2].copy()

    # .post parts: header {pbyte int, cbyte int, n int64}
    root = stub.name[:-4]
    post_prefix = stub.parent / ("." + root + ".post.")
    pchunks = []
    psz = post_bytes + cont_bytes
    p = 1
    while True:
        f = Path(f"{post_prefix}{p}")
        if not f.exists():
            break
        with open(f, "rb") as fh:
            pb, cb = struct.unpack("<ii", fh.read(8))
            (n,) = struct.unpack("<q", fh.read(8))
            assert pb + cb == psz
            pchunks.append(np.fromfile(fh, dtype=np.uint8,
                                       count=n * psz).reshape(n, psz))
        p += 1
    pe = (np.concatenate(pchunks) if pchunks
          else np.zeros((0, psz), np.uint8))
    n = len(pe)
    assert n == int(counts.sum()), (n, int(counts.sum()))

    # expand: kmer row i covers posts [cum[i], cum[i]+counts[i])
    kidx = np.repeat(np.arange(nk), counts)
    prefix_index = np.zeros(NPREFIX + 1, dtype=np.int64)
    prefix_index[1:] = cumpre          # distinct-kmer counts per prefix
    p24k = np.repeat(np.arange(NPREFIX, dtype=np.int64),
                     np.diff(prefix_index))
    kbytes = np.zeros((n, kb), dtype=np.uint8)
    if n:
        p24 = p24k[kidx]
        kbytes[:, 0] = (p24 >> 16).astype(np.uint8)
        kbytes[:, 1] = (p24 >> 8).astype(np.uint8)
        kbytes[:, 2] = p24.astype(np.uint8)
        kbytes[:, 3:] = e[kidx, : kb - 3]
    post = np.zeros(n, dtype=np.int64)
    for i in range(post_bytes):
        post |= pe[:, i].astype(np.int64) << (8 * i)
    cv = np.zeros(n, dtype=np.int64)
    for i in range(cont_bytes):
        cv |= pe[:, post_bytes + i].astype(np.int64) << (8 * i)
    flag = 1 << (8 * cont_bytes - 1)
    comp = (cv & flag) != 0
    cont = (cv & (flag - 1)).astype(np.int32)

    # per-entry lcp with the new-format dup convention (first of a
    # duplicate group = lcp byte, the rest the 40 marker)
    lcp = np.full(n, kmer, dtype=np.uint8)
    if n:
        first = np.zeros(n, dtype=bool)
        cum = np.concatenate([[0], np.cumsum(counts)])[:-1]
        first[cum[counts > 0]] = True
        lcp[first] = lcp_k[counts > 0]

    # posts within a duplicate group arrive in the old sort's order;
    # normalize to our deterministic (cont, post, comp) order
    if n:
        pmax = int(post.max()) + 1
        tie = ((cont.astype(np.int64) * pmax + post) << 1) | comp
        o2 = np.lexsort((tie, kidx))
        post = post[o2]
        cont = cont[o2]
        comp = comp[o2]

    prefix_full = np.zeros(NPREFIX + 1, dtype=np.int64)
    if n:
        p24e = ((kbytes[:, 0].astype(np.int64) << 16)
                | (kbytes[:, 1].astype(np.int64) << 8)
                | kbytes[:, 2].astype(np.int64))
        prefix_full[1:] = np.cumsum(np.bincount(p24e, minlength=NPREFIX))

    return GixTable(kmer=kmer, kbytes=kbytes, post=post.astype(np.int32),
                    cont=cont, comp=np.asarray(comp),
                    lcp=lcp, maskb=np.zeros(n, np.uint8),
                    prefix_index=prefix_full, perm=perm,
                    post_bytes=post_bytes, cont_bytes=cont_bytes,
                    freq=freq)


def write_gix_old(t: GixTable, path, nthreads: int = 8):
    """Write a pre-v1.3 ("old") GIX: count-grouped ktab entries + .post
    part files + the 2^16 post index in the stub.  Test/compat surface —
    duplicate groups larger than 255 posts cannot be represented."""
    stub, part_prefix = gix_paths(path)
    ncontig = len(t.perm)
    kb = t.kmer // 4
    n = t.n

    # group rows by distinct kmer (lcp==40 marker rows join the group)
    first = np.ones(n, dtype=bool)
    if n > 1:
        first[1:] = (t.kbytes[1:] != t.kbytes[:-1]).any(axis=1)
    gidx = np.flatnonzero(first)
    counts = np.diff(np.concatenate([gidx, [n]]))
    if (counts > 255).any():
        raise ValueError("old-format GIX cannot hold >255 posts per kmer")
    nk = len(gidx)
    lcp_k = t.lcp[gidx]

    nparts = min(max(nthreads, 1), 64)
    # split distinct kmers into parts at 10-bit boundaries, balanced
    if nk:
        b10 = ((t.kbytes[gidx, 0].astype(np.int64) << 2)
               | (t.kbytes[gidx, 1].astype(np.int64) >> 6))
        bcounts = np.bincount(b10, minlength=1024)
    else:
        bcounts = np.zeros(1024, dtype=np.int64)
    cum = np.concatenate([[0], np.cumsum(bcounts)])
    targets = (np.arange(1, nparts) * nk) // nparts
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cum[cuts], [nk]]).astype(np.int64)

    ents = np.zeros((nk, (kb - 3) + 2), dtype=np.uint8)
    ents[:, : kb - 3] = t.kbytes[gidx, 3:kb]
    ents[:, kb - 3] = counts.astype(np.uint8)
    ents[:, kb - 2] = lcp_k
    for p in range(nparts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        with open(f"{part_prefix}{p+1}", "wb") as f:
            f.write(struct.pack("<i", t.kmer))
            f.write(struct.pack("<q", hi - lo))
            ents[lo:hi].tofile(f)

    # posts in ktab order
    psz = t.post_bytes + t.cont_bytes
    pres = np.zeros((n, psz), dtype=np.uint8)
    pv = t.post.astype(np.uint64)
    for i in range(t.post_bytes):
        pres[:, i] = (pv >> (8 * i)).astype(np.uint8)
    cvv = (t.cont.astype(np.uint64)
           | (t.comp.astype(np.uint64) << (8 * t.cont_bytes - 1)))
    for i in range(t.cont_bytes):
        pres[:, t.post_bytes + i] = (cvv >> (8 * i)).astype(np.uint8)
    pcum = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    root = stub.name[:-4]
    post_prefix = stub.parent / ("." + root + ".post.")
    for p in range(nparts):
        lo, hi = int(pcum[bounds[p]]), int(pcum[bounds[p + 1]])
        with open(f"{post_prefix}{p+1}", "wb") as f:
            f.write(struct.pack("<ii", t.post_bytes, t.cont_bytes))
            f.write(struct.pack("<q", hi - lo))
            pres[lo:hi].tofile(f)

    # stub: distinct-kmer prefix counts + the 2^16 post index
    kcounts = np.zeros(NPREFIX, dtype=np.int64)
    if nk:
        p24 = ((t.kbytes[gidx, 0].astype(np.int64) << 16)
               | (t.kbytes[gidx, 1].astype(np.int64) << 8)
               | t.kbytes[gidx, 2].astype(np.int64))
        kcounts = np.bincount(p24, minlength=NPREFIX)
    idx16 = np.zeros(1 << 16, dtype=np.int64)
    if n:
        pre16 = ((t.kbytes[:, 0].astype(np.int64) << 8)
                 | t.kbytes[:, 1].astype(np.int64))
        c16 = np.bincount(pre16, minlength=1 << 16)
        idx16[1:] = np.cumsum(c16)[:-1]
    maxpre = int(kcounts.max()) if nk else 0
    with open(stub, "wb") as f:
        f.write(struct.pack("<iiii", t.kmer, nparts, 1, 3))
        np.cumsum(kcounts).astype("<i8").tofile(f)
        f.write(struct.pack("<iii", t.post_bytes, t.cont_bytes, nparts))
        f.write(struct.pack("<q", maxpre))
        # old indexes record their build-time count cutoff; this table
        # holds every kmer, so declare the representable maximum
        f.write(struct.pack("<ii", t.freq if t.freq else 255, ncontig))
        t.perm.astype("<i4").tofile(f)
        idx16.astype("<i8").tofile(f)
    return stub


def remove_gix(path, also_gdb: bool = False):
    """GIXrm equivalent: delete .gix + hidden part files (+ GDB w/ -g)."""
    stub, part_prefix = gix_paths(path)
    stub.unlink(missing_ok=True)
    p = 1
    while True:
        f = Path(f"{part_prefix}{p}")
        if not f.exists():
            break
        f.unlink()
        p += 1
    post_prefix = stub.parent / ("." + stub.name[:-4] + ".post.")
    p = 1
    while True:
        f = Path(f"{post_prefix}{p}")
        if not f.exists():
            break
        f.unlink()
        p += 1
    if also_gdb:
        from .gdb import GDB as _G
        skel, bps = _G.paths(str(stub)[:-4])
        skel.unlink(missing_ok=True)
        bps.unlink(missing_ok=True)
