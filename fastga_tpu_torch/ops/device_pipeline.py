"""Device seed pipeline: GIX tables, adaptamer merge and chain sweep on the
card.

Port of fastga_tpu/ops/device_pipeline.py.  ``device_tubes`` takes a pair
of genomes: per-genome syncmer entry tables built from the packed bases
(one sort whose keys carry the payload), the adaptamer merge of the driver
table (genome 1, forward entries) against genome 2's full table as ONE
combined stream (merge_kernels.merge_sorted_streams) with insertion ranks,
neighbour LCPs and the reference's freq-capped group windows from fused
scans (scan_kernels.fused_scan), the ragged seed expansion, and the
bucket-pair chain sweep (a sort of the seeds, a merge with their shifted
copies, segmented scans for every per-chain aggregate); ``symmetric`` adds
the -S flip pass (genome 2 driving in every orientation against genome 1's
full table).  ``device_tubes_self`` seeds one genome against itself within
its own table (``self_seeds``).  ``device_tubes_tables`` uploads
io.gix.GixTables, the route of mask bytes (``-M``, ``#mask``, masked
tables) and of a self comparison with a given table; it takes a pair
(with or without -S) or self.  ``device_tubes_paneled``
streams a pair or self past the single-shot bases: the tables of one
24-bit kmer-prefix range at a time, their seeds appended to one buffer on
the device and chained once.  Only the tube arrays come back to the host;
the counts are the only other host syncs.

Semantics are those of the host path (ops/merge.py, ops/chain.py): the same
TubeBatch, seed count and seed-length sum.  The JAX package's checks that
need nothing on the device (``decline_reason``) are made once a route: past
one, it raises ``Declined`` with the JAX reason before any upload.  Once
the tables are on the device every size follows the device's own counts,
so a run that starts there ends there; an error on the card, out of memory
included, reaches the caller.  Where the JAX package has a static cap after
upload, the port sizes to the count instead and gives the same records:
- a genome's GIX table keeps all its entries (the JAX package declines past
  max(4096, N));
- a seed expansion takes its own total's bucket of slots, read once before
  it allocates (``_expansion_slots``; a masked or -S pass's total counts
  the seeds it drops after the expansion), where the JAX package takes
  static slots (N1, 2 * E1, twice a table's rows) and declines past them;
  alive driving rows size nothing, so they have no cap;
- the chain sweep emits every tube it counts (the JAX package truncates to
  a tube cap and declines);
- past CHAIN_DEV_CAP seeds the chain sweeps A-contig ranges of the
  acont-sorted seeds one at a time, and a contig with more seeds than a
  range takes a window of its own seeds' bucket (the JAX package sweeps
  on the host past a paneled cap or such a contig);
- each kmer panel's table takes the bucket of its entries, counted once a
  genome in its panel plane, and the paneled global seed buffer grows to
  its seeds (the JAX package doubles the panels up to a limit, then
  declines).
The XLA sorts of the JAX pipeline are ``torch.sort`` here; its one-key
sort that compacts the kept seeds of a masked or -S pass is a stable
compaction (``_compact``).

``build_gix_device`` is the index build of ``gixmake`` and the command
line: ``gix_arrays`` of one genome, with the masked-prefix bytes of its
mask intervals (``masked_prefix``), of which only the finished entry rows
come back to the host as an io.gix.GixTable.
"""

from __future__ import annotations

import sys
import time
from contextlib import nullcontext

import numpy as np
import torch

from ..io import gix as gixm
from ..utils import prof
from ..utils.dna import compress
from .chain import TubeBatch
from .constants import COMP, KMER, SOFF, TMAP, TMER
from .merge_kernels import lexsort2, merge_sorted_streams
from .scan_kernels import fused_scan
from .wave_kernels import _i32

F = 10  # adaptamer frequency cap (reference -f default; merge window cap)

I64MAX = (1 << 63) - 1
M32 = 0xFFFFFFFF

NPREFIX = 1 << 24         # 24-bit kmer prefix space (panel granularity)
MAX_CONT = 1 << 12        # contig-rank field width (reference envelope:
MAX_POST = 1 << 28        # "at most several thousand contigs")
MAX_FREQ = 10             # device freq cap (window-min packing: 6+3
                          # six-bit values per value word); higher -f
                          # takes the host merge


def _roll(x, s):
    return torch.roll(x, s, 0)


# ---------------------------------------------------------------------------
# Section 1: GIX table arrays on the device
# ---------------------------------------------------------------------------

_LUTS = {}


def _luts(dev):
    """The candidates' lookup tables on ``dev``, uploaded once a device
    (``_LUTS`` holds one entry a device, never changed): TMAP (int32),
    COMP (int64) and the kmer-byte table (int64 [512]): a .bps byte's
    four bases (first base in the low bits) in kmer order (first base in
    the high bits) at [0, 256), their complements in reverse order, a
    reverse-complement kmer's byte, at [256, 512)."""
    t = _LUTS.get(dev)
    if t is None:
        v = np.arange(256, dtype=np.int64)
        rev = (((v & 3) << 6) | (((v >> 2) & 3) << 4)
               | (((v >> 4) & 3) << 2) | ((v >> 6) & 3))
        t = _LUTS[dev] = tuple(torch.as_tensor(x, device=dev) for x in (
            TMAP.astype(np.int32), COMP.astype(np.int64),
            np.concatenate([rev, (~v) & 0xFF])))
    return t


def entry_candidates(bases, loc, ln, cranks, in_block):
    """Syncmer entry candidates for a run of positions.

    bases: int32 [L] base codes (garbage across contig seams is fine: uses
    are masked to in-contig windows); loc/ln: contig-relative position and
    contig length per position; cranks: contig length-rank per position;
    in_block: positions this caller owns.

    Returns arrays of length 2L, forward slots then reverse-complement
    slots: (ok, w0, w1, w2, cont, post, comp)."""
    L = bases.shape[0]
    dev = bases.device
    kb = KMER // 4

    b = bases.to(torch.int32)
    n4 = (b << 6) | (_roll(b, -1) << 4) | (_roll(b, -2) << 2) | _roll(b, -3)
    tmap, compt, _ = _luts(dev)
    n4l = n4.to(torch.int64)
    tf = tmap[n4l]
    tc = tmap[compt[n4l]]
    v = torch.minimum((tf << 8) | _roll(tf, -4), (_roll(tc, -4) << 8) | tc)

    # closed-syncmer selection over valid 12-mer windows
    m = v
    for k in range(1, SOFF + 1):
        m = torch.minimum(m, _roll(v, -k))
    sel = (v == m) | (_roll(v, -SOFF) == m)
    inctg = in_block & (loc + TMER <= ln) & (ln >= KMER)
    sel = sel & inctg
    fwd_ok = sel & (loc <= ln - KMER)
    rc_ok = sel & (loc >= KMER - TMER)

    # entry words from rolls of n4 (the rc entry ending at i+TMER-1 reads
    # COMP[n4[i + 8 - 4t]], with COMP[b] == rev2bits(~b))
    def comp_arith(x):
        inv = (~x) & 0xFF
        return (((inv & 0x03) << 6) | ((inv & 0x0C) << 2)
                | ((inv & 0x30) >> 2) | ((inv & 0xC0) >> 6))

    def words_from(bys):
        bys = [t.to(torch.int64) for t in bys]
        w0 = (bys[0] << 24) | (bys[1] << 16) | (bys[2] << 8) | bys[3]
        w1 = (bys[4] << 24) | (bys[5] << 16) | (bys[6] << 8) | bys[7]
        w2 = (bys[8] << 24) | (bys[9] << 16)
        return _i32(w0), _i32(w1), _i32(w2)

    fw0, fw1, fw2 = words_from([_roll(n4, -4 * t) for t in range(kb)])
    cn4 = comp_arith(n4)
    rw0, rw1, rw2 = words_from([_roll(cn4, -(8 - 4 * t)) for t in range(kb)])

    zeros = torch.zeros(L, dtype=torch.int32, device=dev)
    return (torch.cat([fwd_ok, rc_ok]), torch.cat([fw0, rw0]),
            torch.cat([fw1, rw1]), torch.cat([fw2, rw2]),
            torch.cat([cranks, cranks]), torch.cat([loc, loc + TMER]),
            torch.cat([zeros, zeros + 1]))


def _genome_candidates(bps, coff, clen, invp, ncontig):
    """Per-position syncmer candidate arrays of one genome: the contig
    geometry per position (contig, local offset, length, length-rank) comes
    from the small contig tables by one scatter of contig starts and one
    fill scan.  Returns the entry_candidates tuple (length 2N) and N."""
    dev = bps.device
    N = 4 * bps.shape[0]                     # padded base cap
    Cpad = coff.shape[0]

    i = torch.arange(N, dtype=torch.int32, device=dev)
    b = bps.to(torch.int32)
    bases = torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                        1).reshape(-1)

    cvalid = torch.arange(Cpad, device=dev) < ncontig
    starts = torch.where(cvalid, coff.to(torch.int64), N)
    # index N is the dropped slot (padding contigs)
    marks = torch.zeros(N + 1, dtype=torch.int32, device=dev).index_add_(
        0, starts, torch.ones(Cpad, dtype=torch.int32, device=dev))[:N]
    # the last contig continues past its end; length checks gate its
    # positions
    cont_of = torch.cumsum(marks, 0) - 1

    def at_starts(vals):
        """vals at their contigs' start positions, 0 elsewhere."""
        z = torch.zeros(N + 1, dtype=torch.int64, device=dev)
        return z.scatter_reduce_(
            0, starts, torch.where(cvalid, vals.to(torch.int64), 0), "amax",
            include_self=True)[:N]

    # each field filled forward from its contig's start
    coff_at, ln, cranks = fused_scan(
        [at_starts(x) for x in (coff, clen, invp)], (("last", 0),) * 3,
        (marks,))
    loc = i - coff_at
    in_block = (cont_of >= 0) & (cont_of < ncontig)
    return entry_candidates(bases, loc, ln, cranks, in_block), N


def driver_candidates(bps, coff, clen, invp, ncontig):
    """UNSORTED forward-slot entry stream of the merge's driver (genome 1):
    (w0, w1, w2, cont, post, comp=0, lcp=None, nfwd, valid) in genome
    position order with an explicit validity mask."""
    (okflat, w0a, w1a, w2a, conta, posta, compa), N = \
        _genome_candidates(bps, coff, clen, invp, ncontig)
    ok = okflat[:N]
    return (w0a[:N], w1a[:N], w2a[:N], conta[:N], posta[:N], compa[:N],
            None, ok.sum(), ok.to(torch.int32))


def gix_arrays(bps, coff, clen, invp, ncontig, cov=None):
    """Sorted GIX entry arrays of one genome.

    bps: uint8 [Npad/4] 2-bit packed bases (base i at bit 2*(i%4));
    coff/clen: int32 [Cpad] contig base offsets/lengths (padding rows 0);
    invp: int32 [Cpad] contig -> length-rank; ncontig: contig count.

    Returns (w0, w1, w2, cont, post, comp, lcp, nentries, valid): entries
    sorted by (kmer, cont, post, comp) in 2 * Npad rows (both orientations
    of every position), padded with all-ones keys; w0/w1 = kmer bits
    79..16, w2 = bits 15..0 << 16.

    With ``cov`` (int32 [Npad], nonzero at masked bases) the sort runs
    under span ``gix.sort`` and a tenth array follows: each row's
    masked-prefix byte (``masked_prefix``, uint8), gathered by the sort's
    permutation."""
    dev = bps.device
    (okflat, w0a, w1a, w2a, conta, posta, compa), N = \
        _genome_candidates(bps, coff, clen, invp, ncontig)
    mb = None if cov is None else masked_prefix(cov)
    # two packed int64 keys carry all entry data; payloads come back from
    # the sorted keys
    ka, kb = pack_entry_keys(okflat, w0a, w1a, w2a, conta, posta, compa)
    with (nullcontext() if cov is None else prof.span("gix.sort", dev)):
        o = lexsort2(ka, kb)
        w0s, w1s, w2s, cs, ps, os_ = unpack_entry_keys(ka[o], kb[o])
        if mb is not None:
            mb = mb[o]
    nent = okflat.sum()
    vs = (torch.arange(2 * N, device=dev) < nent).to(torch.int32)
    lcp = adjacent_lcp(w0s, w1s, w2s)
    T = (w0s, w1s, w2s, cs, ps, os_, lcp, nent, vs)
    return T if mb is None else T + (mb,)


def masked_prefix(cov):
    """Masked-prefix bytes (io.gix._masked_prefix) of every entry
    candidate of a genome laid end to end, forward slots then
    reverse-complement slots as in entry_candidates: uint8 [2 * Npad].
    The forward slot at base i reads the run of masked bases starting at
    i, the reverse-complement slot (post i + TMER) the run ending at
    i + TMER - 1, each capped at KMER: two segmented sums of the coverage
    that restart at every unmasked base, one a suffix scan.  A run is not
    cut at its contig's ends, as the host's is: an entry's KMER bases lie
    inside its contig, so a run that reaches the contig's end (or start)
    is already KMER long, and the cap gives the same byte."""
    c = (cov != 0).to(torch.int32)
    unmasked = 1 - c
    (ahead,) = fused_scan((c,), (("sum", 0),), (unmasked,), reverse=True)
    (behind,) = fused_scan((c,), (("sum", 0),), (unmasked,))
    return torch.cat([ahead.clamp(max=KMER),
                      _roll(behind, -(TMER - 1)).clamp(max=KMER)]).to(
                          torch.uint8)


def mask_coverage(masks, lens, N, device):
    """int32 [N] per-base mask coverage of a genome laid end to end (its
    contigs at their cumulative offsets), nonzero inside any of ``masks``
    (io.gdb.MaskIval, contig-relative [beg, end), clipped to the contig):
    +1/-1 at each interval's ends, then one fused_scan sum."""
    lens = np.asarray(lens, np.int64)
    coff = np.concatenate([[0], np.cumsum(lens)[:-1]])
    iv = np.array([(m.contig, m.beg, m.end) for m in masks],
                  np.int64).reshape(-1, 3)
    clen = lens[iv[:, 0]]
    beg = coff[iv[:, 0]] + np.clip(iv[:, 1], 0, clen)
    end = coff[iv[:, 0]] + np.clip(iv[:, 2], 0, clen)
    keep = beg < end
    at = torch.as_tensor(np.concatenate([beg[keep], end[keep]]),
                         device=device)
    step = torch.as_tensor(np.repeat(np.array([1, -1], np.int32),
                                     int(keep.sum())), device=device)
    d = torch.zeros(N + 1, dtype=torch.int32, device=device).index_add_(
        0, at, step)[:N]
    return fused_scan((d,), (("sum", None),))[0]


def kmer_bytes(w0, w1, w2):
    """uint8 [n, KMER // 4] big-endian k-mer bytes (io.gix.GixTable.kbytes)
    of entry rows' 80-bit k-mer words."""
    sh = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=w0.device)
    return (torch.cat([w0[:, None] >> sh, w1[:, None] >> sh,
                       w2[:, None] >> sh[:2]], 1) & 0xFF).to(torch.uint8)


def prefix_counts(w0):
    """int64 [NPREFIX + 1] cumulative row counts of the 24-bit k-mer
    prefixes (io.gix._prefix_index) of entry rows sorted by k-mer."""
    pre = torch.zeros(NPREFIX + 1, dtype=torch.int64, device=w0.device)
    pre[1:] = torch.cumsum(torch.bincount(_u32_64(w0) >> 8,
                                          minlength=NPREFIX), 0)
    return pre


def pack_entry_keys(ok, w0a, w1a, w2a, conta, posta, compa):
    """Entry fields -> two int64 sort keys (MAX for invalid slots):
    ka = the 64 high kmer bits (sign-centred), kb = [56:41] kmer bits
    15..0, [40:29] cont, [28:1] post, [0] comp."""
    w0u = _u32_64(w0a)
    w1u = _u32_64(w1a)
    w2_16 = _u32_64(w2a) >> 16
    ka = (w0u - (1 << 31)) * (1 << 32) + w1u
    kb = ((w2_16 << 41) | (conta.to(torch.int64) << 29)
          | (posta.to(torch.int64) << 1) | compa.to(torch.int64))
    return torch.where(ok, ka, I64MAX), torch.where(ok, kb, I64MAX)


def unpack_entry_keys(kas, kbs):
    """Inverse of pack_entry_keys -> (w0, w1, w2, cont, post, comp)."""
    w0s = _i32(((kas >> 32) + (1 << 31)) & M32)
    w1s = _i32(kas & M32)
    w2s = _i32(((kbs >> 41) & 0xFFFF) << 16)
    cs = ((kbs >> 29) & 0xFFF).to(torch.int32)
    ps = ((kbs >> 1) & ((1 << 28) - 1)).to(torch.int32)
    os_ = (kbs & 1).to(torch.int32)
    return w0s, w1s, w2s, cs, ps, os_


def _lz80(x0, x1, x2):
    """Leading zero bits of the 80-bit XOR (x0, x1, x2 its 32-bit words)."""
    return torch.where(x0 != 0, _clz32_arr(x0),
                       torch.where(x1 != 0, 32 + _clz32_arr(x1),
                                   64 + _clz32_arr(x2)))


def adjacent_lcp(w0s, w1s, w2s):
    """lcp[i] = base-lcp(row i-1, row i) over sorted 80-bit kmer words,
    capped at KMER; lcp[0] = 0."""
    lz = _lz80(w0s ^ _roll(w0s, 1), w1s ^ _roll(w1s, 1),
               w2s ^ _roll(w2s, 1))
    lcp = (lz >> 1).clamp(max=KMER).to(torch.int32)
    lcp[0] = 0
    return lcp


def _clz32_arr(x):
    """Leading zeros of the low 32 bits (int64 arithmetic: the CPU build of
    torch has no uint32 shifts or compares)."""
    xu = x.to(torch.int64) & M32
    n_ = torch.zeros(xu.shape, dtype=torch.int32, device=xu.device)
    y = xu
    for sh in (16, 8, 4, 2, 1):
        big = y >= (1 << sh)
        n_ = torch.where(big, n_ + sh, n_)
        y = torch.where(big, y >> sh, y)
    return torch.where(xu == 0, 32, 31 - n_).to(torch.int32)


def _u32_64(x):
    """int32 -> its unsigned value as int64."""
    return x.to(torch.int64) & M32


def _seg_cumsum(x, start):
    """Segmented cumulative sum in int64: fused_scan's sum64 channel,
    restarting at every row where ``start`` is set.  Exact at any size (the
    JAX package's difference-of-prefix-sums form holds below 2^36)."""
    return fused_scan((x,), (("sum64", 0),), (start,))[0]


# ---------------------------------------------------------------------------
# Section 2: adaptamer merge on the device (combined stream)
# ---------------------------------------------------------------------------

def _entry_keys(T, tag: int):
    """(k1, k2, valid) int64 sort keys of one table's entries (MAX when
    invalid).  k1 = 64 kmer bits; k2 = [62:47] kmer bits 15..0, [46] tag,
    [45:34] cont, [33:6] post, [5] comp."""
    w0, w1, w2, c, p, o, _l, n, vs = T
    E = w0.shape[0]
    # front-compacted tables mark validity by count; the unsorted driver
    # candidates carry a slot mask
    valid = ((torch.arange(E, device=w0.device) < n) if vs is None
             else (vs != 0))
    k1 = (_u32_64(w0) - (1 << 31)) * (1 << 32) + _u32_64(w1)
    w2_16 = _u32_64(w2) >> 16
    k2 = ((w2_16 << 47) | (tag << 46) | (c.to(torch.int64) << 34)
          | (p.to(torch.int64) << 6) | (o.to(torch.int64) << 5))
    return (torch.where(valid, k1, I64MAX), torch.where(valid, k2, I64MAX),
            valid)


def _window_mins(l2, n2, freq):
    """T2-space rolling minima of the adjacent-lcp array: wup[u-1][j] =
    min(l2c[j+1..j+u]) and wdn[u-1][j] = min(l2c[j-u+1..j]) for u = 1 ..
    freq-1, with l2c = min(l2, KMER) masked to 0 outside [0, n2)."""
    E = l2.shape[0]
    iota = torch.arange(E, dtype=torch.int32, device=l2.device)
    l2c = torch.where(iota < n2, l2.clamp(max=KMER), 0)
    wup, wdn = [], []
    cur_up = cur_dn = None
    for u in range(1, freq):
        r = torch.where(iota + u < E, _roll(l2c, -u), 0)
        cur_up = r if cur_up is None else torch.minimum(cur_up, r)
        wup.append(cur_up)
        rd = torch.where(iota - (u - 1) >= 0, _roll(l2c, u - 1), 0)
        cur_dn = rd if cur_dn is None else torch.minimum(cur_dn, rd)
        wdn.append(cur_dn)
    return wup, wdn


def _pack6(vals, lo_count, E, device):
    """Pack a list of 6-bit values into (lo, hi) int64 words."""
    lo = torch.zeros(E, dtype=torch.int64, device=device)
    hi = torch.zeros(E, dtype=torch.int64, device=device)
    for i, v in enumerate(vals[:lo_count]):
        lo = lo | (v.to(torch.int64) << (6 * i))
    for i, v in enumerate(vals[lo_count:]):
        hi = hi | (v.to(torch.int64) << (6 * i))
    return lo, hi


def merge_seeds(T1, T2, ns_cap: int = 0, freq: int = F,
                soft_mask: bool = False, has_masks: bool = False,
                maskb1=None, maskb2=None, flip: bool = False):
    """Adaptamer seeds between two device tables, both sorted by the
    composite entry key (kmer, cont, post, comp) with +MAX-tail validity
    (the JAX package's ``presorted=True`` path).

    T1 (driver, forward entries drive) and T2 (members) merge into ONE
    stream; insertion ranks, lcps to the nearest T2 rows and T2's window
    minima transported to T1 rows come from one forward and one reverse
    fused scan; non-driving T1 rows ride along with a dead bit.  Returns
    (plen, acont, apost, bcont, bpost, bcomp, nseeds, nalive), rows at
    index >= nseeds being padding, in the host's emission order.  The
    expansion takes its total's bucket of slots (``_expansion_slots``), or
    ``ns_cap`` where that is more.

    ``has_masks``: the tables' mask bytes (``maskb1``/``maskb2``, each
    entry's masked-prefix length as an int32 tensor) ride the merge at
    payload bit 54; a driving row whose own byte is not below ``mlen`` (its
    plen under ``soft_mask``, else KMER + 1) does not drive, and a seed
    whose member's byte is not below it is dropped after the expansion.
    ``flip=True`` is the -S second pass (FastGA.c:833-913, host
    ops/merge.adaptamer_seeds_flip): T1 is genome 2, driving in every
    orientation, T2 genome 1; the seeds are (A = a forward member, B = the
    driver with its orientation as bcomp), in (driver, member) order, the
    host's multiset; pass the masks swapped.  Either drops seeds after the
    expansion: the kept ones move to the front in slot order and nseeds
    counts them (``_compact``)."""
    dev = T1[0].device
    E1 = T1[0].shape[0]
    E2 = T2[0].shape[0]
    M = E1 + E2
    n2 = T2[7]

    k1a, k2a, val1 = _entry_keys(T1, 0)
    k1b, k2b, _ = _entry_keys(T2, 1)
    # only forward T1 entries drive the merge (FastGA.c:916-928; any
    # orientation in the flip pass); the others stay in place with a dead
    # bit (payload bit 62) so T1 stays sorted
    drive1 = val1 if flip else val1 & (T1[5] == 0)
    vup1 = (val1 & ~drive1).to(torch.int64) << 62

    # T2-space window minima, 6 bits each (lo = 6 values, hi = up to 3 more
    # at bits 36-53), ride the merge as payload; the mask bytes at bits
    # 54-59, out of the 18-bit planes the scans carry
    wup, wdn = _window_mins(T2[6], n2, freq)
    nlo = min(len(wup), 6)
    up_lo2, up_hi2 = _pack6(wup, nlo, E2, dev)
    dn_lo2, dn_hi2 = _pack6(wdn, nlo, E2, dev)
    vup2 = (up_hi2 << 36) | up_lo2
    if has_masks:
        mb2 = maskb2.to(torch.int64)
        vup1 = vup1 | (maskb1.to(torch.int64) << 54)
        vup2 = vup2 | (mb2 << 54)
    k1s, k2s, vups, vdns = merge_sorted_streams(
        (k1a, k2a, vup1, torch.zeros(E1, dtype=torch.int64, device=dev)),
        (k1b, k2b, vup2, (dn_hi2 << 36) | dn_lo2))

    valid = k2s != I64MAX
    is2 = ((k2s >> 46) & 1).to(torch.bool) & valid
    cont = ((k2s >> 34) & (MAX_CONT - 1)).to(torch.int32)
    post = ((k2s >> 6) & (MAX_POST - 1)).to(torch.int32)
    w2_16 = (k2s >> 47) & 0xFFFF

    # adjacent-row lcp over the 80 kmer bits
    w0u = ((k1s >> 32) + (1 << 31)) & M32
    w1u = k1s & M32
    lz = _lz80(w0u ^ _roll(w0u, 1), w1u ^ _roll(w1u, 1),
               (w2_16 ^ _roll(w2_16, 1)) << 16)
    ridx = torch.arange(M, dtype=torch.int32, device=dev)
    alcp = (lz >> 1).clamp(max=KMER)
    alcp = torch.where((ridx > 0) & valid & _roll(valid, 1), alcp, 0)

    # one forward pass: T2 insertion ranks, pred-side segmented lcp minima
    # and the T2 window words (18-bit planes) carried to following rows;
    # one reverse pass for the succ-side equivalents
    nalcp = _roll(alcp, -1)             # lcp(row i, row i+1)
    is2i = is2.to(torch.int32)
    startp = ((ridx == 0) | _roll(is2, 1)).to(torch.int32)
    m18 = 0x3FFFF
    m2cum32, nsegp, dn_p0, dn_p1, dn_p2 = fused_scan(
        (is2i, -alcp, vdns & m18, (vdns >> 18) & m18, (vdns >> 36) & m18),
        (("sum", None), ("max", 0), ("last", 1), ("last", 1), ("last", 1)),
        (startp, is2i))
    segmin_p = -nsegp
    # reverse flag: reset at the nearest following T2 row
    g_succ = torch.where(ridx == M - 1, 1, _roll(is2i, -1))
    nsegs, up_p0, up_p1, up_p2 = fused_scan(
        (-nalcp, vups & m18, (vups >> 18) & m18, (vups >> 36) & m18),
        (("max", 0), ("last", 1), ("last", 1), ("last", 1)),
        (g_succ, is2i), reverse=True)
    segmin_s = -nsegs
    ins = m2cum32 - is2i
    n2_after = n2.to(torch.int32) - m2cum32
    lcp_pred = torch.where(ins > 0, segmin_p, -1)
    lcp_succ = torch.where(n2_after > 0, segmin_s, -1)

    plen = torch.maximum(lcp_pred, lcp_succ)
    alive0 = (~is2) & valid & (plen >= 12) & (((vups >> 62) & 1) == 0)
    up0 = (lcp_succ >= plen) & (n2_after > 0) & alive0
    dn0 = (lcp_pred >= plen) & (ins > 0) & alive0

    def win_ok_counts(planes):
        # three packed 6-bit values per 18-bit plane, from bit 0 on
        cnt = torch.zeros(M, dtype=torch.int32, device=dev)
        for u in range(1, freq):
            pi, off = divmod(u - 1, 3)
            wv = (planes[pi] >> (6 * off)) & 63
            cnt = cnt + (wv >= plen).to(torch.int32)
        return cnt

    upc = torch.where(up0, 1 + win_ok_counts((up_p0, up_p1, up_p2)), 0)
    dnc = torch.where(dn0, 1 + win_ok_counts((dn_p0, dn_p1, dn_p2)), 0)
    count = upc + dnc
    alive = alive0 & (count < freq)
    if has_masks:
        mlen = plen if soft_mask else KMER + 1
        alive = alive & (((vups >> 54) & 63) < mlen)
    cnt = torch.where(alive, count, 0).to(torch.int64)

    # ragged expansion directly over the merged stream: per-seed owner rows
    # from a scatter-max of row indices at each owner's first slot plus a
    # forward fill (owners appear in increasing row order); in the flip
    # pass the driver's orientation rides at bit 47
    v1 = ((plen.to(torch.int64) << 40) | (cont.to(torch.int64) << 28)
          | post.to(torch.int64))
    if flip:
        v1 = v1 | (((k2s >> 5) & 1) << 47)
    y0 = ins - dnc
    nalive = alive.sum()
    cum_incl = torch.cumsum(cnt, 0)     # nseeds < 2^31
    cum_excl = cum_incl - cnt
    nseeds = cum_incl[M - 1]
    slots = _expansion_slots(nseeds, ns_cap)
    own = alive & (cum_excl < slots)
    row0 = torch.full((slots,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(
        0, cum_excl[own], ridx[own].to(torch.int64), "amax",
        include_self=True)
    sidx = torch.arange(slots, dtype=torch.int32, device=dev)
    # the owner row fills forward (a running max), and so does the owner's
    # first slot (from the marked slots)
    rowf, start_slot = fused_scan((row0, sidx),
                                  (("max", None), ("last", 0)),
                                  ((row0 >= 0).to(torch.int32),))
    ec = rowf.clamp(0, M - 1)
    g1 = v1[ec]
    y = y0[ec] + (sidx - start_slot)
    yc = y.clamp(0, E2 - 1).to(torch.int64)
    # the member's mask byte rides the low 6 bits
    t2pack = ((T2[4].to(torch.int64) << 19) | (T2[3].to(torch.int64) << 7)
              | (T2[5].to(torch.int64) << 6))
    if has_masks:
        t2pack = t2pack | mb2
    tg = t2pack[yc]

    pl = ((g1 >> 40) & 63).to(torch.int32)
    # the driver's side and the member's (A and B swap in the flip pass)
    dc = ((g1 >> 28) & (MAX_CONT - 1)).to(torch.int32)
    dpos = (g1 & (MAX_POST - 1)).to(torch.int32)
    mc = ((tg >> 7) & (MAX_CONT - 1)).to(torch.int32)
    mpos = (tg >> 19).to(torch.int32)
    mo = ((tg >> 6) & 1).to(torch.int32)
    if not (has_masks or flip):
        return pl, dc, dpos, mc, mpos, mo, nseeds, nalive
    keep = sidx < nseeds
    if flip:
        seeds = (pl, mc, mpos, dc, dpos, ((g1 >> 47) & 1).to(torch.int32))
        keep = keep & (mo == 0)
    else:
        seeds = (pl, dc, dpos, mc, mpos, mo)
    if has_masks:
        keep = keep & ((tg & 63) < (pl if soft_mask else KMER + 1))
    return _compact(keep, seeds) + (nalive,)


def _expansion_slots(total, ns_cap: int) -> int:
    """Slots of a seed expansion, from its total (a tensor; the seed
    function's one host sync): the total's bucket, at least 8,192, or
    ``ns_cap`` where that is more (the JAX package's slots, where a test
    compares rows with its)."""
    return max(int(ns_cap), _pad_bucket(max(int(total), 1 << 13)))


def _compact(keep, seeds):
    """The kept slots of an expansion moved to the front in slot order (the
    JAX package's one-key sort of the slots): each kept slot's rank, an
    exclusive fused_scan sum, then one scatter of the packed seed.  Returns
    the six seed columns and the kept count."""
    pl, ac, ap, bc, bp, bo = (x.to(torch.int64) for x in seeds)
    slots = keep.shape[0]
    k = keep.to(torch.int32)
    incl = fused_scan((k,), (("sum", None),))[0]
    # dropped slots all go to the spare last row
    dst = torch.where(keep, incl - k, slots).to(torch.int64)

    def scatter(v):
        return torch.zeros(slots + 1, dtype=torch.int64,
                           device=v.device).scatter_(0, dst, v)[:slots]
    s1 = scatter((pl << 40) | (ac << 28) | ap)
    s2 = scatter((bc << 29) | (bp << 1) | bo)
    nseeds = incl[-1].to(torch.int64)
    return ((s1 >> 40).to(torch.int32),
            ((s1 >> 28) & (MAX_CONT - 1)).to(torch.int32),
            (s1 & (MAX_POST - 1)).to(torch.int32),
            (s2 >> 29).to(torch.int32),
            ((s2 >> 1) & (MAX_POST - 1)).to(torch.int32),
            (s2 & 1).to(torch.int32), nseeds)


def _with_plsum(out):
    """A seed function's outputs plus the seed-length sum over the valid
    prefix: (plen, acont, apost, bcont, bpost, bcomp, nseeds, nalive,
    plsum)."""
    pl, ns = out[0], out[6]
    sidx = torch.arange(pl.shape[0], device=pl.device)
    return tuple(out) + (torch.where(sidx < ns, pl, 0).sum(),)


def _merge_seeds_sum(T1, T2, nscap: int = 0, freq: int = F, **masks):
    """merge_seeds plus the seed-length sum (``_with_plsum``); ``masks``
    are merge_seeds' mask arguments."""
    return _with_plsum(merge_seeds(T1, T2, nscap, freq, **masks))


def self_seeds(T1, ns_cap: int = 0, freq: int = F, soft_mask: bool = False,
               has_masks: bool = False, maskb1=None):
    """Self-comparison adaptamer seeds within one sorted table (port of
    ops/merge.self_adaptamer_seeds): every entry of either orientation
    pairs with the other members of its own lcp group, whose window counts
    come from the table's own adjacent-lcp array.  The ragged expansion
    runs over the table rows: an owner scatter, then one fused_scan fills
    the owner row forward (a running max) and the owner's first slot (a
    ``last`` fill).  ``has_masks`` tests the table's mask bytes
    (``maskb1``) as merge_seeds does, on the driving entry and then on the
    member, and compacts the kept seeds (``_compact``).  Returns (plen,
    acont, apost, bcont, bpost, bcomp, nseeds, nalive) at the slots
    merge_seeds takes (a self run fans out up to freq-2 seeds an entry,
    past the JAX package's 2 * E1)."""
    w0, _w1, _w2, c1, p1, o1, l1, n1, _vs = T1
    dev = w0.device
    E1 = w0.shape[0]
    iota = torch.arange(E1, dtype=torch.int32, device=dev)
    valid = iota < n1

    # adj[i] = lcp(entry i-1, entry i) (0 at i = 0 and past n1)
    adj = torch.where(valid & (iota > 0), l1.clamp(max=KMER), 0)
    adj_next = torch.where(iota + 1 < E1, _roll(adj, -1), 0)
    plen = torch.maximum(adj, adj_next)
    alive0 = valid & (plen >= 12)

    # group windows over the table's own lcps: wup[u-1][i] covers member
    # i+u, wdn[u-1][i] member i-u; freq window values a side
    wup, wdn = _window_mins(torch.where(iota > 0, l1, 0), n1, freq + 1)
    upc = torch.zeros(E1, dtype=torch.int32, device=dev)
    dnc = torch.zeros(E1, dtype=torch.int32, device=dev)
    for u in range(freq):
        upc = upc + (wup[u] >= plen).to(torch.int32)
        dnc = dnc + (wdn[u] >= plen).to(torch.int32)
    upc = torch.where(alive0, upc, 0)
    dnc = torch.where(alive0, dnc, 0)
    alive = alive0 & (1 + upc + dnc < freq)
    if has_masks:
        mb1 = maskb1.to(torch.int64)
        alive = alive & (mb1 < (plen if soft_mask else KMER + 1))
    cnt = torch.where(alive, upc + dnc, 0).to(torch.int64)

    nalive = alive.sum()
    cum_incl = torch.cumsum(cnt, 0)     # nseeds < 2^31
    cum_excl = cum_incl - cnt
    nseeds = cum_incl[E1 - 1]
    slots = _expansion_slots(nseeds, ns_cap)
    own = (cnt > 0) & (cum_excl < slots)
    row0 = torch.full((slots,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(
        0, cum_excl[own], iota[own].to(torch.int64), "amax",
        include_self=True)
    sidx = torch.arange(slots, dtype=torch.int32, device=dev)
    rowf, start_slot = fused_scan((row0, sidx),
                                  (("max", None), ("last", 0)),
                                  ((row0 >= 0).to(torch.int32),))
    ec = rowf.clamp(0, E1 - 1).to(torch.int64)
    v1 = ((plen.to(torch.int64) << 40) | (c1.to(torch.int64) << 28)
          | p1.to(torch.int64))
    g1 = v1[ec]
    dncg = dnc[ec]
    off = sidx - start_slot
    # window rows skip x itself: offsets [0, dnc) lie below x, the rest
    # one past it
    y = (iota - dnc)[ec] + off + (off >= dncg).to(torch.int32)
    yc = y.clamp(0, E1 - 1).to(torch.int64)
    tpack = ((p1.to(torch.int64) << 19) | (c1.to(torch.int64) << 7)
             | (o1.to(torch.int64) << 6))
    if has_masks:
        tpack = tpack | mb1
    tg = tpack[yc]

    pl = ((g1 >> 40) & 63).to(torch.int32)
    ac = ((g1 >> 28) & (MAX_CONT - 1)).to(torch.int32)
    ap = (g1 & (MAX_POST - 1)).to(torch.int32)
    bp = (tg >> 19).to(torch.int32)
    bc = ((tg >> 7) & (MAX_CONT - 1)).to(torch.int32)
    bo = o1[ec] ^ ((tg >> 6) & 1).to(torch.int32)
    if not has_masks:
        return pl, ac, ap, bc, bp, bo, nseeds, nalive
    keep = (sidx < nseeds) & ((tg & 63) < (pl if soft_mask else KMER + 1))
    return _compact(keep, (pl, ac, ap, bc, bp, bo)) + (nalive,)


def _self_seeds_sum(T1, nscap: int = 0, freq: int = F, **masks):
    """self_seeds plus the seed-length sum (``_with_plsum``); ``masks``
    are self_seeds' mask arguments."""
    return _with_plsum(self_seeds(T1, nscap, freq, **masks))


def _sym_seeds_sum(T1, T2, nscap1: int = 0, nscap2: int = 0, freq: int = F,
                   soft_mask: bool = False, has_masks: bool = False,
                   maskb1=None, maskb2=None):
    """-S (FastGA.c:2410-2470): the normal pass merge_seeds(T1, T2), then
    the flip pass merge_seeds(T2, T1, flip=True) with the masks swapped
    (each at least ``nscap1`` / ``nscap2`` slots).  The flip seeds follow
    the normal pass's valid prefix in one buffer of both passes' slots,
    the seed count and length sum over both; nalive is the normal
    pass's."""
    mk = dict(soft_mask=soft_mask, has_masks=has_masks)
    oa = _merge_seeds_sum(T1, T2, nscap1, freq, maskb1=maskb1,
                          maskb2=maskb2, **mk)
    ob = _merge_seeds_sum(T2, T1, nscap2, freq, maskb1=maskb2,
                          maskb2=maskb1, flip=True, **mk)
    nsa = int(oa[6])
    cols = tuple(torch.cat([a[:nsa], b, torch.zeros(
        a.shape[0] - nsa, dtype=b.dtype, device=b.device)])
        for a, b in zip(oa[:6], ob[:6]))
    return cols + (oa[6] + ob[6], oa[7], oa[8] + ob[8])


# ---------------------------------------------------------------------------
# Section 3: chain sweep on the device (payload in the keys, scan aggregates)
# ---------------------------------------------------------------------------

BUCK_SHIFT = 6
BUCK_WIDTH = 1 << BUCK_SHIFT

_POFF = 1 << 25      # pairing field offset (pairing >= -1)


def chain_tubes_dev(seeds, ns, amax: int, bmax: int, alens_by_rank,
                    chain_break: int = 2000, chain_min: int = 170):
    """Bucket-pair chain sweep (port of ops/chain.chain_tubes).  ``seeds``
    = (plen, acont, apost, bcont, bpost, bcomp) tensors of length NS < 2^30
    (valid rows < ns); ``alens_by_rank`` an int32 tensor.  Returns the tube
    arrays (acont, bcont, comp, dgmin, dgmax, alow, ahgh, pairing, cov),
    one row a tube in host emission order, and the tube count (read once
    on the host to size them)."""
    plen, acont, apost, bcont, bpost, bcomp = seeds
    dev = plen.device
    NS = plen.shape[0]
    M2 = 2 * NS
    big = 1 << 30
    i32 = torch.int32
    i64 = torch.int64

    ip = apost.to(i32)
    jp = bpost.to(i32)
    maxdag = amax + bmax
    bcf = bcomp.to(i32) != 0
    diag = torch.where(bcf, maxdag - (ip + jp), bmax + (ip - jp))
    anti = torch.where(bcf, amax - (ip - jp), ip + jp)
    dbuck = diag >> BUCK_SHIFT
    drem = diag - (dbuck << BUCK_SHIFT)
    lcp2 = plen.to(i32) << 1

    sidx = torch.arange(NS, dtype=i32, device=dev)
    svalid = sidx < ns

    # Every seed takes part in two bucket pairings: (dbuck, tag 0) and
    # (dbuck-1, tag 1).  The upper copy's keys are exact monotone transforms
    # of the lower copy's, so ONE sort of NS rows and a merge of the two
    # derived sorted streams equal the 2NS-row sort (keys are unique through
    # the seed-index tie-break).  k2 = anti (30 bits) | tag (bit 32) | the
    # row's index (the upper copy's is NS + sidx < 2^32).
    k1l = ((acont.to(i64) << 39) | (bcont.to(i64) << 27)
           | (bcf.to(i64) << 26) | (dbuck.to(i64) + _POFF))
    k2l = (anti.to(i64) << 33) | sidx.to(i64)
    vBl = (drem.to(i64) << 8) | lcp2.to(i64)
    k1l = torch.where(svalid, k1l, I64MAX)
    k2l = torch.where(svalid, k2l, I64MAX)
    vBl = torch.where(svalid, vBl, 0)
    o = lexsort2(k1l, k2l)
    k1ls, k2ls, vBls = k1l[o], k2l[o], vBl[o]
    lvalid = k1ls != I64MAX
    k1u = torch.where(lvalid, k1ls - 1, I64MAX)
    k2u = torch.where(lvalid, k2ls + ((1 << 32) + NS), I64MAX)
    vBu = vBls + (BUCK_WIDTH << 8)
    k1s, k2s, vBs = merge_sorted_streams((k1ls, k2ls, vBls), (k1u, k2u, vBu))

    valid = k1s != I64MAX
    aa = torch.where(valid, k2s >> 33, 0).to(i32)
    tag = ((k2s >> 32) & 1).to(i32)
    dg = ((vBs >> 8) & 0xFF).to(i32)
    ll = (vBs & 0xFF).to(i32)

    ridx = torch.arange(M2, dtype=i32, device=dev)
    pk1 = _roll(k1s, 1)
    gmask = (-1 << 26) & I64MAX
    same_g = (k1s & gmask) == (pk1 & gmask)
    seg = (ridx == 0) | (k1s != pk1)   # group+pairing segment = k1 segment
    seg_end = _roll(seg, -1) | (ridx == M2 - 1)
    same_prev = (ridx > 0) & same_g & (k1s == pk1 + 1)
    segf = seg.to(i32)
    run0, run1 = fused_scan(((valid & (tag == 0)).to(i32),
                             (valid & (tag == 1)).to(i32)),
                            (("max", 0), ("max", 0)), (segf,))
    # the row before a segment start is the previous segment's END row,
    # where the forward scan holds that whole segment's OR
    prev_has_lower = (_roll(run0, 1) != 0) & (ridx > 0)
    prev_adj_row = (seg & same_prev & prev_has_lower).to(i32)
    # constant per segment, set at its start: a forward fill
    prev_adjacent = fused_scan((prev_adj_row,), (("last", 0),),
                               (segf,))[0] != 0
    bf0, bf1 = fused_scan((torch.where(seg_end, run0, -1),
                           torch.where(seg_end, run1, -1)),
                          (("max", 0), ("max", 0)), (seg_end.to(i32),),
                          reverse=True)
    has_lower = bf0 != 0
    has_upper = bf1 != 0

    examine = has_lower & (~prev_adjacent | has_upper)
    new_row = (~prev_adjacent).to(i32)
    keep_entry = examine & valid

    # stable compaction of the kept rows; payload packed into the values
    kcomp = ((~keep_entry).to(i64) << 58) | ridx.to(i64)
    vA = k1s & ((1 << 52) - 1)       # ga|gb|gc|pairing'
    vB2 = ((aa.to(i64) << 20) | (dg.to(i64) << 12) | (ll.to(i64) << 4)
           | (seg.to(i64) << 3) | (new_row.to(i64) << 2)
           | (tag.to(i64) << 1) | keep_entry.to(i64))
    o = torch.sort(kcomp).indices
    vAc = torch.where(keep_entry, vA, 0)[o]
    vBc = torch.where(keep_entry, vB2, 0)[o]
    ga = ((vAc >> 39) & (MAX_CONT - 1)).to(i32)
    gb = ((vAc >> 27) & (MAX_CONT - 1)).to(i32)
    gc = ((vAc >> 26) & 1).to(i32)
    pairing = ((vAc & (_POFF * 2 - 1)) - _POFF).to(i32)
    aa = (vBc >> 20).to(i32)
    dg = ((vBc >> 12) & 0xFF).to(i32)
    ll = ((vBc >> 4) & 0xFF).to(i32)
    new_row = ((vBc >> 2) & 1).to(i32)
    tag = ((vBc >> 1) & 1).to(i32)
    valid = (vBc & 1).to(torch.bool)
    seg = ((vBc >> 3) & 1).to(torch.bool) | (ridx == 0)

    # chain segmentation with the two-sided break test
    cps = aa + ll

    def segmax1(x, f):
        return fused_scan((x,), (("max", 0),), (f.to(i32),))[0]

    if chain_break >= 256:
        # Closed form (no fixpoint).  Within a segment aa is non-decreasing
        # and ll <= 255, so with chain_break >= 256 two entries within 255
        # aa units never break apart and any older entry is dominated: the
        # running chain max at entry i is the max cps over entries with
        # aa > aa_{i-1} - 256, i.e. a prefix max within 256-wide aa bins
        # joined with the previous bin's full max.
        binb = seg | ((ridx > 0) & ((aa >> 8) != _roll(aa >> 8, 1)))
        pbin = segmax1(torch.where(valid, cps, -big), binb)
        prevb = torch.where(binb & ~seg, _roll(pbin, 1), -big)
        prevf = segmax1(prevb, binb)
        WMp = _roll(torch.maximum(pbin, prevf), 1)
        brk = seg | (~seg & valid & (aa >= WMp + chain_break))
    else:
        Mx = segmax1(cps, seg)
        inner = ~seg & valid
        definite = inner & (aa >= _roll(Mx, 1) + chain_break)
        never = inner & (aa < _roll(cps, 1) + chain_break)
        amb = inner & ~definite & ~never
        brk = seg | definite
        while True:      # exact fixpoint over the ambiguous gaps
            Mc = segmax1(cps, brk)
            nb = brk | (amb & (aa >= _roll(Mc, 1) + chain_break))
            changed = bool((nb != brk).any())
            brk = nb
            if not changed:
                break

    # per-chain aggregates: one 13-channel forward scan, values at chain
    # ends
    ch_end = _roll(brk, -1) | (ridx == M2 - 1)
    agg_vals = (
        torch.where(valid, -dg, -big),          # min via negation
        torch.where(valid, dg, -big),
        torch.where(valid, cps, -big),
        (valid & (tag == 0)).to(i32),
        (valid & (tag == 1)).to(i32),
        valid.to(i32))
    first_vals = tuple(torch.where(brk, x, -1)
                       for x in (ga, gb, gc, pairing + (1 << 25), new_row,
                                 aa))
    outs = fused_scan((cps,) + agg_vals + first_vals, (("max", 0),) * 13,
                      (brk.to(i32),))
    ahgh_run, run, f_run = outs[0], outs[1:7], outs[7:13]
    prev_ahgh = torch.where(ridx == 0, 0, _roll(ahgh_run, 1))
    novel = torch.where(brk, ll,
                        torch.minimum(cps - prev_ahgh, ll).clamp(min=0))
    novel = torch.where(valid, novel, 0)
    # segmented coverage sum: int32 is safe while 255 * M2 fits (novel <=
    # 255 per row)
    if 255 * M2 < (1 << 31):
        cov = fused_scan((novel,), (("sum", 0),), (brk.to(i32),))[0]
    else:
        cov = _seg_cumsum(novel, brk)

    ch_dgmin = -run[0]
    ch_dgmax, ch_ahgh = run[1], run[2]
    ch_mix_l, ch_mix_u, ch_valid = run[3] != 0, run[4] != 0, run[5] != 0
    ch_ga, ch_gb, ch_gc = f_run[0], f_run[1], f_run[2]
    ch_pair = f_run[3] - (1 << 25)
    ch_new = f_run[4] != 0
    ch_alow = f_run[5]

    keep = (ch_valid & (cov >= chain_min)
            & (~(ch_mix_l & ~ch_mix_u) | ch_new) & ch_end)

    # compact the kept chains (in chain order) to the front; tuples packed
    c1 = ((ch_ga.to(i64) << 39) | (ch_gb.to(i64) << 27)
          | (ch_gc.to(i64) << 26) | (ch_pair.to(i64) + _POFF))
    c2 = ((ch_alow.to(i64) << 15) | (ch_dgmax.to(i64) << 7)
          | ch_dgmin.to(i64))
    # cov rides c3's high bits: the per-chain seed coverage is the wave
    # scheduler's wave-count predictor
    c3 = (cov.to(i64) << 31) | ch_ahgh.to(i64)
    kk = ((~keep).to(i64) << 58) | ridx.to(i64)
    ntubes = keep.sum()
    o = torch.sort(kk).indices[:int(ntubes)]
    c1o, c2o, c3o = c1[o], c2[o], c3[o]

    o_ga = ((c1o >> 39) & (MAX_CONT - 1)).to(i32)
    o_gb = ((c1o >> 27) & (MAX_CONT - 1)).to(i32)
    o_gc = ((c1o >> 26) & 1).to(i32)
    o_pair = ((c1o & (_POFF * 2 - 1)) - _POFF).to(i32)
    o_alow = (c2o >> 15).to(i32)
    o_dgmax = ((c2o >> 7) & 0xFF).to(i32)
    o_dgmin = (c2o & 0x7F).to(i32)
    o_cov = (c3o >> 31).to(i32)
    o_ahgh = (c3o & ((1 << 31) - 1)).to(i32)

    # contig-coordinate conversion (a gather of the small table a tube)
    alen = alens_by_rank[o_ga.clamp(0, alens_by_rank.shape[0] - 1).to(i64)]
    dgmin = o_dgmin + (o_pair << BUCK_SHIFT)
    dgmax = o_dgmax + (o_pair << BUCK_SHIFT)
    is_c = o_gc != 0
    dgmin = torch.where(is_c, dgmin + (alen - maxdag), dgmin - bmax)
    dgmax = torch.where(is_c, dgmax + (alen - maxdag), dgmax - bmax)
    alow = torch.where(is_c, o_alow + (alen - amax), o_alow)
    ahgh = torch.where(is_c, o_ahgh + (alen - amax), o_ahgh)
    return (o_ga, o_gb, is_c, dgmin, dgmax, alow, ahgh, o_pair, o_cov,
            ntubes)


# ---------------------------------------------------------------------------
# Wrapper: GDB pair -> TubeBatch (Declined before any upload)
# ---------------------------------------------------------------------------

# The JAX package's sizes, set for a 16 GB device and kept as they are so
# that both packages take the same routes.
_MAX_DEV_BASES = (1 << 26) + (1 << 25)   # single-shot bases per genome
MAX_ROWS = 1 << 26                       # rows of an uploaded GIX table
CHAIN_DEV_CAP = 3 << 23                  # largest monolithic seed bucket


class Declined(Exception):
    """A seed route's input past a cap of the card (``decline_reason``),
    raised before anything goes up; ``reason`` is the JAX package's."""

    @property
    def reason(self):
        return self.args[0]


def decline_reason(lens=(), freq=None, single_shot=False, rows=(),
                   ncontig=(), widths=()):
    """Why the card cannot take an input (the JAX package's words), or
    None: every cap a route checks before its upload.  ``lens``: the
    genomes' contig lengths (self gives its genome twice); a table route
    gives its tables' contig counts (``ncontig``), longest contigs
    (``widths``: amax, bmax) and ``rows`` instead.  ``single_shot`` adds
    the single-shot bases cap, ``freq`` the merge's.  The first cap
    passed is named: empty, bases, rows, contigs, field width, freq."""
    if any(len(x) == 0 for x in lens):
        return "empty genome"
    ncontig = tuple(ncontig) + tuple(len(x) for x in lens)
    widths = tuple(widths) + tuple(int(x.max()) for x in lens)
    if single_shot and max(int(x.sum()) for x in lens) > _MAX_DEV_BASES:
        return "genome exceeds single-shot device bases"
    if max(rows, default=0) >= MAX_ROWS:
        return "GIX table exceeds 2^26 entries"
    if max(ncontig) >= MAX_CONT:
        return f">= {MAX_CONT} contigs"
    amax, bmax = widths[0], widths[-1]
    if amax + 2 * bmax >= (1 << 30) or max(widths) >= MAX_POST:
        return "contig length exceeds device field width"
    if freq is not None and freq > MAX_FREQ:
        return f"-f {freq} > device merge cap {MAX_FREQ}"
    return None


def _pad_bucket(n: int) -> int:
    """Smallest cap >= n from {2^k, 1.5*2^k}."""
    n = max(int(n), 1 << 12)
    p = 1 << (n - 1).bit_length()
    if n <= (p >> 1) + (p >> 2):
        return (p >> 1) + (p >> 2)
    return p


def _prep_genome(gdb, lens, device):
    """Packed bases and contig tables of one genome on ``device``:
    (bps, coff, clen, invp, ncontig, N)."""
    coff = np.zeros(len(lens), np.int64)
    if len(lens) > 1:
        coff[1:] = np.cumsum(lens)[:-1]
    total = int(lens.sum())
    N = _pad_bucket(total)
    if (np.asarray(lens) % 4 == 0).all() and N % 4 == 0:
        # byte-aligned contigs: concatenate the .bps slices
        packed_all = gdb._packed()
        bps = np.zeros(N // 4, np.uint8)
        o = 0
        for c in gdb.contigs:
            nb = c.clen // 4
            bps[o:o + nb] = packed_all[c.boff:c.boff + nb]
            o += nb
    else:
        # contig boundaries inside a byte: unpack and repack
        basespad = np.zeros(N, np.uint8)
        pos = 0
        for r in range(gdb.ncontig):
            c = gdb.get_contig(r)
            basespad[pos:pos + len(c)] = c
            pos += len(c)
        bps = compress(basespad)
    invp = gixm.contig_order(lens)[2]
    Cpad = 1 << max(3, (len(lens) - 1).bit_length())
    tabs = np.zeros((3, Cpad), np.int32)
    tabs[0, :len(lens)] = coff
    tabs[1, :len(lens)] = lens
    tabs[2, :len(lens)] = invp[:len(lens)]
    t = torch.as_tensor(tabs, device=device)
    return (torch.as_tensor(bps, device=device), t[0], t[1], t[2],
            len(lens), N)


def driver_table(C, ecap: int):
    """Compact the unsorted driver candidates into a sorted table of ecap
    rows (one sort whose keys fully order the forward entries)."""
    w0a, w1a, w2a, ca, pa, oa, _l, nf, vs = C
    ka, kb = pack_entry_keys(vs != 0, w0a, w1a, w2a, ca, pa, oa)
    o = lexsort2(ka, kb)[:ecap]
    return unpack_entry_keys(ka[o], kb[o]) + (None, nf, None)


def _full_table(gdb, lens, device, prep=None):
    """One genome's sorted two-orientation GIX table, trimmed to its
    entries' bucket; ``prep``: the genome's ``_prep_genome`` tuple, where
    the caller made it."""
    bps, coff, clen, invp, nc, N = prep or _prep_genome(gdb, lens, device)
    Tf = gix_arrays(bps, coff, clen, invp, nc)
    Et = min(_pad_bucket(int(Tf[7])), 2 * N)
    return tuple(x[:Et] for x in Tf[:7]) + (Tf[7], Tf[8][:Et])


def _seedsort(pl, ac, ap, bcn, bp, bo, ns, Cpad):
    """Stable acont-major sort of the seed stream (payload packed into two
    value words) and the per-contig boundaries; rows past ``ns`` sort
    last with all-ones keys."""
    NS = pl.shape[0]
    dev = pl.device
    idx = torch.arange(NS, dtype=torch.int64, device=dev)
    valid = idx < ns
    k = torch.where(valid, (ac.to(torch.int64) << 34) | idx, I64MAX)
    v1 = ((pl.to(torch.int64) << 56) | (ap.to(torch.int64) << 28)
          | bp.to(torch.int64))
    v2 = (bcn.to(torch.int64) << 1) | bo.to(torch.int64)
    o = torch.sort(k).indices
    ks = k[o]
    achi = torch.where(ks == I64MAX, MAX_CONT, ks >> 34)
    bounds = torch.searchsorted(
        achi, torch.arange(Cpad + 1, dtype=torch.int64, device=dev))
    return (ks, torch.where(valid, v1, 0)[o], torch.where(valid, v2, 0)[o],
            bounds)


def _chain_panel(k, v1, v2, off, npan, CAP, amax, bmax, alens,
                 chain_break, chain_min):
    """Chain sweep over one acont-contiguous panel of the sorted packed
    seed stream: a window of CAP rows from ``off`` (fewer at the stream's
    end), its first ``npan`` rows the panel's."""
    ks, v1s, v2s = (x[off:off + CAP] for x in (k, v1, v2))
    seeds = ((v1s >> 56).to(torch.int32),
             ((ks >> 34) & (MAX_CONT - 1)).to(torch.int32),
             ((v1s >> 28) & (MAX_POST - 1)).to(torch.int32),
             (v2s >> 1).to(torch.int32),
             (v1s & (MAX_POST - 1)).to(torch.int32),
             (v2s & 1).to(torch.int32))
    return chain_tubes_dev(seeds, npan, amax, bmax, alens, chain_break,
                           chain_min)


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _run_chain_paneled(seeds6, ns_host, chain_break, chain_min, amax, bmax,
                       alens_pad):
    """Device chain sweep past the monolithic cap: one stable acont-major
    sort, then sweeps over contiguous A-contig ranges (chains never cross an
    A-contig and the sweep's primary key is the A-contig, so the panels'
    concatenation is the monolithic sweep's output).  A panel is the
    largest run of whole contigs within PANEL seeds, swept in a window of
    PANEL rows; a contig with more seeds is a panel of its own, swept in a
    window of its seeds' bucket.  Returns host tube arrays and the tube
    count."""
    cap = min(_pad_bucket(max(ns_host, 1 << 13)), seeds6[0].shape[0])
    k, v1, v2, bounds = _seedsort(*(x[:cap] for x in seeds6), ns_host,
                                  alens_pad.shape[0])
    bounds = bounds.cpu().numpy()
    PANEL = CHAIN_DEV_CAP // 2
    panels = []
    start = 0
    while start < ns_host:
        hi = int(np.searchsorted(bounds, start + PANEL, side="right")) - 1
        end = int(bounds[hi])
        if end <= start:
            # one contig past a panel: its seeds alone
            end = int(bounds[np.searchsorted(bounds, start, side="right")])
        panels.append((start, min(end, ns_host)))
        start = end
    outs = []
    for off, end in panels:
        res = _chain_panel(k, v1, v2, off, end - off,
                           max(PANEL, _pad_bucket(end - off)), amax, bmax,
                           alens_pad, chain_break, chain_min)
        outs.append([_numpy(x) for x in res[:9]])
    if not outs:
        return tuple([np.zeros(0, np.int64)] * 9) + (np.int64(0),)
    cols = tuple(np.concatenate([o[i] for o in outs]) for i in range(9))
    return cols + (np.int64(len(cols[0])),)


def _run_chain(seeds_out, chain_break, chain_min, amax, bmax, alens_by_rank,
               device):
    """The chain sweep over the merge's seeds: monolithic on the device up
    to CHAIN_DEV_CAP seeds (sliced to the seeds' own bucket), else in
    A-contig panels (``_run_chain_paneled``).  Returns (tube arrays, ns,
    plsum)."""
    pl, ac, ap, bcn, bp, bo, ns, _nalive, plsum = seeds_out
    alens_pad = np.zeros(1 << max(3, (len(alens_by_rank) - 1).bit_length()),
                         np.int32)
    alens_pad[:len(alens_by_rank)] = alens_by_rank
    alens_dev = torch.as_tensor(alens_pad, device=device)
    ns_host = int(ns)
    cap = _pad_bucket(max(ns_host, 1 << 13))
    seeds6 = (pl, ac, ap, bcn, bp, bo)
    if cap > CHAIN_DEV_CAP:
        res = _run_chain_paneled(seeds6, ns_host, chain_break, chain_min,
                                 amax, bmax, alens_dev)
    else:
        res = chain_tubes_dev(tuple(x[:cap] for x in seeds6), ns, amax, bmax,
                              alens_dev, chain_break, chain_min)
    return res, ns, plsum


def device_tubes(gdb1, gdb2, alens_by_rank, freq: int = 10,
                 chain_break: int = 2000, chain_min: int = 170,
                 device=None, symmetric: bool = False):
    """TubeBatch of a genome pair from the device pipeline on ``device``
    (default: the card): (tubes, nseeds, plsum); ``Declined`` before any
    upload where the input exceeds a cap (``decline_reason``).
    ``symmetric`` adds the -S flip pass (``_sym_seeds_sum``); genome 1 then
    takes its full two-orientation table, since the flip pass's members
    need its reverse-complement entries.  The seed slots are the
    expansion's own (merge_seeds), where the JAX package caps them at
    N1.  Each genome's ``_prep_genome`` runs under span ``devpipe.prep``
    inside its table's span (``devpipe.gix1``, ``devpipe.gix2``); counter
    ``devpipe.merge_rows`` counts the rows of the two tables that enter
    the merge, padding included, once a call."""
    dev = torch.device("cuda" if device is None else device)
    lens1 = gdb1.contig_lengths()
    lens2 = gdb2.contig_lengths()
    if (reason := decline_reason((lens1, lens2), freq, single_shot=True)):
        raise Declined(reason)
    amax, bmax = int(lens1.max()), int(lens2.max())

    def prep(gdb, lens):
        with prof.span("devpipe.prep", dev):
            return _prep_genome(gdb, lens, dev)
    with prof.span("devpipe.gix1", dev):
        if symmetric:
            T1 = _full_table(gdb1, lens1, dev, prep(gdb1, lens1))
        else:
            # unsorted forward candidates -> count -> tight sorted driver
            # table (one half-size sort)
            bps, coff, clen, invp, nc, N1 = prep(gdb1, lens1)
            C1 = driver_candidates(bps, coff, clen, invp, nc)
            T1 = driver_table(C1, min(_pad_bucket(int(C1[7])), N1))
    with prof.span("devpipe.gix2", dev):
        T2 = _full_table(gdb2, lens2, dev, prep(gdb2, lens2))
    prof.count("devpipe.merge_rows", T1[0].shape[0] + T2[0].shape[0])
    with prof.span("devpipe.merge", dev):
        mout = (_sym_seeds_sum(T1, T2, freq=freq) if symmetric
                else _merge_seeds_sum(T1, T2, freq=freq))
    T1 = T2 = None
    return _tubes_from_seeds(mout, chain_break, chain_min, amax, bmax,
                             alens_by_rank, dev)


def _tubes_from_seeds(mout, chain_break, chain_min, amax, bmax,
                      alens_by_rank, device):
    """The chain sweep over a seed function's outputs: (TubeBatch,
    nseeds, plsum)."""
    with prof.span("devpipe.chain", device):
        res, ns, plsum = _run_chain(mout, chain_break, chain_min, amax, bmax,
                                    alens_by_rank, device)
        cols = [_numpy(x) for x in res[:9]]
    return tube_batch(*cols), int(ns), int(plsum)


def tube_batch(ga, gb, gc, dgmin, dgmax, alow, ahgh, pair, cov):
    """The chain sweep's nine tube columns as a host TubeBatch."""
    return TubeBatch(
        acont=ga.astype(np.int32), bcont=gb.astype(np.int32),
        comp=gc.astype(bool), dgmin=dgmin.astype(np.int32),
        dgmax=dgmax.astype(np.int32), alow=alow.astype(np.int64),
        ahgh=ahgh.astype(np.int64), pairing=pair.astype(np.int64),
        cov=cov.astype(np.int64))


def device_tubes_self(gdb1, alens_by_rank, freq: int = 10,
                      chain_break: int = 2000, chain_min: int = 170,
                      device=None):
    """Self-comparison TubeBatch of one genome from the device pipeline on
    ``device`` (default: the card): its GIX table (gix_arrays), self_seeds
    and the chain sweep.  (tubes, nseeds, plsum); ``Declined`` before any
    upload past a cap (``decline_reason``).  The seed slots
    are the expansion's own (self_seeds), where the JAX package caps them
    at 2 * E1."""
    dev = torch.device("cuda" if device is None else device)
    lens1 = gdb1.contig_lengths()
    if (reason := decline_reason((lens1, lens1), freq, single_shot=True)):
        raise Declined(reason)
    amax = int(lens1.max())

    with prof.span("devpipe.gix1", dev):
        T1 = _full_table(gdb1, lens1, dev)
    with prof.span("devpipe.merge", dev):
        mout = _self_seeds_sum(T1, freq=freq)
    T1 = None
    return _tubes_from_seeds(mout, chain_break, chain_min, amax, amax,
                             alens_by_rank, dev)


def _upload_table(t, device):
    """Host io.gix.GixTable -> device entry arrays of _pad_bucket(t.n) rows
    (zero past t.n) and its mask bytes: (T, maskb)."""
    E = _pad_bucket(t.n)

    def pad32(x):
        a = np.zeros(E, np.int32)
        a[:len(x)] = x
        return torch.as_tensor(a, device=device)
    with prof.span("devpipe.upload", device):
        khi, klo = t.khi_klo()
        w0 = pad32((khi >> np.uint64(32)).astype(np.uint32).view(np.int32))
        w1 = pad32((khi & np.uint64(M32)).astype(np.uint32).view(np.int32))
        w2 = pad32((klo.astype(np.uint32) << 16).view(np.int32))
        T = (w0, w1, w2, pad32(t.cont), pad32(t.post),
             pad32(t.comp.astype(np.int32)), pad32(np.minimum(t.lcp, KMER)),
             torch.tensor(t.n, dtype=torch.int64, device=device), None)
        return T, pad32(t.maskb)


def device_tubes_tables(t1, t2, alens_by_rank, amax: int, bmax: int,
                        freq: int = 10, chain_break: int = 2000,
                        chain_min: int = 170, soft_mask: bool = False,
                        symmetric: bool = False, device=None):
    """TubeBatch from host io.gix.GixTables uploaded to ``device``
    (default: the card): a pair, or a self comparison when ``t2 is t1``;
    ``symmetric`` adds the -S flip pass to a pair.  The route of mask
    bytes, which the lazy routes do not build, and of a self comparison
    with a given table.  (tubes, nseeds, plsum); ``Declined`` before any
    upload past a cap (``decline_reason``).  The seed
    slots are each expansion's own, from its total before the masked or
    flipped seeds are dropped, where the JAX package caps them at twice
    the uploaded table's rows (genome 2's for the flip pass)."""
    dev = torch.device("cuda" if device is None else device)
    selfish = t2 is t1
    if (reason := decline_reason(
            freq=freq, rows=(t1.n,) if selfish else (t1.n, t2.n),
            ncontig=(len(t1.perm), len(t2.perm)), widths=(amax, bmax))):
        raise Declined(reason)

    mk = dict(soft_mask=soft_mask, has_masks=bool(
        t1.maskb.any() or t2.maskb.any() or soft_mask))
    with prof.span("devpipe.gix1", dev):
        T1, mb1 = _upload_table(t1, dev)
    if selfish:
        with prof.span("devpipe.merge", dev):
            mout = _self_seeds_sum(T1, freq=freq, maskb1=mb1, **mk)
    else:
        with prof.span("devpipe.gix2", dev):
            T2, mb2 = _upload_table(t2, dev)
        with prof.span("devpipe.merge", dev):
            mout = (_sym_seeds_sum(T1, T2, freq=freq, maskb1=mb1,
                                   maskb2=mb2, **mk) if symmetric
                    else _merge_seeds_sum(T1, T2, freq=freq, maskb1=mb1,
                                          maskb2=mb2, **mk))
        T2 = mb2 = None
    T1 = mb1 = None
    return _tubes_from_seeds(mout, chain_break, chain_min, amax, bmax,
                             alens_by_rank, dev)


# ---------------------------------------------------------------------------
# Kmer-panel streaming: genomes past the single-shot bases
# ---------------------------------------------------------------------------
#
# Adaptamer groups need a shared prefix of at least 12 bases, so no group
# spans two ranges of the 24-bit (12-base) kmer prefix: each panel's tables
# hold the entries of one prefix range, merge (pairs) or self-merge (self)
# on their own, and append their seeds to one global buffer on the device,
# which the chain sweep takes once.  The result is the single-shot
# pipeline's for any panel count.

PANEL_BLOCK = 1 << 22        # positions a candidate block covers
_HALO_LO, _HALO_HI = 32, 64  # bases a candidate reads before / after it


def _panel_plane(prep, total, P):
    """One genome's panel plane: the panel of each of its entry candidate
    slots, forward slots [0, total) then reverse-complement slots [total,
    2 * total) as ``entry_candidates`` lays them out, and P where a slot
    holds no entry.  Panel p holds the 24-bit kmer prefixes whose
    ``pre24 * P >> 24`` is p (ranges of NPREFIX / P prefixes at a power of
    two).  The plane takes one byte a slot, two bytes a base (int16 at 256
    panels or more): 0.22 GiB a 119 Mbp genome, where the panel tables'
    keys would take 16 bytes an entry.  One pass of ``entry_candidates``
    over the genome in blocks of PANEL_BLOCK positions (each read with the
    bases its candidates reach past it), counted under
    ``devpipe.candidate_blocks``.  Returns (plane, each panel's entries as
    a list of P ints)."""
    bps, coff, clen, invp, nc, _N = prep
    dev = bps.device
    cstart = coff[:nc].to(torch.int64)
    ilast = 4 * bps.shape[0] - 1
    Cpad = coff.shape[0]
    plane = torch.empty(2 * total, dtype=torch.uint8 if P < 256
                        else torch.int16, device=dev)
    counts = torch.zeros(P + 1, dtype=torch.int64, device=dev)
    nblocks = 0
    for i0 in range(0, total, PANEL_BLOCK):
        i1 = min(i0 + PANEL_BLOCK, total)
        i = torch.arange(i0 - _HALO_LO, i1 + _HALO_HI, dtype=torch.int64,
                         device=dev)
        ic = i.clamp(0, ilast)
        bases = ((bps[ic >> 2].to(torch.int32) >> ((ic & 3) << 1)
                  .to(torch.int32)) & 3)
        co = torch.searchsorted(cstart, ic, right=True) - 1
        co = torch.where(ic < total, co, nc + 1)
        coc = co.clamp(0, Cpad - 1)
        inb = (co < nc) & (i >= i0) & (i < i1)
        ok, w0 = entry_candidates(
            bases, (i - coff[coc]).to(torch.int32), clen[coc], invp[coc],
            inb)[:2]
        pid = torch.where(ok, (_u32_64(w0) >> 8) * P >> 24, P).to(
            plane.dtype)
        counts += torch.bincount(pid, minlength=P + 1)
        L = i.shape[0]
        for h in (0, 1):
            plane[h * total + i0:h * total + i1] = \
                pid[h * L + _HALO_LO:h * L + _HALO_LO + i1 - i0]
        nblocks += 1
    prof.count("devpipe.candidate_blocks", nblocks)
    return plane, counts[:P].tolist()


def _plane_table(prep, total, plane, n, panel):
    """The sorted table of one genome's ``n`` entries in ``panel``, from
    its panel plane (``_panel_plane``): the panel's slots, and at each the
    entry ``entry_candidates`` gives there, rebuilt by gathers (the
    contig's rank and the post from the contig tables; each of the kmer's
    ten bytes from the two .bps bytes it straddles, through the kmer-byte
    table of ``_luts``), then one sort on the composite entry key.  The
    table takes the bucket of its entries (``_pad_bucket(n)`` rows, padded
    with all-ones keys): the plane counted them, so none can pass it.
    Returns (w0, w1, w2, cont, post, comp, lcp, n, valid)."""
    bps, coff, clen, invp, nc, _N = prep
    dev = bps.device
    s = torch.nonzero(plane == panel).squeeze(1)
    comp = (s >= total).to(torch.int64)
    i = s - comp * total
    co = torch.searchsorted(coff[:nc].to(torch.int64), i, right=True) - 1
    post = (i - coff[co] + comp * TMER).to(torch.int32)
    cont = invp[co]
    # the kmer's byte t: four bases from i + 4t forward, from i + 8 - 4t
    # (complemented, last base first) reverse; both start i & 3 bases
    # into a .bps byte
    b = bps.to(torch.int32)
    wide = b | (torch.cat([b[1:], torch.zeros_like(b[:1])]) << 8)
    q = (i >> 2) + 2 * comp
    step = 1 - 2 * comp
    shift = (i & 3) << 1
    lut = _luts(dev)[2]
    half = comp << 8
    w = [0, 0, 0]
    for t in range(KMER // 4):
        byte = lut[((wide[q + t * step] >> shift) & 0xFF) + half]
        w[t // 4] = w[t // 4] | (byte << (24 - 8 * (t % 4)))
    ka, kb = pack_entry_keys(torch.ones((), dtype=torch.bool, device=dev),
                             w[0], w[1], w[2], cont, post, comp)
    o = lexsort2(ka, kb)
    E = _pad_bucket(n)
    kas = torch.full((E,), I64MAX, dtype=torch.int64, device=dev)
    kbs = torch.full((E,), I64MAX, dtype=torch.int64, device=dev)
    kas[:n] = ka[o]
    kbs[:n] = kb[o]
    w0s, w1s, w2s, cs, ps, os_ = unpack_entry_keys(kas, kbs)
    vs = (torch.arange(E, device=dev) < n).to(torch.int32)
    return (w0s, w1s, w2s, cs, ps, os_, adjacent_lcp(w0s, w1s, w2s),
            torch.full((), n, dtype=torch.int64, device=dev), vs)


def _append_seeds(g1, g2, goff, out, ns):
    """Pack one panel's first ``ns`` seeds into the global buffers at row
    ``goff``; returns (g1, g2, new offset).  Buffers too short for them
    grow to the seeds' bucket."""
    pl, ac, ap, bcn, bp, bo = (x[:ns].to(torch.int64) for x in out[:6])
    if goff + ns > g1.shape[0]:
        grow = _pad_bucket(goff + ns) - g1.shape[0]
        g1, g2 = (torch.cat([g, torch.zeros(grow, dtype=torch.int64,
                                            device=g.device)])
                  for g in (g1, g2))
    g1[goff:goff + ns] = (pl << 40) | (ac << 28) | ap
    g2[goff:goff + ns] = (bcn << 29) | (bp << 1) | bo
    return g1, g2, goff + ns


def _unpack_seeds(g1, g2):
    """The global buffers -> (plen, acont, apost, bcont, bpost, bcomp)."""
    return ((g1 >> 40).to(torch.int32),
            ((g1 >> 28) & (MAX_CONT - 1)).to(torch.int32),
            (g1 & (MAX_POST - 1)).to(torch.int32),
            ((g2 >> 29) & (MAX_CONT - 1)).to(torch.int32),
            ((g2 >> 1) & (MAX_POST - 1)).to(torch.int32),
            (g2 & 1).to(torch.int32))


def device_tubes_paneled(gdb1, gdb2, alens_by_rank, freq: int = 10,
                         chain_break: int = 2000, chain_min: int = 170,
                         panels: int = 0, verbose: bool = False,
                         device=None):
    """TubeBatch of a genome pair, or of one genome against itself
    (``gdb2`` None or ``gdb1``), by kmer-panel streaming on ``device``
    (default: the card), for genomes past the single-shot bases.  Equal to
    device_tubes / device_tubes_self and the host path.

    ``panels`` 0 takes max(2, 2 * the larger padded genome / 2^24) rounded
    up to a power of two.  Each genome's candidates are built once, under
    span ``devpipe.panel_plane``: its panel plane (``_panel_plane``, one
    byte a candidate slot naming the slot's panel, 2 bytes a base) and
    each panel's exact entry count.  Each panel's table is then gathered
    from the plane and sorted at the bucket of its count
    (``_plane_table``), so no panel passes its table, and its seeds take
    their own total's slots.  The planes are freed before the chain sweep.
    The global seed buffer starts at the JAX package's GCAP, twice genome
    1's bases, and grows to the seeds' bucket where a run needs more.
    ``verbose`` prints the JAX package's line a panel on stderr (its
    ``over`` always 0).  Inside each panel's span ``devpipe.panel``, span
    ``devpipe.panel_scan`` holds the gathers and sorts of the panel's
    tables and ``devpipe.panel_merge`` the merge and the append.
    (tubes, nseeds, plsum); ``Declined`` before any upload past a cap
    (``decline_reason``)."""
    dev = torch.device("cuda" if device is None else device)
    selfish = gdb2 is None or gdb2 is gdb1
    if selfish:
        gdb2 = gdb1
    lens1 = gdb1.contig_lengths()
    lens2 = lens1 if selfish else gdb2.contig_lengths()
    if (reason := decline_reason((lens1, lens2), freq)):
        raise Declined(reason)
    amax, bmax = int(lens1.max()), int(lens2.max())
    tot1, tot2 = int(lens1.sum()), int(lens2.sum())

    with prof.span("devpipe.prep", dev):
        prep1 = _prep_genome(gdb1, lens1, dev)
        prep2 = prep1 if selfish else _prep_genome(gdb2, lens2, dev)
    N1, N2 = prep1[5], prep2[5]
    P = panels
    if P <= 0:
        # a panel's merge stream stays near 16 Mi rows
        P = max(2, -(-(2 * max(N1, N2)) // (1 << 24)))
        P = 1 << (P - 1).bit_length()
    with prof.span("devpipe.panel_plane", dev):
        plane1, cnt1 = _panel_plane(prep1, tot1, P)
        plane2, cnt2 = ((plane1, cnt1) if selfish
                        else _panel_plane(prep2, tot2, P))
    GCAP = _pad_bucket(max(tot1, 1) * 2)
    g1 = torch.zeros(GCAP, dtype=torch.int64, device=dev)
    g2 = torch.zeros(GCAP, dtype=torch.int64, device=dev)
    goff = plsum = 0
    for p in range(P):
        t0 = time.perf_counter()
        with prof.span("devpipe.panel", dev):
            with prof.span("devpipe.panel_scan", dev):
                T1 = _plane_table(prep1, tot1, plane1, cnt1[p], p)
                T2 = None if selfish else _plane_table(prep2, tot2, plane2,
                                                       cnt2[p], p)
            with prof.span("devpipe.panel_merge", dev):
                out = (_self_seeds_sum(T1, 0, freq) if selfish
                       else _merge_seeds_sum(T1, T2, 0, freq))
                T1 = T2 = None
                ns, pls = (int(x)
                           for x in torch.stack([out[6], out[8]]).tolist())
                if verbose:
                    sys.stderr.write(
                        f"devpipe panel {p + 1}/{P}: ns={ns} over=0 "
                        f"{time.perf_counter() - t0:.2f}s\n")
                g1, g2, goff = _append_seeds(g1, g2, goff, out, ns)
        plsum += pls
        out = None
    plane1 = plane2 = None
    nb = min(_pad_bucket(max(goff, 1 << 13)), g1.shape[0])
    seeds = _unpack_seeds(g1[:nb], g2[:nb]) + (goff, 0, plsum)
    g1 = g2 = None
    return _tubes_from_seeds(seeds, chain_break, chain_min, amax, bmax,
                             alens_by_rank, dev)


# ---------------------------------------------------------------------------
# One genome's GIX table for gixmake and the command line
# ---------------------------------------------------------------------------

def build_gix_device(gdb, device=None, masks=None):
    """io.gix.GixTable of one genome (k = KMER, the 8-thread contig
    padding) from ``gix_arrays`` on ``device`` (default: the card); only
    the finished entry rows cross to the host.

    ``masks`` (io.gdb.MaskIval, as io.gix.build_gix takes them) give the
    rows their masked-prefix bytes, from the intervals' coverage on the
    device (``mask_coverage``, ``masked_prefix``); without masks they are
    zero.  A masked build runs under the host build's spans ``gix.build``
    and ``gix.sort``, counts its rows under ``gix.entries``, and counts
    itself under ``gix.card_tables`` (io.gix.build_gix's masked tables
    count under ``gix.host_tables``).

    A genome past a cap of the JAX package's checked before any upload
    (``decline_reason``: total bases, contig count, contig length) is
    built on the host by io.gix.build_gix, with its masks, and a line on
    stderr says so.  The table keeps every entry the device counts (the
    JAX package builds on the host past max(4096, N))."""
    dev = torch.device("cuda" if device is None else device)
    masks = masks or None
    lens = gdb.contig_lengths()
    reason = (decline_reason((lens,), single_shot=True) if len(lens)
              else "no contigs")
    if reason is not None:
        sys.stderr.write(f"fastga_tpu: device GIX build declined "
                         f"({reason}); building the index on the host\n")
        return gixm.build_gix(gdb, masks=masks)
    # a masked build is timed as the host's masked build is
    with prof.span("devpipe.gix" if masks is None else "gix.build", dev):
        bps, coff, clen, invp, nc, N = _prep_genome(gdb, lens, dev)
        cov = None if masks is None else mask_coverage(masks, lens, N, dev)
        T = gix_arrays(bps, coff, clen, invp, nc, cov)
        n = int(T[7])
        w0, w1, w2, cont, post, comp, lcp = (x[:n] for x in T[:7])
        # the host's table columns, finished on the device
        kbytes, post, cont, comp, lcp, prefix_index = (_numpy(x) for x in (
            kmer_bytes(w0, w1, w2), post, cont, comp.to(torch.bool),
            lcp.to(torch.uint8), prefix_counts(w0)))
        maskb = np.zeros(n, np.uint8) if cov is None else _numpy(T[9][:n])
        lens_eff, perm, _ = gixm.contig_order(lens)
        table = gixm.GixTable(
            kmer=KMER, kbytes=kbytes, post=post, cont=cont, comp=comp,
            lcp=lcp, maskb=maskb, prefix_index=prefix_index, perm=perm,
            post_bytes=gixm._bytes_for(int(lens_eff.max())),
            cont_bytes=gixm._bytes_for(2 * len(lens_eff)),
            seqtot=gdb.seqtot + (len(lens_eff) - len(lens)) * KMER)
    if masks is not None:
        prof.count("gix.entries", n)
        prof.count("gix.card_tables")
    return table
