"""FastGA pipeline driver: seeds -> tubes -> wave alignments -> dedup.

Port of fastga_tpu/models/aligner.py.  The tubes come from the device
seed pipeline (ops/device_pipeline.py: GIX tables, adaptamer merge and
chain sweep on the card; host GIX tables uploaded where masks are in play
or a self comparison has its table; streamed in kmer panels past the
single-shot bases); an input its route declines before upload and
the exact engine build them on the host (io/gix, ops/merge, ops/chain),
from the caller's GIX tables where it passes them.  The per-tube
anti-diagonal tiling loop around Local_Alignment
(FastGA.c:3227-3341) feeds batches of tubes to the wave kernels on the
card; then the per-contig-pair redundancy elimination
(FastGA.c:3435-3694) and the deterministic (aread, abpos, bread, comp)
output order.

``engine="torch"`` runs the batched wave engine (ops/wave.py) on
``device``; ``engine="ref"`` the exact scalar oracle (ops/wave_ref.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.alncode import Overlap
from ..io.gdb import GDB
from ..io.gix import GixTable, build_gix, contig_order
from ..ops import chain as chainm
from ..ops import device_pipeline as devp
from ..ops import merge as mergem
from ..ops import wave_ref
from ..ops.constants import KMER
from ..parallel import sharded as shardm
from ..utils import dna, prof

TSPACE = 100
BUCK_ANTI = 128
BOX_FUZZ = 10

ELIMINATED = 0x4

SMALL_N = 64


@dataclass
class FastGAParams:
    """Option defaults per FastGA.c:4451-4507 (post doubling/inversion)."""
    freq: int = 10            # -f adaptamer frequency cutoff
    chain_break: int = 2000   # -s*2 (anti units)
    chain_min: int = 170      # -c*2 (anti units)
    align_min: int = 100      # -l
    align_rate: float = 0.3   # 1 - (-i identity)
    tspace: int = TSPACE
    soft_mask: bool = False   # -M


def resolve_device(device):
    """``None`` means the card; without one, only an explicit "cpu"
    runs (on the kernels' plain versions)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fastga_tpu_torch: no CUDA device; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    return dev


def align_genomes(gdb1: GDB, gdb2: GDB,
                  t1: Optional[GixTable] = None,
                  t2: Optional[GixTable] = None,
                  params: FastGAParams = FastGAParams(),
                  engine: str = "torch", device=None, cfg=None,
                  verbose: bool = False,
                  symmetric: bool = False,
                  mesh=None) -> Tuple[List[Overlap], dict]:
    """Full FastGA comparison; returns (overlaps in output order, stats).

    Pass the same gdb (or table) twice for self-comparison (seeds from
    within-table adaptamer groups; same-contig forward tubes exclude the
    main diagonal).  ``t1``/``t2`` are the genomes' GIX tables when the
    caller has them (a .gix input, masks, ``-T``): their contig order is
    the run's, and host seeding uses them, masks included.  ``symmetric``
    adds the -S second merge pass with genome 2 driving
    (FastGA.c:2410-2470).  ``cfg`` is the main wave engine's WaveConfig
    (default n=512, w=256, chunk=96, max_chunks=512, with an n=64 sibling
    for small and long batches and the W=512/2048 rescue lanes).

    With ``engine="torch"`` the tubes come from the device seed pipeline
    (ops/device_pipeline.py) on ``device``, on the one route the input
    calls for (``_device_seeds``; masks, or a self comparison with ``t1``,
    upload ``t1``/``t2``, else ``build_gix``'s tables).  A self comparison
    ignores ``symmetric``.  An input its route declines before uploading
    anything (a cap of the JAX package, e.g. ``freq`` above 10, or a -S
    pair past 96 Mi bases) is printed on stderr with the reason and seeded
    on the host, as is every run of ``engine="ref"``; once a route has
    uploaded, it finishes on the device, and an error there raises.
    ``stats["seed_pipeline"]`` says which ran, and ``verbose`` prints it
    on stderr.

    ``mesh`` (parallel.sharded.make_mesh or distributed.global_mesh; every
    rank of its group calls align_genomes) seeds a pair or a self
    comparison without masks, ``symmetric`` or a self ``t1`` through the
    sharded pipeline over the ranks (parallel/sharded.py), with
    ``stats["sharded"]`` the number of ranks; each rank then runs the wave
    phase on its own card and returns the same records."""
    with prof.span("aligner.align_genomes"):
        if engine not in ("ref", "torch"):
            raise ValueError(f"unknown wave engine '{engine}' "
                             f"(expected 'ref' or 'torch')")
        dev = resolve_device(device) if engine == "torch" else None
        selfcmp = (t2 is t1 and t1 is not None) or gdb2 is gdb1
        stats = {}
        spec = wave_ref.AlignSpec(1.0 - params.align_rate, params.tspace,
                                  False, tuple(gdb1.freq))
        lens1 = gdb1.contig_lengths()
        lens2 = gdb2.contig_lengths()
        amax = int(lens1.max()) if len(lens1) else 1
        bmax = int(lens2.max()) if len(lens2) else 1
        kmer0 = t1.kmer if t1 is not None else KMER

        def _perm_of(t, lens):
            # a table's contig order, else the host tables' (build_gix's)
            if t is not None:
                return np.asarray(t.perm)
            return np.asarray(contig_order(lens, kmer=kmer0)[1])

        perm1 = _perm_of(t1, lens1)
        perm2 = perm1 if selfcmp else _perm_of(t2, lens2)
        # rank -> length (fake short-fix ranks map to their KMER length)
        alens_by_rank = np.where(perm1 < len(lens1), lens1[np.minimum(
            perm1, len(lens1) - 1)], kmer0)
        has_masks = (params.soft_mask
                     or (t1 is not None and t1.maskb.any())
                     or (t2 is not None and not selfcmp and t2.maskb.any()))

        tubes = None
        if engine == "torch":
            tables = None
            if has_masks or (selfcmp and t1 is not None):
                # whole tables go up: the lazy routes build no mask bytes
                with prof.span("aligner.gix"):
                    if t1 is None:
                        t1 = build_gix(gdb1)
                    if selfcmp:
                        t2 = t1
                    elif t2 is None:
                        t2 = build_gix(gdb2)
                tables = (t1, t2)
            sharded = (mesh is not None and not has_masks and not symmetric
                       and not (selfcmp and t1 is not None))
            dres = _device_seeds(gdb1, None if selfcmp else gdb2, tables,
                                 alens_by_rank, amax, bmax, params, symmetric,
                                 dev, stats, mesh if sharded else None)
            if dres is not None:
                if sharded:
                    stats["sharded"] = mesh.size
                tubes, nseeds, plsum = dres
                stats["nseeds"] = nseeds
                stats["seed_len_avg"] = (plsum / nseeds) if nseeds else 0.0
                stats["seed_pipeline"] = "device"
        if tubes is None:
            with prof.span("aligner.gix"):
                if t1 is None:
                    t1 = build_gix(gdb1)
                if t2 is None:
                    t2 = t1 if selfcmp else build_gix(gdb2)
            with prof.span("aligner.merge"):
                if selfcmp:
                    seeds = mergem.self_adaptamer_seeds(
                        t1, freq=params.freq, soft_mask=params.soft_mask)
                else:
                    seeds = mergem.adaptamer_seeds(
                        t1, t2, freq=params.freq, soft_mask=params.soft_mask)
                    if symmetric:
                        extra = mergem.adaptamer_seeds_flip(
                            t1, t2, freq=params.freq,
                            soft_mask=params.soft_mask)
                        seeds = mergem.SeedBatch(*[
                            np.concatenate([getattr(seeds, f),
                                            getattr(extra, f)])
                            for f in ("plen", "acont", "apost", "bcont",
                                      "bpost", "bcomp")])
            stats["nseeds"] = seeds.n
            stats["seed_len_avg"] = (
                float(seeds.plen.astype(np.float64).mean())
                if seeds.n else 0.0)
            stats["seed_pipeline"] = "host"
            with prof.span("aligner.chain"):
                tubes = chainm.chain_tubes(seeds, amax, bmax, alens_by_rank,
                                           chain_break=params.chain_break,
                                           chain_min=params.chain_min)
        if verbose:
            sys.stderr.write(f"  Seed pipeline: {stats['seed_pipeline']}\n")
        stats["nhits"] = tubes.n

        seq_cache: Dict[Tuple[int, int], np.ndarray] = {}

        def get_a(rank: int, comp: bool) -> np.ndarray:
            key = (rank, comp)
            if key not in seq_cache:
                s = gdb1.get_contig(int(perm1[rank]))
                seq_cache[key] = dna.revcomp(s) if comp else s
            return seq_cache[key]

        def get_b(rank: int) -> np.ndarray:
            key = (rank, None)
            if key not in seq_cache:
                seq_cache[key] = gdb2.get_contig(int(perm2[rank]))
            return seq_cache[key]

        if engine == "torch":
            groups = _device_align(gdb1, gdb2, tubes, perm1, perm2, lens1,
                                   lens2, spec, params, get_a, get_b, stats,
                                   selfcmp, dev, cfg)
        else:
            groups = _ref_align(tubes, perm1, perm2, lens1, lens2, spec,
                                params, get_a, get_b, selfcmp)
        out: List[Overlap] = []
        nlas = 0
        with prof.span("aligner.dedup"):
            for _, ovls in groups:
                nlas += len(ovls)
                out.extend(dedup_group(ovls))
        stats["nlas"] = nlas
        stats["nlive"] = len(out)
        stats["cov"] = sum(o.aepos - o.abpos for o in out)
        # deterministic output order (SORT_MAP + la_merge heap)
        out.sort(key=lambda o: (o.aread, o.abpos, o.bread, o.bcomp))
        return out, stats


def _device_seeds(gdb1, gdb2, tables, alens_by_rank, amax, bmax, params,
                  symmetric, dev, stats, mesh=None):
    """(tubes, nseeds, plsum) from the one device seed route the input
    calls for: ``sharded_tubes`` over the ranks of ``mesh``; host GIX
    ``tables`` (t1, t2; t2 t1 for self) by ``device_tubes_tables``, with
    the -S flip pass for a pair; a -S pair by ``device_tubes(symmetric=
    True)``; kmer panels where a genome is past ``devp._MAX_DEV_BASES``;
    else ``device_tubes``, or for one genome (``gdb2`` None)
    ``device_tubes_self``.  A route's ``devp.Declined`` (raised before any
    upload) goes to stderr and ``stats["seed_decline"]``, and the result is
    None (the host seeds the run); an error on the device propagates."""
    kw = dict(freq=params.freq, chain_break=params.chain_break,
              chain_min=params.chain_min, device=dev)
    pair = gdb2 is not None
    try:
        with prof.span("aligner.devpipe"):
            if mesh is not None:
                return shardm.sharded_tubes(gdb1, gdb2, alens_by_rank, mesh,
                                            **kw)
            if tables is not None:
                return devp.device_tubes_tables(
                    tables[0], tables[1], alens_by_rank, amax, bmax,
                    soft_mask=params.soft_mask, symmetric=symmetric and pair,
                    **kw)
            if symmetric and pair:
                return devp.device_tubes(gdb1, gdb2, alens_by_rank,
                                         symmetric=True, **kw)
            if any(int(g.contig_lengths().sum()) > devp._MAX_DEV_BASES
                   for g in (gdb1, gdb2) if g is not None):
                return devp.device_tubes_paneled(gdb1, gdb2, alens_by_rank,
                                                 **kw)
            if pair:
                return devp.device_tubes(gdb1, gdb2, alens_by_rank, **kw)
            return devp.device_tubes_self(gdb1, alens_by_rank, **kw)
    except devp.Declined as e:
        # never silent: the reference takes any -f / contig count
        sys.stderr.write(f"fastga_tpu: device seed pipeline declined "
                         f"({e.reason}); using host seed pipeline\n")
        stats["seed_decline"] = e.reason
        return None


def _ref_align(tubes, perm1, perm2, lens1, lens2, spec, params, get_a,
               get_b, selfcmp):
    """The tiling loop with the exact scalar engine, per (acont, bcont,
    comp) group in tube order."""
    aln_min = params.align_min - 50
    aln_rate = params.align_rate + 0.05
    groups = []
    i = 0
    n = tubes.n
    while i < n:
        ac, bc = int(tubes.acont[i]), int(tubes.bcont[i])
        cm = bool(tubes.comp[i])
        j = i
        while (j < n and tubes.acont[j] == ac and tubes.bcont[j] == bc
               and bool(tubes.comp[j]) == cm):
            j += 1
        group = list(range(i, j))
        i = j

        ctg1 = int(perm1[ac])
        ctg2 = int(perm2[bc])
        alen = int(lens1[ctg1])
        blen = int(lens2[ctg2])
        mlen = alen + blen
        A = get_a(ac, cm)
        B = get_b(bc)
        self_group = selfcmp and ctg1 == ctg2 and not cm

        ovls: List[Overlap] = []
        alast = -1
        cur_pairing = None
        for ti in group:
            if tubes.pairing[ti] != cur_pairing:
                cur_pairing = tubes.pairing[ti]
                alast = -1
            dgmin = int(tubes.dgmin[ti])
            dgmax = int(tubes.dgmax[ti])
            alow = int(tubes.alow[ti])
            ahgh = int(tubes.ahgh[ti])
            if ahgh <= alast:
                continue  # BLOCKED (FastGA.c:3334)
            if alow < alast:
                alow = alast
            ahgh -= BUCK_ANTI
            while True:
                amid = alow + BUCK_ANTI
                if amid > ahgh:
                    amid = ahgh
                    if amid + dgmin < 0:
                        dgmin = -amid
                        if dgmin > dgmax:
                            break
                if self_group:
                    # exclude the main diagonal (FastGA.c:3245-3262)
                    if dgmin > 0:
                        p = wave_ref.local_alignment(
                            spec, A, B, dgmin, dgmax, amid,
                            dgmin - 1, -1, acomp=cm, alen=alen, blen=blen)
                    elif dgmax < 0:
                        p = wave_ref.local_alignment(
                            spec, A, B, dgmin, dgmax, amid,
                            -1, -(dgmax + 1), acomp=cm, alen=alen,
                            blen=blen)
                    else:
                        p = wave_ref.Path()
                else:
                    p = wave_ref.local_alignment(
                        spec, A, B, dgmin, dgmax, amid, -1, -1,
                        selfie=False, acomp=cm, alen=alen, blen=blen)
                rlen = p.aepos - p.abpos
                if rlen >= aln_min and aln_rate * rlen >= p.diffs:
                    ovls.append(Overlap(
                        aread=ctg1, bread=ctg2,
                        abpos=p.abpos, aepos=p.aepos,
                        bbpos=p.bbpos, bepos=p.bepos,
                        diffs=p.diffs, bcomp=cm,
                        trace=list(p.trace)))
                eant = mlen - (p.abpos + p.bbpos) if cm else p.aepos + p.bepos
                alow = amid if eant <= alow else eant
                if alow >= ahgh:
                    break
            alast = alow
        groups.append(((ac, bc, cm), ovls))
    return groups


# -- redundancy elimination (FastGA.c:3435-3694) -----------------------------


def entwine(op: Overlap, wp: Overlap) -> Tuple[int, int]:
    """Trace-distance between two overlapping paths (FastGA.c:2818-2947).

    Returns (min signed b-distance over shared trace points, where):
    where = A trace point at which the paths meet exactly, else -1.
    """
    where = -1
    y2 = op.bbpos
    b2 = wp.bbpos
    jt = [v for pair in op.trace for v in pair]   # flat (d,b) trace
    kt = [v for pair in wp.trace for v in pair]
    j = op.abpos // TSPACE
    k = wp.abpos // TSPACE
    ac = k * TSPACE

    j = 1 + 2 * (k - j)
    k = 1
    for i in range(1, j, 2):
        y2 += jt[i]

    if j == 1:
        yp = y2 + (jt[j] * (wp.abpos - op.abpos)) // (ac + TSPACE - op.abpos)
    else:
        yp = y2 + (jt[j] * (wp.abpos - ac)) // TSPACE

    num = b2 - yp
    mn = num

    ae = min(op.aepos, wp.aepos)

    ac += TSPACE
    while ac < ae:
        y2 += jt[j]
        b2 += kt[k]
        j += 2
        k += 2
        i = b2 - y2
        if mn < 0 and mn < i:
            mn = 0 if i >= 0 else i
        elif mn > 0 and mn > i:
            mn = 0 if i <= 0 else i
        if i == 0:
            where = ac
        ac += TSPACE

    ac -= TSPACE
    # C indexes one past the trace when ae == ac; the product is 0 there
    jtj = jt[j] if j < len(jt) else 0
    ktk = kt[k] if k < len(kt) else 0
    if ae == op.aepos:
        y2 = op.bepos
        if wp.aepos >= ac:
            b2 += (ktk * (ae - ac)) // TSPACE
        else:
            b2 += (ktk * (ae - ac)) // (wp.aepos - ac)
    else:
        b2 = wp.bepos
        if op.aepos >= ac:
            y2 += (jtj * (ae - ac)) // TSPACE
        else:
            y2 += (jtj * (ae - ac)) // (op.aepos - ac)

    i = b2 - y2
    if mn < 0 and mn < i:
        mn = 0 if i >= 0 else i
    elif mn > 0 and mn > i:
        mn = 0 if i <= 0 else i
    return mn, where


def _dedup_group_native(os: List[Overlap]) -> Optional[List[Overlap]]:
    """C fast path for dedup_group (native/tracerec.c trw_dedup_group);
    None -> use the Python implementation.  ``os`` is abpos-sorted."""
    import ctypes

    from .. import native
    lib = native.get_tracerec()
    if lib is None or not hasattr(lib, "trw_dedup_group"):
        return None
    g = len(os)
    ab = np.array([o.abpos for o in os], np.int64)
    ae = np.array([o.aepos for o in os], np.int64)
    bb = np.array([o.bbpos for o in os], np.int64)
    be = np.array([o.bepos for o in os], np.int64)
    df = np.array([o.diffs for o in os], np.int64)
    troff = np.zeros(g + 1, np.int64)
    parts = []
    for i, o in enumerate(os):
        troff[i + 1] = troff[i] + len(o.trace)
        if o.trace:
            parts.append(np.asarray(o.trace, np.int32).reshape(-1))
    tr = np.concatenate(parts) if parts else np.zeros(0, np.int32)
    flags = np.zeros(g, np.uint8)
    newcap = int(2 * len(tr) + 2 * g + 16)
    newtr = np.empty(newcap, np.int32)
    newoff = np.zeros(g + 1, np.int64)
    I64P = ctypes.POINTER(ctypes.c_int64)
    I32P = ctypes.POINTER(ctypes.c_int32)
    rc = lib.trw_dedup_group(
        g,
        ab.ctypes.data_as(I64P), ae.ctypes.data_as(I64P),
        bb.ctypes.data_as(I64P), be.ctypes.data_as(I64P),
        df.ctypes.data_as(I64P),
        tr.ctypes.data_as(I32P), troff.ctypes.data_as(I64P),
        TSPACE, flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        newtr.ctypes.data_as(I32P), newoff.ctypes.data_as(I64P),
        newcap)
    if rc != 0:
        return None
    out = []
    for i, o in enumerate(os):
        if flags[i]:
            continue
        o.aepos = int(ae[i])
        o.bepos = int(be[i])
        o.diffs = int(df[i])
        seg = newtr[newoff[i]:newoff[i + 1]].reshape(-1, 2)
        o.trace = list(map(tuple, seg.tolist()))
        out.append(o)
    return out


def dedup_group(ovls: List[Overlap]) -> List[Overlap]:
    """Per-(contig pair, strand) redundancy elimination."""
    nlas = len(ovls)
    if nlas == 0:
        return []
    perm = sorted(range(nlas), key=lambda ix: ovls[ix].abpos)
    os = [ovls[ix] for ix in perm]
    native_out = _dedup_group_native(os)
    if native_out is not None:
        return native_out
    flags = [0] * nlas

    # pass 1: identical / shared-endpoint containment (FastGA.c:3441-3491)
    for j in range(nlas - 1, -1, -1):
        op = os[j]
        for k in range(j + 1, nlas):
            wp = os[k]
            if op.aepos <= wp.abpos:
                break
            if flags[k] & ELIMINATED:
                continue
            if op.abpos == wp.abpos and op.bbpos == wp.bbpos:
                if op.aepos == wp.aepos and op.bepos == wp.bepos:
                    # (sic) the reference compares diffs against aepos here
                    if op.diffs < wp.aepos:
                        flags[k] |= ELIMINATED
                        continue
                    else:
                        flags[j] |= ELIMINATED
                        break
                else:
                    if op.aepos > wp.aepos:
                        flags[k] |= ELIMINATED
                        continue
                    else:
                        flags[j] |= ELIMINATED
                        break
            elif op.aepos == wp.aepos and op.bepos == wp.bepos:
                if op.abpos < wp.abpos:
                    flags[k] |= ELIMINATED
                    continue
                else:
                    flags[j] |= ELIMINATED
                    break

    # pass 2: entwine fuse + fuzzy box elimination (FastGA.c:3494-3597)
    for j in range(nlas - 1, -1, -1):
        op = os[j]
        if flags[j] & ELIMINATED:
            continue
        for k in range(j + 1, nlas):
            wp = os[k]
            if op.aepos <= wp.abpos:
                break
            if flags[k] & ELIMINATED:
                continue
            if op.bepos <= wp.bbpos or op.bbpos >= wp.bepos:
                continue
            dist, where = entwine(op, wp)
            if where != -1:
                # fuse at the shared trace point (FastGA.c:3530-3570)
                ocut = (where - op.abpos - 1) // TSPACE + 1
                wcut = (where - wp.abpos - 1) // TSPACE + 1
                ntrace = op.trace[:ocut] + wp.trace[wcut:]
                op.trace = ntrace
                op.diffs = sum(d for d, _ in ntrace)
                op.aepos = wp.aepos
                op.bepos = wp.bepos
                flags[k] |= ELIMINATED
                continue
            if dist != 0:
                if (op.aepos - op.abpos) + BOX_FUZZ >= wp.aepos - wp.abpos:
                    if (wp.aepos <= op.aepos + BOX_FUZZ
                            and wp.bbpos >= op.bbpos - BOX_FUZZ
                            and wp.bepos <= op.bepos + BOX_FUZZ):
                        flags[k] |= ELIMINATED
                        continue
                else:
                    if (op.aepos <= wp.aepos + BOX_FUZZ
                            and op.bbpos >= wp.bbpos - BOX_FUZZ
                            and op.bepos <= wp.bepos + BOX_FUZZ
                            and op.abpos >= wp.abpos - BOX_FUZZ):
                        flags[j] |= ELIMINATED
                        continue

    return [o for o, f in zip(os, flags) if not (f & ELIMINATED)]


# -- device-engine scheduler --------------------------------------------------


def _pool_bucket(gdb1, gdb2) -> int:
    """Pow2 word-count bucket the tube pool for this pair fits in."""
    def _words(ls):
        return int(((ls.astype(np.int64) + 15) // 16 + 5).sum())

    ub = 5 + 2 * _words(gdb1.contig_lengths()) + _words(
        gdb2.contig_lengths())
    return 1 << (max(ub, 1024) - 1).bit_length()


def make_engine(spec, device, cfg=None):
    """The main wave engine with its n=64 sibling (when wider)."""
    from ..ops import wave as wavek
    cfg = cfg if cfg is not None else wavek.WaveConfig()
    eng = wavek.WaveEngine(spec, cfg, device)
    if cfg.n > SMALL_N:
        eng._small = wavek.WaveEngine(
            spec, wavek.WaveConfig(n=SMALL_N, w=cfg.w, chunk=cfg.chunk,
                                   max_chunks=cfg.max_chunks), device)
    return eng


def _device_align(gdb1, gdb2, tubes, perm1, perm2, lens1, lens2, spec,
                  params, get_a, get_b, stats, selfcmp, device, cfg):
    """Run the tube-tiling loop with the batched wave engine.

    The per-(group, pairing) tube sequence is order-dependent (`alast`
    blocking, result-driven tiling); independence across pairings gives
    the batch dimension: each pairing queue has at most one
    Local_Alignment in flight, and the stream batches them."""
    from ..ops import seqpack
    from ..ops.wave_batch import BatchAligner, WorkItem

    n = tubes.n
    queues = {}
    order = []
    for t in range(n):
        key = (int(tubes.acont[t]), int(tubes.bcont[t]), bool(tubes.comp[t]),
               int(tubes.pairing[t]))
        if key not in queues:
            queues[key] = []
            order.append(key)
        queues[key].append(t)

    with prof.span("aligner.pool_build"):
        seqs = {}
        for t in range(n):
            ar, br = int(tubes.acont[t]), int(tubes.bcont[t])
            seqs.setdefault(("a", ar, bool(tubes.comp[t])), None)
            seqs.setdefault(("b", br), None)
        for k in list(seqs):
            seqs[k] = get_a(k[1], k[2]) if k[0] == "a" else get_b(k[1])
        pool = seqpack.SeqPool.build(seqs,
                                     target_words=_pool_bucket(gdb1, gdb2))

    eng = make_engine(spec, device, cfg)
    ba = BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                      eng.cfg, engine=eng)

    class QState:
        __slots__ = ("key", "tubes", "ti", "alast", "dgmin", "dgmax",
                     "alow", "ahgh", "started", "ovls", "hint")

        def __init__(self, key, tube_list):
            self.key = key
            self.tubes = tube_list
            self.ti = -1
            self.alast = -1
            self.started = False
            self.ovls = []
            self.hint = -1

    states = [QState(k, queues[k]) for k in order]
    aln_min = params.align_min - 50
    aln_rate = params.align_rate + 0.05
    have_cov = getattr(tubes, "cov", None) is not None \
        and len(tubes.cov) == tubes.n
    ratio = [0.05]   # EMA of measured waves per anti unit (fallback)
    total_calls = [0]

    def advance_to_next_tube(q):
        """Move to the next unblocked tube; returns False when exhausted."""
        while True:
            q.ti += 1
            if q.ti >= len(q.tubes):
                return False
            t = q.tubes[q.ti]
            q.dgmin = int(tubes.dgmin[t])
            q.dgmax = int(tubes.dgmax[t])
            alow = int(tubes.alow[t])
            ahgh = int(tubes.ahgh[t])
            if ahgh <= q.alast:
                continue  # BLOCKED (FastGA.c:3334)
            if alow < q.alast:
                alow = q.alast
            q.alow = alow
            q.ahgh = ahgh - BUCK_ANTI
            q.started = True
            return True

    def next_item(q):
        """Next Local_Alignment call for this queue, or None if exhausted.
        Implements the do-while tiling including the dgmin clamp."""
        while True:
            if not q.started:
                if not advance_to_next_tube(q):
                    return None
            amid = q.alow + BUCK_ANTI
            if amid > q.ahgh:
                amid = q.ahgh
                if amid + q.dgmin < 0:
                    q.dgmin = -amid
                    if q.dgmin > q.dgmax:
                        q.alast = q.alow
                        q.started = False
                        continue
            return amid

    def first_tile_hint(t, extent):
        """Predicted per-direction wave count of a tube's first tile
        (waves ~ uncovered extent of the chain, plus a floor)."""
        if not have_cov:
            return int(ratio[0] * extent) + 1
        text = max(int(tubes.ahgh[t]) - int(tubes.alow[t]), 1)
        unc = max(text - int(tubes.cov[t]), 0)
        pred = 24 + 0.30 * unc + 0.012 * text
        if extent < text:
            pred *= max(extent / text, 0.2)
        return int(pred) + 1

    def emit(q):
        """Next device item for queue q (self main-diagonal crossings
        resolve to zero-length results inline)."""
        while True:
            amid = next_item(q)
            if amid is None:
                return None
            ar, br, cm, _ = q.key
            ctg1 = int(perm1[ar])
            ctg2 = int(perm2[br])
            alen = int(lens1[ctg1])
            blen = int(lens2[ctg2])
            lbord = hbord = -1
            if selfcmp and ctg1 == ctg2 and not cm:
                if q.dgmin > 0:
                    lbord = q.dgmin - 1
                elif q.dgmax < 0:
                    hbord = -(q.dgmax + 1)
                else:
                    q.alow = int(amid)
                    if q.alow >= q.ahgh:
                        q.alast = q.alow
                        q.started = False
                    continue
            total_calls[0] += 1
            extent = max(int(q.ahgh) + BUCK_ANTI - int(amid), 1)
            t = q.tubes[q.ti]
            hint = q.hint if q.hint >= 0 else first_tile_hint(t, extent)
            item = WorkItem(("a", ar, cm), ("b", br), q.dgmin, q.dgmax,
                            int(amid), cm, alen, blen, lbord=lbord,
                            hbord=hbord, waves_hint=hint,
                            hint_measured=q.hint >= 0)
            return ((q, int(amid), alen, blen, ctg1, ctg2, extent), item)

    def more_fn(token, p, waves=-1):
        q, amid, alen, blen, ctg1, ctg2, extent = token
        q.hint = waves
        if waves > 0:
            ratio[0] = 0.9 * ratio[0] + 0.1 * (waves / extent)
        cm = q.key[2]
        rlen = p.aepos - p.abpos
        if rlen >= aln_min and aln_rate * rlen >= p.diffs:
            q.ovls.append(Overlap(
                aread=ctg1, bread=ctg2, abpos=p.abpos, aepos=p.aepos,
                bbpos=p.bbpos, bepos=p.bepos, diffs=p.diffs, bcomp=cm,
                trace=list(p.trace)))
        eant = (alen + blen) - (p.abpos + p.bbpos) if cm \
            else p.aepos + p.bepos
        q.alow = amid if eant <= q.alow else eant
        if q.alow >= q.ahgh:
            q.alast = q.alow
            q.started = False
        nxt = emit(q)
        return [nxt] if nxt is not None else []

    first = []
    for q in states:
        nxt = emit(q)
        if nxt is not None:
            first.append(nxt)
    chunks0 = eng.n_chunk_calls
    ba.run_stream(first, more_fn)

    stats["device_calls"] = total_calls[0]
    stats.update({f"wave_{k}": v for k, v in ba.stats.items()})
    stats["wave_chunk_calls"] = (
        eng.n_chunk_calls - chunks0
        + (eng._small.n_chunk_calls if eng._small is not None else 0))
    # emit per (acont, bcont, comp) group in tube order for dedup
    merged = {}
    gorder = []
    for q in states:
        gkey = q.key[:3]
        if gkey not in merged:
            merged[gkey] = []
            gorder.append(gkey)
        merged[gkey].extend(q.ovls)
    return [(g, merged[g]) for g in gorder]
