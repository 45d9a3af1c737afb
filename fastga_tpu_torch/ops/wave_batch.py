"""Batched Local_Alignment: device wave runs + host replay/stitching.

Port of fastga_tpu/ops/wave_batch.py.  Mirrors Local_Alignment's
orchestration (align.c:1423-1576) over a batch: forward wave from the tube
band, reverse wave from the forward path's origin diagonal, DUB_TRIM
short-pass reruns, and the A-complement reflection, with device batches
per phase and host-side exact trace replay.  Tubes the device flags (band
or wave budget overruns) go to the wide-band rescue lanes (W=512, then
W=2048) and finally to the exact scalar engine.

Batches are dispatched synchronously on the current CUDA stream (the JAX
package's dispatcher thread, fetch threads and warm-up events existed for
a remote TPU and are not carried over); per-queue result order is kept.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from ..utils import prof
from . import wave as wavek
from . import wave_replay as wrep
from .wave_ref import DUB_TRIM, AlignSpec, Path, local_alignment

PRED_CAP_LONG = 64    # chunk-budget cap of the long lane
PASS1_CAP = 4         # first-pass cap of a wide batch with a long lane


@dataclass
class WorkItem:
    akey: object          # key into the sequence pool / lookup
    bkey: object
    dgmin: int
    dgmax: int
    anti: int
    acomp: bool
    alen: int
    blen: int
    selfie: bool = False
    lbord: int = -1
    hbord: int = -1
    waves_hint: int = -1   # expected per-direction wave count (-1 unknown)
    hint_measured: bool = False   # hint from a measured prior tile: only
    # measured hints may route an item to the long lane


def _flip(it: WorkItem, p: Path):
    """A-complement reflection (align.c:1534-1557)."""
    a0 = p.abpos
    p.abpos = it.alen - p.aepos
    p.aepos = it.alen - a0
    b0 = p.bbpos
    p.bbpos = it.blen - p.bepos
    p.bepos = it.blen - b0
    p.trace.reverse()


class BatchAligner:
    """Runs Local_Alignment over batches of work items."""

    _RESCUE_CFGS = (dict(n=32, w=512, chunk=96),
                    dict(n=32, w=2048, chunk=24, max_chunks=2048))

    def __init__(self, spec: AlignSpec, pool_words: np.ndarray,
                 offs: Dict, seq_lookup: Callable[[object], np.ndarray],
                 cfg: wavek.WaveConfig = wavek.WaveConfig(),
                 engine: Optional[wavek.WaveEngine] = None,
                 device="cuda", pool_dev=None):
        self.spec = spec
        self.cfg = cfg
        self.engine = engine if engine is not None \
            else wavek.WaveEngine(spec, cfg, device)
        self._pool_words = pool_words
        self._pool = pool_dev   # the pool on the device, once uploaded
        self.offs = offs
        self.seq = seq_lookup
        self.stats = {"fallbacks": 0, "device_waves": 0, "items": 0,
                      "rerun_fwd": 0, "rerun_rev": 0, "requeues": 0}

    def pool(self):
        if self._pool is None:
            self._pool = self.engine.pool_tensor(self._pool_words)
        return self._pool

    def _rescue_aligner(self, tier: int = 0):
        """Band-overflow lane: a wide-band (W=512, then W=2048) batch
        aligner sharing this aligner's pool; its engine is kept on the
        main engine so repeated runs reuse its buffers."""
        reng = self.engine._rescue.get(tier)
        if reng is None:
            kw = dict(self._RESCUE_CFGS[tier])
            kw.setdefault("max_chunks", max(64, self.cfg.max_chunks))
            reng = wavek.WaveEngine(self.spec, wavek.WaveConfig(**kw),
                                    self.engine.device)
            self.engine._rescue[tier] = reng
        return BatchAligner(self.spec, self._pool_words, self.offs,
                            self.seq, reng.cfg, engine=reng,
                            pool_dev=self.pool())

    def _pick_engine(self, nsel: int):
        """The main engine, or its small-batch sibling when the batch
        fits."""
        s = self.engine._small
        if s is None or nsel > s.cfg.n:
            return self.engine
        return s

    # -- internals -----------------------------------------------------------

    @staticmethod
    def _minp(it: WorkItem, low: int) -> int:
        if it.lbord < 0:
            return 1 if (it.selfie and low >= 0) else -(1 << 30)
        return low - it.lbord

    @staticmethod
    def _maxp(it: WorkItem, hgh: int) -> int:
        if it.hbord < 0:
            return -1 if (it.selfie and hgh <= 0) else (1 << 30)
        return hgh + it.hbord

    def _tubes_of(self, items, dgmin, dgmax, anti):
        offs = self.offs
        return dict(
            aw=np.array([offs[it.akey][0] for it in items], np.int32),
            alen=np.array([it.alen for it in items], np.int32),
            bw=np.array([offs[it.bkey][0] for it in items], np.int32),
            blen=np.array([it.blen for it in items], np.int32),
            dgmin=np.asarray(dgmin, np.int32),
            dgmax=np.asarray(dgmax, np.int32),
            anti=np.asarray(anti, np.int32),
            minp=np.array([self._minp(it, int(lo)) for it, lo in
                           zip(items, dgmin)], np.int32),
            maxp=np.array([self._maxp(it, int(hi)) for it, hi in
                           zip(items, dgmax)], np.int32),
        )

    @staticmethod
    def _start(items):
        """(low, hgh, anti) with hgh clamped so the start point has
        y >= 0 (align.c:1463)."""
        hgh = np.array([it.dgmax for it in items], np.int64)
        anti = np.array([it.anti for it in items], np.int64)
        low = np.array([it.dgmin for it in items], np.int64)
        for i in range(len(items)):
            while ((anti[i] - hgh[i]) >> 1) < 0:
                hgh[i] -= 1
        return low, hgh, anti

    def _aoff(self, it):
        return int(it.alen % self.spec.trace_space if it.acomp else 0)

    def _replay(self, direction, it, anti, diags, res, j, path):
        """Exact trace replay of one tube's device result; False when the
        replay rejects it (the tube then goes to the exact host engine)."""
        rep = wrep.replay_forward if direction > 0 else wrep.replay_reverse
        try:
            rep(self.seq(it.akey), self.seq(it.bkey), int(anti),
                self._aoff(it), diags[:int(res.trim_wave[j]) + 1, j],
                int(res.trima[j]), int(res.trimx[j]), int(res.trimd[j]),
                path, self.spec.trace_space)
        except AssertionError:
            return False
        return True

    def _run_dir(self, items: Sequence[WorkItem], dgmin, dgmax, anti,
                 direction: int):
        """One direction over all items (auto-batched): per item its
        (WaveResult, diags, column) or None when the device flagged it."""
        n = len(items)
        out = [None] * n
        B = self.cfg.n
        for lo in range(0, n, B):
            sel = list(range(lo, min(lo + B, n)))
            eng = self._pick_engine(len(sel))
            its = [items[i] for i in sel]
            tubes = self._tubes_of(its, [dgmin[i] for i in sel],
                                   [dgmax[i] for i in sel],
                                   [anti[i] for i in sel])
            with prof.span("batch.engine_run"):
                res, diags = eng.run_dir(self.pool(), tubes, direction)
            self.stats["device_waves"] += int(res.nwaves.sum())
            for j, i in enumerate(sel):
                if not bool(res.fallback[j]):
                    out[i] = (res, diags, j)
        return out

    def _reruns(self, items, paths, host, idxs, direction):
        """DUB_TRIM short-pass reruns of one direction (align.c:1508-1532)
        for the items ``idxs``."""
        if not idxs:
            return
        its = [items[i] for i in idxs]
        if direction > 0:
            low2 = [paths[i].abpos - paths[i].bbpos for i in idxs]
            anti2 = [paths[i].abpos + paths[i].bbpos for i in idxs]
        else:
            low2 = [paths[i].aepos - paths[i].bepos for i in idxs]
            anti2 = [paths[i].aepos + paths[i].bepos for i in idxs]
        for i in idxs:
            paths[i].trace = []
            if direction < 0:
                paths[i].diffs = 0
        got = self._run_dir(its, low2, low2, anti2, direction)
        for j, i in enumerate(idxs):
            if got[j] is None or not self._replay(
                    direction, items[i], anti2[j], got[j][1], got[j][0],
                    got[j][2], paths[i]):
                host[i] = True
                paths[i] = Path()

    @staticmethod
    def _classify(paths, host, anti, skip=None):
        """DUB_TRIM classes: (forward reruns, reverse reruns, done);
        both-short items collapse to their midpoint."""
        fwdr, revr, done = [], [], []
        for i, p in enumerate(paths):
            if skip is not None and skip[i]:
                continue
            fshort = (p.aepos + p.bepos) - anti[i] < DUB_TRIM
            rshort = anti[i] - (p.abpos + p.bbpos) < DUB_TRIM
            if host[i]:
                done.append(i)
            elif fshort and rshort:
                p.aepos = p.abpos = (p.abpos + p.aepos) >> 1
                p.bepos = p.bbpos = (p.bbpos + p.bepos) >> 1
                p.trace = []
                done.append(i)
            elif fshort:
                fwdr.append(i)
            elif rshort:
                revr.append(i)
            else:
                done.append(i)
        return fwdr, revr, done

    def _host_fallback(self, it: WorkItem) -> Path:
        self.stats["fallbacks"] += 1
        return local_alignment(
            self.spec, self.seq(it.akey), self.seq(it.bkey), it.dgmin,
            it.dgmax, it.anti, it.lbord, it.hbord, selfie=it.selfie,
            acomp=it.acomp, alen=it.alen, blen=it.blen)

    # -- streaming pipeline ---------------------------------------------------

    def run_stream(self, first, more_fn):
        """Local_Alignment over a dynamic item stream.

        ``first``: initial list of (token, WorkItem).  When an item's Path
        is done, ``more_fn(token, path, waves)`` is called and returns an
        iterable of new (token, WorkItem) pairs unlocked by that result.
        Items are batched by expected wave count; the results of a batch
        are delivered in batch order, and a queue has at most one item in
        flight, so per-token results do not depend on the batching.
        """
        eng = self.engine
        B = self.cfg.n
        CW = self.cfg.chunk
        tick = itertools.count()
        ready, long_ready = [], []
        small = eng._small
        SL = small.cfg.n if small is not None else B
        long_T = int((wavek.PRED_CAP * CW - 32) / 1.3)

        def push(ti):
            it = ti[1]
            if small is not None and it.waves_hint > long_T \
                    and it.hint_measured:
                heapq.heappush(long_ready, (it.waves_hint, next(tick), ti))
            else:
                heapq.heappush(ready, (it.waves_hint < 0, it.waves_hint,
                                       next(tick), ti))

        for ti in first:
            push(ti)
        rescue = []

        def deliver(rb, idxs):
            """Complement reflection and result delivery; device-flagged
            items defer to the rescue lanes."""
            items, paths, host = rb["items"], rb["paths"], rb["host"]
            out = []
            for i in idxs:
                if host[i]:
                    rescue.append((rb, i))
                    continue
                if items[i].acomp:
                    _flip(items[i], paths[i])
                out.extend(more_fn(rb["tokens"][i], paths[i],
                                   int(max(rb["fwd_nw"][i],
                                           rb["rev_nw"][i]))))
            for ti in out:
                push(ti)

        def run_batch(batch, long):
            tokens = [t for t, _ in batch]
            items = [it for _, it in batch]
            n = len(items)
            low, hgh, anti = self._start(items)
            tubes = self._tubes_of(items, low, hgh, anti)
            if long:
                e = small
                mh = max(max(it.waves_hint for it in items), 0)
                ph = min(int(mh * 1.3 + 2 * CW) // CW + 1, PRED_CAP_LONG,
                         e.cfg.max_chunks)
                cap, req_ok = PRED_CAP_LONG, False
            else:
                e = eng
                hints = [it.waves_hint for it in items]
                ph, cap = None, None
                if all(h >= 0 for h in hints):
                    ph = int(max(hints) * 1.3 + 32) // CW + 1
                    if small is not None:
                        cap = PASS1_CAP
                req_ok = small is not None
            self.stats["items"] += n
            with prof.span("batch.engine_run"):
                (res_f, diags_f), (res_r, diags_r), req, k = e.run_pair(
                    self.pool(), tubes, pred_hint=ph, pred_cap=cap,
                    requeue=req_ok)
            self.stats["device_waves"] += int(res_f.nwaves.sum()
                                              + res_r.nwaves.sum())
            host = (np.asarray(res_f.fallback[:n])
                    | np.asarray(res_r.fallback[:n])).copy()
            bud = np.asarray(res_f.budget[:n]) | np.asarray(res_r.budget[:n])
            self.stats["fall_budget"] = self.stats.get("fall_budget", 0) \
                + int(bud.sum())
            self.stats["fall_band"] = self.stats.get("fall_band", 0) \
                + int((host & ~bud).sum())
            if req is not None:
                # stragglers: resubmit on the long lane with the spent
                # budget as the floor of the new hint
                host &= ~req
                spent = k * CW
                for i in np.flatnonzero(req):
                    it = items[i]
                    self.stats["requeues"] += 1
                    nit = WorkItem(it.akey, it.bkey, it.dgmin, it.dgmax,
                                   it.anti, it.acomp, it.alen, it.blen,
                                   selfie=it.selfie, lbord=it.lbord,
                                   hbord=it.hbord, waves_hint=spent * 2,
                                   hint_measured=True)
                    heapq.heappush(long_ready, (spent * 2, next(tick),
                                                (tokens[i], nit)))
            paths = [Path() for _ in range(n)]
            skip = host if req is None else (host | req)
            with prof.span("batch.replay"):
                self._replay_pairs(items, anti, host, skip, paths,
                                   res_f, diags_f, res_r, diags_r)
            rb = dict(items=items, paths=paths, host=host, tokens=tokens,
                      fwd_nw=np.asarray(res_f.nwaves[:n]),
                      rev_nw=np.asarray(res_r.nwaves[:n]))
            fwdr, revr, done = self._classify(paths, host, anti, req)
            deliver(rb, done)
            self.stats["rerun_fwd"] += len(fwdr)
            self.stats["rerun_rev"] += len(revr)
            self._reruns(items, paths, host, fwdr, +1)
            self._reruns(items, paths, host, revr, -1)
            deliver(rb, fwdr + revr)

        def flush_rescue():
            batch = rescue[:]
            del rescue[:]
            items = [rb["items"][i] for rb, i in batch]
            self.stats["rescued"] = self.stats.get("rescued", 0) + len(items)
            with prof.span("batch.rescue"):
                ra = self._rescue_aligner(0)
                paths, still = ra.run(items, defer_fallback=True)
                if still.any():
                    ra2 = self._rescue_aligner(1)
                    idx = np.flatnonzero(still)
                    self.stats["rescued2"] = self.stats.get(
                        "rescued2", 0) + len(idx)
                    p2 = ra2.run([items[i] for i in idx])
                    for j, i in enumerate(idx):
                        paths[i] = p2[j]
                    self.stats["fallbacks"] += ra2.stats["fallbacks"]
            out = []
            for (rb, i), p in zip(batch, paths):
                rb["paths"][i] = p
                out.extend(more_fn(rb["tokens"][i], p,
                                   int(max(rb["fwd_nw"][i],
                                           rb["rev_nw"][i]))))
            for ti in out:
                push(ti)

        while ready or long_ready or rescue:
            if len(ready) >= B or (ready and not long_ready):
                k = min(B, len(ready))
                run_batch([heapq.heappop(ready)[3] for _ in range(k)], False)
            elif long_ready:
                k = min(SL, len(long_ready))
                run_batch([heapq.heappop(long_ready)[2] for _ in range(k)],
                          True)
            else:
                flush_rescue()

    def _replay_pairs(self, items, anti, host, skip, paths,
                      res_f, diags_f, res_r, diags_r):
        """Batched native forward+reverse replay; per-item replay where
        the native library is missing or asks for a retry."""
        n = len(items)
        tspace = self.spec.trace_space
        aoffs = np.array([self._aoff(it) for it in items], np.int64)
        out = wrep.replay_pair_batch(
            [self.seq(it.akey) for it in items],
            [self.seq(it.bkey) for it in items],
            anti[:n], aoffs, tspace,
            diags_f, res_f.trim_wave[:n], res_f.trima[:n], res_f.trimx[:n],
            res_f.trimd[:n],
            diags_r, res_r.trim_wave[:n], res_r.trima[:n], res_r.trimx[:n],
            res_r.trimd[:n], skip)
        if out is None:
            singly = [i for i in range(n) if not skip[i]]
        else:
            tr, troff, pstats, rcs = out
            singly = []
            for i in range(n):
                if skip[i]:
                    continue
                rc = int(rcs[i])
                if rc == -3:
                    singly.append(i)
                    continue
                if rc != 0:
                    host[i] = True
                    continue
                p = paths[i]
                (p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs) = (
                    int(v) for v in pstats[i, :5])
                seg = tr[2 * int(troff[i]):2 * int(troff[i + 1])]
                p.trace = list(map(tuple, seg.reshape(-1, 2).tolist()))
        for i in singly:
            if not (self._replay(+1, items[i], anti[i], diags_f, res_f, i,
                                 paths[i])
                    and self._replay(-1, items[i], anti[i], diags_r, res_r,
                                     i, paths[i])):
                host[i] = True
                paths[i] = Path()

    # -- public --------------------------------------------------------------

    def run(self, items: Sequence[WorkItem],
            defer_fallback: bool = False):
        """Synchronous batch; returns paths (or (paths, host-mask) with
        ``defer_fallback``, leaving device-flagged items to the caller
        instead of the scalar engine)."""
        n = len(items)
        self.stats["items"] += n
        paths = [Path() for _ in range(n)]
        if n == 0:
            return (paths, np.zeros(0, bool)) if defer_fallback else paths
        low, hgh, anti = self._start(items)
        host = np.zeros(n, dtype=bool)

        # ---- forward pass; its wave-0 path diagonal is the reverse seam ----
        fwd = self._run_dir(items, low, hgh, anti, +1)
        seam = np.zeros(n, np.int64)
        for i in range(n):
            if fwd[i] is None:
                host[i] = True
            else:
                res, diags, j = fwd[i]
                seam[i] = int(diags[0, j])
        rev = self._run_dir(items, seam, seam, anti, -1)
        with prof.span("batch.replay_fwd"):
            for i in range(n):
                if host[i]:
                    continue
                res, diags, j = fwd[i]
                if not self._replay(+1, items[i], anti[i], diags, res, j,
                                    paths[i]):
                    host[i] = True
                    paths[i] = Path()
        with prof.span("batch.replay_rev"):
            for i in range(n):
                if host[i]:
                    continue
                if rev[i] is None:
                    host[i] = True
                    continue
                res, diags, j = rev[i]
                if not self._replay(-1, items[i], anti[i], diags, res, j,
                                    paths[i]):
                    host[i] = True
                    paths[i] = Path()

        fwdr, revr, _ = self._classify(paths, host, anti)
        self.stats["rerun_fwd"] += len(fwdr)
        self.stats["rerun_rev"] += len(revr)
        self._reruns(items, paths, host, fwdr, +1)
        self._reruns(items, paths, host, revr, -1)

        if not defer_fallback:
            with prof.span("batch.host_fallback"):
                for i in np.flatnonzero(host):
                    # the host path includes the complement flip
                    paths[i] = self._host_fallback(items[i])
        for i in range(n):
            if not host[i] and items[i].acomp:
                _flip(items[i], paths[i])
        if defer_fallback:
            return paths, host
        return paths
