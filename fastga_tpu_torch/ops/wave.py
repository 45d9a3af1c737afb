"""Batched O(nd) wavefront aligner: the paired wave program on the card.

Port of fastga_tpu/ops/wave.py (WaveConfig/WaveResult, the paired program
_pair_prog, _pair_k_class, submit_pair/collect_pair, _unpack_result).  A
batch of seed tubes runs as:

1. wave-0 forward (``wave_kernels.wave0``);
2. up to G = k*chunk forward waves (``wave_kernels.wave_chunk``, k from
   the {4, 16, 64} budget classes);
3. the path walk (``wave_kernels.backtrack_walk``);
4. the per-wave path deltas packed into 2 bits with the result fields;
5. the seam: the forward path's wave-0 diagonal;
6-8. wave-0, waves and walk in reverse from the seam;
9. one device-to-host copy of the packed [2*(9+G/16), N] result.

Dispatch is synchronous on the current CUDA stream.  On the CPU the same
program runs with the kernels' plain versions.  Tubes still alive at the
end of the budget are re-run with a larger one, or flagged for the caller
(requeue); alive at the wave cap means fallback to the exact host engine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import prof
from . import wave_kernels as wk
from .wave_ref import AlignSpec

PRED_CAP = 8          # default chunk-budget cap of a first pass
PAIR_CAP_WIDE = 16    # largest fused budget class of an engine with n > 128
PAIR_CAP_NARROW = 64


class WaveConfig(NamedTuple):
    """Engine geometry; the defaults are the JAX engine's main geometry
    (fastga_tpu/models/aligner.py _device_align)."""
    n: int = 512        # tubes per batch
    w: int = 256        # diagonal slots
    chunk: int = 96     # waves per budget unit
    max_chunks: int = 512


class WaveResult(NamedTuple):
    """Per-tube outputs (host numpy [n])."""
    trima: np.ndarray    # trim anti (fwd: aepos+bepos; rev: abpos+bbpos)
    trimx: np.ndarray    # trim A coordinate
    trimd: np.ndarray    # trim diffs
    trim_wave: np.ndarray
    trim_slot: np.ndarray  # trim diagonal
    kbase0: np.ndarray
    nwaves: np.ndarray
    fallback: np.ndarray
    budget: np.ndarray = None   # fallback subset: wave budget exhausted


def pair_k_class(pred: int) -> int:
    """Round a chunk budget up to {4, 16, 64} (fastga_tpu/ops/wave.py
    _pair_k_class)."""
    p = max(1, pred)
    return 4 if p <= 4 else (16 if p <= 16 else 64)


def pack_result(st, d0, D):
    """[9 + G/16, N] int32: trima, trimx, trimd, trim_wave, trim_slot,
    alive, fallback, dif, the wave-0 diagonal d0, then the per-wave path
    deltas (+1, in {0, 1, 2}) 16 to a word."""
    N = d0.shape[0]
    fields = torch.stack([st[10], st[11], st[12], st[13], st[14],
                          st[15].to(torch.int32), st[16].to(torch.int32),
                          st[17]])
    full = torch.cat([d0[None], D], 0).to(torch.int64)
    delta = full[1:] - full[:-1] + 1
    pad = (-delta.shape[0]) % 16
    if pad:
        delta = torch.cat([delta, torch.ones((pad, N), dtype=torch.int64,
                                             device=delta.device)], 0)
    sh = (2 * torch.arange(16, device=delta.device,
                           dtype=torch.int64))[None, :, None]
    packed = (delta.reshape(-1, 16, N) << sh).sum(1)
    return torch.cat([fields, d0[None].to(torch.int32), wk._i32(packed)], 0)


class WaveEngine:
    """Runs batches of tubes through the wave kernels on one device and
    keeps the chunk-budget predictors of the JAX engine."""

    def __init__(self, spec: AlignSpec, cfg: WaveConfig = WaveConfig(),
                 device="cuda"):
        self.spec = spec
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_chunk_calls = 0
        self._chunk_pred = {}
        self._pred_default = {}
        self._logs = None
        self._pool_key = None
        self._small = None          # narrow sibling engine (long lane)
        self._rescue = {}           # tier -> wide-band rescue engine

    # -- device buffers -------------------------------------------------

    def pool_tensor(self, words: np.ndarray) -> torch.Tensor:
        """The packed pool on this engine's device (cached per array)."""
        if self._pool_key is None or self._pool_key[0] is not words:
            with prof.span("wave.upload"):
                t = torch.as_tensor(np.asarray(words, np.uint32)
                                    .view(np.int32)).to(self.device)
            self._pool_key = (words, t)
        return self._pool_key[1]

    def _log_buffers(self, G):
        """(choice, kbase) log buffers of at least G rows, reused across
        batches (the choice log at k=16, n=512, W=256 is 201 MB)."""
        if self.device.type == "cpu":
            return None
        N, W = self.cfg.n, self.cfg.w
        if self._logs is None or self._logs[0].shape[0] < G:
            self._logs = None
            self._logs = (torch.empty((G, N, W), dtype=torch.uint8,
                                      device=self.device),
                          torch.empty((G, N), dtype=torch.int32,
                                      device=self.device))
        return self._logs

    def _cols(self, tubes: dict):
        """[10, N] int32 columns: aw, alen, bw, blen, minp, maxp, dgmin,
        dgmax, anti, valid; padding rows are invalid."""
        N = self.cfg.n
        n = len(tubes["aw"])
        if n > N:
            raise ValueError(f"{n} tubes exceed the batch width {N}")
        big = np.zeros((10, N), np.int32)
        big[1, :] = 1
        big[3, :] = 1
        for j, key in enumerate(("aw", "alen", "bw", "blen")):
            big[j, :n] = tubes[key]
        big[4, :n] = tubes.get("minp", np.full(n, -(1 << 30)))
        big[5, :n] = tubes.get("maxp", np.full(n, 1 << 30))
        big[6, :n] = tubes["dgmin"]
        big[7, :n] = tubes["dgmax"]
        big[8, :n] = tubes["anti"]
        big[9, :n] = 1
        return big

    # -- the programs ---------------------------------------------------

    def _dir_prog(self, pool, cols, direction, G, dgmin=None, dgmax=None):
        targs = tuple(cols[j] for j in range(6))
        dgmin = cols[6] if dgmin is None else dgmin
        dgmax = cols[7] if dgmax is None else dgmax
        st = wk.wave0(pool, targs, dgmin, dgmax, cols[8], cols[9],
                      self.cfg.w, direction)
        st, ch, kb = wk.wave_chunk(pool, targs, st, self.spec, direction, G,
                                   logs=self._log_buffers(G))
        d0, D = wk.backtrack_walk(ch, kb, st[14], st[13])
        return pack_result(st, d0, D)

    def _pair_prog(self, pool, big, k):
        """The paired program over k chunks per direction -> packed
        numpy [2*(9+G/16), N] (one device-to-host copy)."""
        G = k * self.cfg.chunk
        with prof.span("wave.upload"):
            cols = torch.as_tensor(big).to(self.device)
        with prof.span("wave.pair_dispatch"):
            pf = self._dir_prog(pool, cols, +1, G)
            seam = pf[8]
            pr = self._dir_prog(pool, cols, -1, G, seam, seam)
            out = torch.cat([pf, pr], 0)
        self.n_chunk_calls += 2 * k
        with prof.span("wave.collect_fetch"):
            return out.cpu().numpy()

    def _one_dir(self, pool, big, direction, k):
        G = k * self.cfg.chunk
        with prof.span("wave.upload"):
            cols = torch.as_tensor(big).to(self.device)
        with prof.span("wave.chunk_dispatch"):
            out = self._dir_prog(pool, cols, direction, G)
        self.n_chunk_calls += k
        with prof.span("wave.collect_fetch"):
            return out.cpu().numpy()

    # -- predictors -------------------------------------------------------

    @staticmethod
    def _pkey(tubes, mode, n):
        return (mode, n) + tuple(int(np.asarray(tubes[k], np.int64).sum())
                                 for k in ("anti", "aw", "dgmin", "dgmax",
                                           "bw", "blen"))

    def _learn(self, pkey, mode, packed_rows, n, fin=None):
        CW = self.cfg.chunk
        mx = 1
        for p in packed_rows:
            nw = p[7][:n] if fin is None else p[7][:n][fin]
            if nw.size:
                mx = max(mx, int(nw.max()))
        need = max(1, -(-mx // CW))
        if len(self._chunk_pred) > 4096:
            self._chunk_pred.clear()
        self._chunk_pred[pkey] = need
        self._pred_default[mode] = max(need, self._pred_default.get(mode, 2))

    def _unpack_result(self, packed, n, kbase0):
        d0h = packed[8]
        gneed = int(packed[3][:n].max()) + 1 if n else 1
        kp = min((gneed + 15) // 16, packed.shape[0] - 9)
        pk = packed[9:9 + kp].view(np.uint32)
        unsh = (2 * np.arange(16, dtype=np.uint32))
        deltas = ((pk[:, None, :] >> unsh[None, :, None]) & 3) \
            .reshape(-1, self.cfg.n).astype(np.int32)
        deltas -= 1
        diags = np.concatenate(
            [d0h[None], d0h[None] + np.cumsum(deltas, 0, dtype=np.int32)],
            axis=0)
        alive = packed[5] != 0
        fallback = (packed[6] != 0) | alive
        res = WaveResult(
            trima=packed[0][:n], trimx=packed[1][:n], trimd=packed[2][:n],
            trim_wave=packed[3][:n], trim_slot=packed[4][:n],
            kbase0=kbase0[:n], nwaves=packed[7][:n], fallback=fallback[:n],
            budget=alive[:n])
        return res, diags

    # -- public -----------------------------------------------------------

    def run_pair(self, pool, tubes: dict, pred_hint: int = None,
                 pred_cap: int = None, requeue: bool = False):
        """Forward and reverse passes of one batch.  Returns
        ((res_f, diags_f), (res_r, diags_r), requeue mask or None, chunks
        spent per direction).  With ``requeue`` the tubes still alive
        after the first budget are marked instead of re-run."""
        cfg = self.cfg
        n = len(tubes["aw"])
        big = self._cols(tubes)
        pkey = self._pkey(tubes, +2, n)
        pred = self._chunk_pred.get(pkey)
        if pred is None:
            pred = pred_hint if pred_hint is not None \
                else self._pred_default.get(+2, 2)
        cap = pred_cap if pred_cap is not None else PRED_CAP
        pred = max(1, min(int(pred), cap, cfg.max_chunks))
        kcap = min(PAIR_CAP_WIDE if cfg.n > 128 else PAIR_CAP_NARROW,
                   cfg.max_chunks)
        k = pair_k_class(pred)
        if k > kcap:
            k = pred
        req = None
        first = True
        while True:
            if first:
                packed = self._pair_prog(pool, big, k)
            else:
                with prof.span("wave.pair_extend"):
                    packed = self._pair_prog(pool, big, k)
            first = False
            rows_f = 9 + (-(-k * cfg.chunk // 16))
            pf, pr = packed[:rows_f], packed[rows_f:]
            alive = (pf[5][:n] != 0) | (pr[5][:n] != 0)
            if not alive.any() or k >= cfg.max_chunks:
                break
            if requeue:
                req = alive.copy()
                break
            k = min(k * 4, cfg.max_chunks)
        self._learn(pkey, +2, (pf, pr), n, None if req is None else ~req)
        kbase0 = (big[6] + ((big[7] - big[6]) >> 1) - cfg.w // 2)
        return (self._unpack_result(pf, n, kbase0),
                self._unpack_result(pr, n, np.zeros_like(kbase0)), req, k)

    def run_dir(self, pool, tubes: dict, direction: int):
        """One direction of one batch, extended until every tube is done
        or the wave cap is reached.  Returns (WaveResult, diags)."""
        cfg = self.cfg
        n = len(tubes["aw"])
        big = self._cols(tubes)
        pkey = self._pkey(tubes, direction, n)
        pred = self._chunk_pred.get(pkey,
                                    self._pred_default.get(direction, 2))
        k = max(1, min(int(pred), PRED_CAP, cfg.max_chunks))
        while True:
            packed = self._one_dir(pool, big, direction, k)
            if not (packed[5][:n] != 0).any() or k >= cfg.max_chunks:
                break
            k = min(max(2 * k, k + 2), cfg.max_chunks)
        self._learn(pkey, direction, (packed,), n)
        kbase0 = (big[6] + ((big[7] - big[6]) >> 1) - cfg.w // 2)
        return self._unpack_result(packed, n, kbase0)
