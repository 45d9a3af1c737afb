"""Chip smoke test of the PyTorch/CUDA port (fastga_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (every one runs; any failure exits non-zero before the summary):
1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the nvcc build of the five kernels (csrc/*.cu);
2. each wave kernel against its plain PyTorch version on the card, at the
   main path's widths (wave_chunk at n=512/W=256/chunk=96/k=4 in both
   directions, again on an indel-rich batch whose wide bands overflow
   W=256, and at the W=512 and W=2048 rescue geometries, compared through
   canon_state; wave0 and backtrack_walk bit for bit), with kernel ms,
   plain ms and the floor (the larger of bytes over HBM rate and integer
   operations over the float32 peak);
3. the rescue lanes on the card: BatchAligner items that exhaust their
   wave budget or overflow the W=256 band go to the W=512 lane and must
   equal the exact scalar engine;
4. the main path on the uniform scenario (192 x 50 kb per side) with the
   device seed pipeline: 3,799,831 seeds, 288 tubes, 288 alignments
   covering 9,600,142 bp, a TubeBatch equal to the host seed path's, and
   every kernel launched; then its device_tubes again with the chain in
   A-contig panels (CHAIN_DEV_CAP lowered below its seed bucket), equal to
   the monolithic run;
5. the main path on the repeat-rich scenario (24 Mbp per side): 22,902,602
   seeds, 99,999 tubes, 92,988 alignments covering 187,735,625 bp;
6. merge_path and fused_scan against their plain versions, bit for bit on
   every row, on the inputs the main path gave them (the uniform
   merge_seeds merge, the repeat-rich chain merge, every scan spec either
   run called, in both directions) and at small and odd shapes, with
   kernel ms, plain ms, the byte bound and a yardstick that computes less
   (torch.sort of the first key, torch.cumsum of the channels);
7. exactness: a small mutated pair with an inversion through the card path
   and the port's exact scalar engine (engine="ref") gives equal records;
8. the device busy share of the uniform run under torch.profiler (its
   Chrome trace goes to fastga_tpu_torch/_build/profile/).

The second-to-last line is the per-kernel JSON summary, the last line the
device summary.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer work is counted against the float32 non-tensor-core peak,
# the closest rate the data sheet lists (a lower time bound either way)
OPS_PER_S = 67e12
# integer operations per in-band slot per wave that every slot executes,
# counted from the kernel sources without the snake and the trim test
# (choice, pick, window shift, scan and reductions): a lower bound
OPS_CHUNK_SLOT = 40
OPS_WAVE0_SLOT = 20
OPS_WALK_STEP = 6
REPEAT_RICH_MBP = 24
# fastga_tpu's results on the two seeded inputs (its bench.py scenarios; the
# JAX package's own runs in BENCH_r04.json/BENCH_r05.json, device seed
# path): alignments and bp covered, then seeds and tubes
UNIFORM_EXPECT = (288, 9_600_142)
REPEAT_RICH_EXPECT = (92_988, 187_735_625)
UNIFORM_SEEDS = (3_799_831, 288)
REPEAT_RICH_SEEDS = (22_902_602, 99_999)
KERNELS = ("wave_chunk", "wave0", "backtrack_walk", "merge_path",
           "fused_scan")


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps, windows=1, warm=3):
    """Mean ms per call over ``reps`` calls between CUDA events, after
    ``warm`` warm-up calls; the median over ``windows`` such windows (the
    first timed kernel of a process can run at idle clocks)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def seeded_batch(n, W, seed, wide=False, contigs=8, clen=50_000):
    """n tubes over seeded contig pairs: pool, targs and the wave-0
    columns, as CUDA tensors.  A plain batch pairs synth.uniform_pair
    contigs (1% divergence) with bands of at most +-20 diagonals.  A
    ``wide`` batch pairs 8%-divergent indel-rich contigs and gives every
    odd tube a band of W-5 to W-1 diagonals, which overflows W-4 on the
    first wave unless the WAVE_LAG prune narrows it: the band-overflow
    fallback of the stepper."""
    import torch

    from fastga_tpu_torch import convert
    from fastga_tpu_torch.ops import seqpack
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(seed)
    if wide:
        A = [rng.integers(0, 4, clen).astype(np.uint8)
             for _ in range(contigs)]
        pair = dict(A=A, B=[synth.mutate(rng, a, 0.08, indel_frac=0.4)
                            for a in A])
    else:
        pair = synth.uniform_pair(rng, contigs, clen)
    seqs = {}
    for i in range(contigs):
        seqs[("a", i)] = pair["A"][i]
        seqs[("b", i)] = pair["B"][i]
    pool = seqpack.SeqPool.build(seqs)
    ci = np.arange(n) % contigs
    aw = np.array([pool.offs[("a", c)][0] for c in ci], np.int32)
    alen = np.array([pool.offs[("a", c)][1] for c in ci], np.int32)
    bw = np.array([pool.offs[("b", c)][0] for c in ci], np.int32)
    blen = np.array([pool.offs[("b", c)][1] for c in ci], np.int32)
    anti = (2 * rng.integers(500, clen - 500, n)).astype(np.int32)
    half = min(20, W // 8)
    dgmin = rng.integers(-half, 0, n).astype(np.int32)
    dgmax = rng.integers(1, half, n).astype(np.int32)
    if wide:
        h = rng.integers(W // 2 - 3, W // 2, n)
        odd = np.arange(n) % 2 == 1
        dgmin = np.where(odd, -h, dgmin).astype(np.int32)
        dgmax = np.where(odd, h, dgmax).astype(np.int32)
    dev = torch.device("cuda")
    targs = convert.targs_from_numpy(
        (aw, alen, bw, blen, np.full(n, -(1 << 30), np.int32),
         np.full(n, 1 << 30, np.int32)), dev)
    cols = [torch.as_tensor(a, device=dev) for a in
            (dgmin, dgmax, anti, np.ones(n, np.int32))]
    return convert.pool_from_numpy(pool.words, dev), targs, cols


def _pool_span_bytes(st0, st1):
    """Pool bytes the live lanes span: per tube the A and B extents of the
    anti-diagonal distance covered (plus one 64-base fetch each)."""
    a0 = st0[7].double().cpu().numpy()
    a1 = st1[7].double().cpu().numpy()
    bases = np.abs(a1 - a0) / 2 + 64 + 16
    return float(2 * np.ceil(bases / 16).sum() * 4)


def bound(nbytes, nops):
    """(ms, "bytes" | "operations"): the larger of the two floors."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_wave0(n, W, seed, direction, reps=20):
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, W, seed)
    st_k = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    st_p = wk.wave0_plain(pool, targs, dgmin, dgmax, anti, valid, W,
                          direction)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(st_k, st_p):
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    ms = cuda_ms(lambda: wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W,
                                  direction), reps, windows=5)
    plain_ms = cuda_ms(lambda: wk.wave0_plain(
        pool, targs, dgmin, dgmax, anti, valid, W, direction), 2)
    # bytes: the ten tube columns, the pool words the band snakes span, the
    # state written
    x_span = (st_k[8].double() - anti.double() / 2).abs().cpu().numpy()
    span = float(2 * np.ceil((x_span + W + 80) / 16).sum() * 4)
    nbytes = 10 * n * 4 + span + n * W * 16 + n * 16 * 4
    slots = int((dgmax - dgmin + 1).clamp(min=0).sum())
    bms, by = bound(nbytes, slots * OPS_WAVE0_SLOT)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)


def check_chunk(n, W, chunk, k, seed, direction, spec, wide=False, reps=5):
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    G = k * chunk
    pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, W, seed,
                                                            wide)
    st0 = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    st_k, ch_k, kb_k = wk.wave_chunk(pool, targs, st0, spec, direction, G)
    st_p, ch_p, band_p = wk.chunk_plain(pool, targs, st0, spec, direction,
                                        G)
    torch.cuda.synchronize()
    a = wk.canon_state(st_k, (ch_k, kb_k), W)
    b = wk.canon_state(st_p, (ch_p, band_p[:, :, 2]), W)
    err = 0
    bad = []
    for key in a:
        if not np.array_equal(a[key], b[key]):
            bad.append(key)
            err = max(err, int(np.abs(a[key].astype(np.int64)
                                      - b[key].astype(np.int64)).max()))
    ms = cuda_ms(lambda: wk.wave_chunk(pool, targs, st0, spec, direction, G,
                                       logs=(ch_k, kb_k)), reps, windows=5)
    t0 = time.perf_counter()
    wk.chunk_plain(pool, targs, st0, spec, direction, G)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    live = (st_k[17].long() - st0[17].long()).clamp(min=0)
    nbytes = (2 * (n * W * 16 + n * 16 * 4) + int(live.sum()) * (W + 4)
              + _pool_span_bytes(st0, st_k) + 6 * n * 4)
    # in-band slots of the live waves, from the plain run's band log
    width = (band_p[:, :, 1].long() - band_p[:, :, 0].long() + 1).clamp(
        min=0)
    rows = torch.arange(G, device=width.device)[:, None] < live[None, :]
    slot_waves = int((width * rows).sum())
    bms, by = bound(nbytes, slot_waves * OPS_CHUNK_SLOT)
    # tubes the plain stepper flagged while alive (band overflow or an
    # empty band)
    fell = int((st_p[16] & ~st0[16]).sum())
    return dict(err=err, bad=bad, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, waves_max=int(live.max()),
                waves_mean=float(live.double().mean()), fell=fell)


def check_walk(G, n, W, seed, reps=20):
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    g = torch.Generator(device="cpu").manual_seed(seed)
    ch = torch.randint(0, 4, (G, n, W), generator=g, dtype=torch.uint8)
    kb = torch.randint(-40, 40, (G, n), generator=g, dtype=torch.int32)
    td = torch.randint(-100, 100, (n,), generator=g, dtype=torch.int32)
    tw = torch.randint(0, G + 1, (n,), generator=g, dtype=torch.int32)
    ch, kb, td, tw = (t.cuda() for t in (ch, kb, td, tw))
    d0k, Dk = wk.backtrack_walk(ch, kb, td, tw)
    d0p, Dp = wk.walk_plain(ch, kb, td, tw)
    torch.cuda.synchronize()
    err = max(int((d0k - d0p).abs().max()), int((Dk - Dp).abs().max()))
    ms = cuda_ms(lambda: wk.backtrack_walk(ch, kb, td, tw), reps, windows=5)
    plain_ms = cuda_ms(lambda: wk.walk_plain(ch, kb, td, tw), 1)
    # one log byte and one kbase word read per wave per tube, D written
    nbytes = G * n * (1 + 4 + 4) + 3 * n * 4
    bms, by = bound(nbytes, G * n * OPS_WALK_STEP)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)


def phase_kernels(spec):
    rows = {}
    out = {}
    for d in (+1, -1):
        r = check_wave0(512, 256, 101, d)
        log(f"wave0 dir={d:+d} n=512 W=256: max_abs_err={r['err']} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        rows.setdefault("wave0", []).append(r)
    for (n, W, chunk, k, wide) in ((512, 256, 96, 4, False),
                                   (512, 256, 96, 4, True),
                                   (32, 512, 96, 4, False),
                                   (32, 2048, 24, 4, False)):
        for d in (+1, -1):
            r = check_chunk(n, W, chunk, k, 202, d, spec, wide)
            log(f"wave_chunk dir={d:+d} n={n} W={W} chunk={chunk} k={k}"
                f"{' wide' if wide else ''}: max_abs_err={r['err']} "
                f"{r['bad']} live waves mean {r['waves_mean']:.1f} max "
                f"{r['waves_max']} fell {r['fell']} kernel {r['ms']:.3f} ms "
                f"plain {r['plain_ms']:.1f} ms bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']})")
            if wide and r["fell"] == 0:
                raise SystemExit("wave_chunk: the wide batch overflowed no "
                                 "band; the fallback branch went unchecked")
            rows.setdefault("wave_chunk", []).append(
                dict(r, shape=(n, W, chunk, k, d, wide)))
    r = check_walk(1536, 512, 256, 303)
    log(f"backtrack_walk G=1536 n=512 W=256: max_abs_err={r['err']} "
        f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.1f} ms "
        f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    rows["backtrack_walk"] = [r]
    for name, rs in rows.items():
        err = max(x["err"] for x in rs)
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version (max_abs_err {err}): {rs}")
        main = rs[0]    # the main path's geometry, forward direction
        out[name] = dict(max_abs_err=err, ms=main["ms"],
                         plain_ms=main["plain_ms"],
                         bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"])
    return out


# -- the seed pipeline's kernels ----------------------------------------------


class SeedCapture:
    """Wraps the device pipeline's kernel entry points (and device_tubes)
    for one main-path run, to keep the inputs the path gave the kernels
    (per merge column count and per scan spec, the largest call) and the
    TubeBatch it made.  The wrapped calls launch the kernels as before."""

    def __init__(self):
        self.merge = {}
        self.scan = {}
        self.tubes = None
        self.tubes_args = None

    def __enter__(self):
        from fastga_tpu_torch.ops import device_pipeline as tp
        self._orig = (tp.merge_sorted_streams, tp.fused_scan,
                      tp.device_tubes)
        merge, scan, tubes = self._orig

        def merge_w(opsA, opsB):
            m = opsA[0].shape[0] + opsB[0].shape[0]
            old = self.merge.get(len(opsA))
            if old is None or m > old[0][0].shape[0] + old[1][0].shape[0]:
                self.merge[len(opsA)] = (opsA, opsB)
            return merge(opsA, opsB)

        def scan_w(values, spec, flags=(), reverse=False):
            key = (tuple(spec), len(flags), bool(reverse))
            old = self.scan.get(key)
            if old is None or values[0].shape[0] > old[0][0].shape[0]:
                self.scan[key] = (tuple(values), tuple(flags))
            return scan(values, spec, flags, reverse)

        def tubes_w(*a, **k):
            self.tubes_args = (a, k)
            self.tubes = tubes(*a, **k)
            return self.tubes

        tp.merge_sorted_streams, tp.fused_scan, tp.device_tubes = (
            merge_w, scan_w, tubes_w)
        return self

    def __exit__(self, *exc):
        from fastga_tpu_torch.ops import device_pipeline as tp
        tp.merge_sorted_streams, tp.fused_scan, tp.device_tubes = self._orig


def merge_streams(E1, E2, n1, n2, ncols, seed):
    """Two ascending int64 streams (numpy from a seed, on the card): k1
    sorted, k2 and payloads random, +MAX tails after n1 / n2 live rows."""
    import torch
    rng = np.random.default_rng(seed)
    out = []
    for E, n, parity in ((E1, n1, 0), (E2, n2, 1)):
        cols = [np.sort(rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)),
                (rng.integers(0, 2 ** 61, n, dtype=np.int64) // 2) * 2
                + parity]
        cols += [rng.integers(0, 2 ** 62, n, dtype=np.int64)
                 for _ in range(ncols - 2)]
        pad = np.full(E - n, np.iinfo(np.int64).max)
        out.append(tuple(torch.as_tensor(np.concatenate([c, pad]),
                                         device="cuda") for c in cols))
    return out


def check_merge(opsA, opsB, reps=10):
    """merge_path against its plain version on every row, kernel and plain
    ms, the byte bound (16 bytes per row and column: each input word read
    once, each output word written once) and the yardstick: a stable
    torch.sort of the concatenated first key (it computes less)."""
    import torch

    from fastga_tpu_torch.ops import merge_kernels as mk
    got = mk.merge_sorted_streams(opsA, opsB)
    want = mk.merge_plain(opsA, opsB)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, int((a != b).sum()))
    M = opsA[0].shape[0] + opsB[0].shape[0]
    ms = cuda_ms(lambda: mk.merge_sorted_streams(opsA, opsB), reps,
                 windows=5)
    plain_ms = cuda_ms(lambda: mk.merge_plain(opsA, opsB), 1, warm=1)
    k1 = torch.cat([opsA[0], opsB[0]])
    yard_ms = cuda_ms(lambda: torch.sort(k1, stable=True), 2)
    bms, by = bound(16 * M * len(opsA), 0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, yard_ms=yard_ms,
                shape=(opsA[0].shape[0], opsB[0].shape[0], len(opsA)))


def check_scan(values, spec, flags, reverse, reps=10):
    """fused_scan against its plain version on every row, kernel and plain
    ms, the byte bound (4 bytes per row for each flag, 8 for each channel:
    read once, written once) and the yardstick: torch.cumsum of the stacked
    channels (it computes less)."""
    import torch

    from fastga_tpu_torch.ops import scan_kernels as sk
    got = sk.fused_scan(values, spec, flags, reverse)
    want = sk.fused_scan_plain(values, spec, flags, reverse)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    M = values[0].shape[0]
    ms = cuda_ms(lambda: sk.fused_scan(values, spec, flags, reverse), reps,
                 windows=5)
    plain_ms = cuda_ms(lambda: sk.fused_scan_plain(values, spec, flags,
                                                   reverse), 1, warm=1)
    stack = torch.stack([v.to(torch.int32) for v in values])
    yard_ms = cuda_ms(lambda: torch.cumsum(stack, 1, dtype=torch.int32), 2)
    bms, by = bound(4 * M * (len(flags) + 2 * len(values)), 0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, yard_ms=yard_ms,
                shape=(M, len(values), len(flags), bool(reverse)))


def _spec_str(spec):
    from collections import Counter
    return "+".join(f"{n}x{op}" + ("" if fid is None else f"/f{fid}")
                    for (op, fid), n in Counter(spec).items())


def phase_seed_kernels(cap_uniform, cap_rr):
    """merge_path and fused_scan against their plain versions, bit for bit
    on every row: on the inputs the main path gave them (merge: uniform
    merge_seeds, 4 columns, and the repeat-rich chain merge, 3 columns;
    scan: every spec either run called, in both directions), and at small
    and odd shapes."""
    import torch
    rows = {"merge_path": [], "fused_scan": []}
    # the main path's two merges, then 1 + 1000 rows and a side with no
    # invalid tail, neither a multiple of the tile
    cases = [cap_uniform.merge[4], cap_rr.merge[3],
             merge_streams(1, 1000, 1, 990, 4, 401),
             merge_streams(4096 + 77, 3001, 4096 + 77, 2000, 3, 402)]
    for opsA, opsB in cases:
        r = check_merge(opsA, opsB)
        log(f"merge_path E1={r['shape'][0]} E2={r['shape'][1]} "
            f"cols={r['shape'][2]}: unequal rows {r['err']} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}) yardstick sort "
            f"{r['yard_ms']:.3f} ms")
        rows["merge_path"].append(r)
    # every spec either run called, at the larger of its two main-path
    # sizes (the uniform run's coverage sum is a scan, repeat-rich's not)
    scan = dict(cap_uniform.scan)
    for key, vf in cap_rr.scan.items():
        if key not in scan or vf[0][0].shape[0] > scan[key][0][0].shape[0]:
            scan[key] = vf
    scans = sorted(scan.items(),
                   key=lambda kv: -len(kv[0][0]) * kv[1][0][0].shape[0])
    for (spec, _, reverse), (values, flags) in scans:
        for rev in (reverse, not reverse):
            r = check_scan(values, spec, flags, rev)
            log(f"fused_scan M={r['shape'][0]} {_spec_str(spec)} "
                f"flags={len(flags)} reverse={rev}"
                f"{'' if rev == reverse else ' (mirrored)'}: max_abs_err "
                f"{r['err']} kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.3f} ms bound {r['bound_ms']:.5f} ms "
                f"({r['bound_by']}) yardstick cumsum {r['yard_ms']:.3f} ms")
            rows["fused_scan"].append(r)
    rng = np.random.default_rng(403)
    spec6 = (("sum", None), ("max", 0), ("min", 1), ("last", 1),
             ("sum", 0), ("max", None))
    for M in (1, 4096 * 3 + 37):
        vals = [torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, M)
                                .astype(np.int32), device="cuda")
                for _ in spec6]
        fl = [torch.as_tensor((rng.random(M) < p).astype(np.int32),
                              device="cuda") for p in (0.02, 0.3)]
        for rev in (False, True):
            r = check_scan(vals, spec6, fl, rev)
            log(f"fused_scan M={M} {_spec_str(spec6)} reverse={rev}: "
                f"max_abs_err {r['err']} kernel {r['ms']:.4f} ms")
            rows["fused_scan"].append(r)
    out = {}
    for name, rs in rows.items():
        err = max(x["err"] for x in rs)
        if err != 0:
            raise SystemExit(f"{name}: kernel disagrees with its plain "
                             f"version ({err}): {rs}")
        main = rs[0]
        out[name] = dict(max_abs_err=err, ms=main["ms"],
                         plain_ms=main["plain_ms"],
                         bound_ms=main["bound_ms"],
                         bound_by=main["bound_by"])
    return out


PHASES = {
    "seed pipeline": ("aligner.devpipe", "aligner.gix", "aligner.merge",
                      "aligner.chain"),
    "wave fetch-wait": ("wave.collect_fetch",),
    "wave dispatch": ("wave.pair_dispatch", "wave.chunk_dispatch",
                      "wave.pair_extend"),
    "wave0+upload": ("wave.upload",),
    "trace replay": ("batch.replay", "batch.replay_fwd",
                     "batch.replay_rev"),
    "rescue/fallback": ("batch.rescue", "batch.host_fallback"),
    "dedup": ("aligner.dedup",),
    "pool build": ("aligner.pool_build",),
}


def run_main_path(name, g1, g2):
    """align_genomes on the card with the spans on; prints the records,
    the phase split (fastga_tpu bench.py's span names) and the stats."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.utils import prof
    prof.ENABLED = True
    prof.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ovls, stats = aligner.align_genomes(g1, g2, device="cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rep = prof.report()
    prof.ENABLED = False
    parts = []
    for label, keys in PHASES.items():
        s = sum(rep.get(k, (0, 0))[0] for k in keys)
        parts.append(f"{label} {s:.3f}s")
    aligned = sum(o.aepos - o.abpos for o in ovls)
    log(f"{name}: {len(ovls)} alignments, {aligned:,} bp aligned in "
        f"{dt:.3f} s ({aligned / dt / 1e6:.3f} Mbp/s)")
    log(f"  phases[{name}]: " + " | ".join(parts))
    log(f"  stats[{name}]: " + json.dumps(
        {k: v for k, v in stats.items() if isinstance(v, (int, float))}))
    for k, (s, c) in rep.items():
        log(f"  prof {k}: {s:.3f}s x{c}")
    return ovls, stats, dt


def uniform_gdbs():
    """fastga_tpu bench.py's secondary input: 192 x 50 kb per side."""
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(0xBE7C4)
    pair = synth.uniform_pair(rng, 192, 50_000)
    return synth.to_gdb("a", pair["A"])[0], synth.to_gdb("b", pair["B"])[0]


def check_seeds(name, stats, expect):
    got = (stats.get("nseeds"), stats.get("nhits"))
    if stats.get("seed_pipeline") != "device" or got != expect:
        raise SystemExit(f"{name}: seed pipeline "
                         f"{stats.get('seed_pipeline')} "
                         f"({stats.get('seed_decline', '')}), nseeds/nhits "
                         f"{got}; expected device, {expect}")


def tube_diff(want, got):
    """The TubeBatch fields in which two batches differ."""
    bad = [f for f in vars(want)
           if not np.array_equal(np.asarray(getattr(want, f), np.int64),
                                 np.asarray(getattr(got, f), np.int64))]
    return bad or ([] if want.n == got.n else ["n"])


def check_host_tubes(g1, g2, tubes):
    """The device TubeBatch against the host seed path's (the path of self
    comparison and engine="ref") on the same input, every field."""
    from fastga_tpu_torch.io.gix import build_gix
    from fastga_tpu_torch.ops import chain as chainm, merge as mergem
    t1, t2 = build_gix(g1), build_gix(g2)
    seeds = mergem.adaptamer_seeds(t1, t2, freq=10)
    lens1, lens2 = g1.contig_lengths(), g2.contig_lengths()
    perm = np.asarray(t1.perm)
    alens = np.where(perm < len(lens1),
                     lens1[np.minimum(perm, len(lens1) - 1)], t1.kmer)
    host = chainm.chain_tubes(seeds, int(lens1.max()), int(lens2.max()),
                              alens)
    bad = tube_diff(host, tubes)
    if bad:
        raise SystemExit(f"uniform: device TubeBatch ({tubes.n} tubes) "
                         f"differs from the host path's ({host.n}): {bad}")
    log(f"uniform: device TubeBatch equal to the host path's ({host.n} "
        f"tubes, {seeds.n} seeds)")


def check_paneled(cap):
    """The paneled chain sweep on the card: device_tubes again on the
    uniform run's arguments, with CHAIN_DEV_CAP below its seed bucket
    (4,194,304), so the chain runs in A-contig panels of CHAIN_DEV_CAP / 2
    seeds; the TubeBatch, seed count and seed-length sum must equal the
    monolithic run's."""
    import torch

    from fastga_tpu_torch.ops import device_pipeline as tp
    want_tubes, want_ns, want_pl = cap.tubes
    args, kwargs = cap.tubes_args
    panels = []
    orig = (tp.CHAIN_DEV_CAP, tp._chain_panel)

    def panel(*a):
        panels.append(a[4])     # the panel's seed count
        return orig[1](*a)
    tp.CHAIN_DEV_CAP, tp._chain_panel = 1 << 21, panel
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tubes, ns, pl = tp.device_tubes(*args, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        tp.CHAIN_DEV_CAP, tp._chain_panel = orig
    bad = tube_diff(want_tubes, tubes)
    if len(panels) < 2 or bad or (ns, pl) != (want_ns, want_pl):
        raise SystemExit(f"uniform paneled: {len(panels)} panels, "
                         f"{tubes.n} tubes, {ns} seeds; differs from the "
                         f"monolithic run: {bad}")
    log(f"uniform paneled: chain in {len(panels)} panels of up to "
        f"{(1 << 21) // 2:,} seeds {panels}: TubeBatch, seeds and "
        f"seed-length sum equal to the monolithic run's ({tubes.n} tubes, "
        f"{ns} seeds; device_tubes {dt:.3f} s)")


def phase_uniform():
    from fastga_tpu_torch.ops import cuda_build
    g1, g2 = uniform_gdbs()
    with SeedCapture() as cap:
        cuda_build.reset_launches()
        ovls, stats, _ = run_main_path("uniform", g1, g2)
        launches = dict(cuda_build.LAUNCHES)
    log(f"  launches[uniform]: {json.dumps(launches)}")
    if (stats["nlive"], stats["cov"]) != UNIFORM_EXPECT:
        raise SystemExit(f"uniform: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {UNIFORM_EXPECT}")
    check_seeds("uniform", stats, UNIFORM_SEEDS)
    for name in KERNELS:
        if launches.get(name, 0) <= 0:
            raise SystemExit(f"uniform: kernel {name} was never launched")
    check_host_tubes(g1, g2, cap.tubes[0])
    check_paneled(cap)
    return launches, cap


def phase_repeatrich(mbp):
    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(0xBE7C4)
    t0 = time.perf_counter()
    pair, _ = synth.repeat_rich_pair(
        rng, int(mbp * 1e6), ncontig=max(8, int(mbp)), repeat_frac=0.55,
        copies_per_subfam=12)
    g1, _ = synth.to_gdb("a", pair["A"])
    g2, _ = synth.to_gdb("b", pair["B"])
    log(f"repeatrich: {mbp:g} Mbp/side x{len(pair['A'])} contigs "
        f"(gen {time.perf_counter() - t0:.1f} s)")
    with SeedCapture() as cap:
        cuda_build.reset_launches()
        _, stats, _ = run_main_path("repeatrich", g1, g2)
        launches = dict(cuda_build.LAUNCHES)
    log(f"  launches[repeatrich]: {json.dumps(launches)}")
    if (stats["nlive"], stats["cov"]) != REPEAT_RICH_EXPECT:
        raise SystemExit(f"repeatrich: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {REPEAT_RICH_EXPECT}")
    check_seeds("repeatrich", stats, REPEAT_RICH_SEEDS)
    return launches, cap


def phase_rescue():
    """The rescue lanes on the card: a max_chunks=1 main engine exhausts
    the wave budget of 8%-divergent tubes (fall_budget), and tubes whose
    band spans W-5 or more diagonals overflow W=256 (fall_band); both go
    to the W=512 lane and must equal the exact scalar engine, fields and
    trace."""
    from fastga_tpu_torch.ops import seqpack, wave as wavek, wave_ref
    from fastga_tpu_torch.ops.wave_batch import BatchAligner, WorkItem
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(11)
    A = rng.integers(0, 4, 20000).astype(np.uint8)
    B = synth.mutate(rng, A, 0.08, indel_frac=0.4)
    seqs = {("a", 0, False): A, ("b", 0): B}
    pool = seqpack.SeqPool.build(seqs)
    spec = wave_ref.AlignSpec(0.7)
    cases = (
        (1, [WorkItem(("a", 0, False), ("b", 0), -10, 10, 1000 + 4000 * i,
                      False, len(A), len(B)) for i in range(4)]),
        (64, [WorkItem(("a", 0, False), ("b", 0), -h, h, 1000 + 4000 * i,
                       False, len(A), len(B))
              for i, h in enumerate((125, 126, 127, 125))]))
    stats = {}
    for max_chunks, items in cases:
        ba = BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                          wavek.WaveConfig(n=32, w=256, chunk=96,
                                           max_chunks=max_chunks),
                          device="cuda")
        got = {}
        ba.run_stream([(i, it) for i, it in enumerate(items)],
                      lambda tok, p, waves=-1: got.__setitem__(tok, p) or [])
        for key, v in ba.stats.items():
            stats[key] = stats.get(key, 0) + v
        for i, it in enumerate(items):
            ref = wave_ref.local_alignment(spec, A, B, it.dgmin, it.dgmax,
                                           it.anti, -1, -1)
            p = got[i]
            if ((p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs,
                 [tuple(t) for t in p.trace])
                    != (ref.abpos, ref.bbpos, ref.aepos, ref.bepos,
                        ref.diffs, [tuple(t) for t in ref.trace])):
                raise SystemExit(f"rescue: item {i} (max_chunks "
                                 f"{max_chunks}) differs from the exact "
                                 "engine")
    log(f"rescue: {sum(len(c[1]) for c in cases)} items equal to the exact "
        f"engine; stats {json.dumps(stats)}")
    for key in ("fall_budget", "fall_band", "rescued"):
        if stats.get(key, 0) <= 0:
            raise SystemExit(f"rescue: no tube took the {key} path")


def phase_profile():
    """Device busy time of the uniform main path under torch.profiler
    (CPU + CUDA activities): the sum of device self time over wall."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.utils import prof
    g1, g2 = uniform_gdbs()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fastga_tpu_torch", "_build", "profile")
    with prof.trace(out_dir) as p:
        t0 = time.perf_counter()
        aligner.align_genomes(g1, g2, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0)) or 0
    # device-side events only (kernels, copies): a CPU op's device time
    # repeats that of the kernels it launched
    ka = [e for e in p.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(dev_us(e) for e in ka) / 1e6
    if busy <= 0:
        log("profile[uniform]: device time not measured (the profiler "
            "recorded none)")
        return
    log(f"profile[uniform]: device busy {busy:.4f} s of {wall:.3f} s wall "
        f"(idle share {1 - busy / wall:.4f})")
    for e in sorted(ka, key=dev_us, reverse=True)[:8]:
        log(f"  device {e.key}: {dev_us(e) / 1e3:.3f} ms x{e.count}")


def phase_exact():
    """A mutated 30 kb pair with an inversion: card path == exact engine,
    record for record (coordinates, diffs, strand, trace)."""
    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(0xFA57A)
    a = rng.integers(0, 4, 30_000).astype(np.uint8)
    b = synth.mutate(rng, a, 0.04, indel_frac=0.15)
    b = np.concatenate([b[:8000], (3 - b[8000:16000])[::-1], b[16000:]])
    g1, _ = synth.to_gdb("a", [a])
    g2, _ = synth.to_gdb("b", [b])
    got, _ = aligner.align_genomes(g1, g2, device="cuda")
    ref, _ = aligner.align_genomes(g1, g2, engine="ref")

    def key(o):
        return (o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos,
                o.bcomp, o.diffs, [tuple(t) for t in o.trace])
    if not ref or [key(o) for o in got] != [key(o) for o in ref]:
        raise SystemExit(f"exact: card path gives {len(got)} records, "
                         f"exact engine {len(ref)}; they differ")
    log(f"exact: {len(got)} records equal to the exact engine's")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.ops.wave_ref import AlignSpec
    t0 = time.perf_counter()
    cuda_build.build_kernels()
    log(f"kernel build ({len(KERNELS)} sources): "
        f"{time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        p = os.path.join(cuda_build.BUILD, name + ".ptxas.txt")
        if os.path.exists(p):
            for line in open(p).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    kern = phase_kernels(spec)
    phase_rescue()
    launches, cap_u = phase_uniform()
    launches_rr, cap_rr = phase_repeatrich(REPEAT_RICH_MBP)
    kern.update(phase_seed_kernels(cap_u, cap_rr))
    del cap_u, cap_rr
    phase_exact()
    phase_profile()

    summary = []
    for name, src, rep in (
            ("wave_chunk", "fastga_tpu_torch/csrc/wave_chunk.cu",
             "fastga_tpu/ops/wave_pallas.py:73"),
            ("wave0", "fastga_tpu_torch/csrc/wave0.cu",
             "fastga_tpu/ops/wave_pallas.py:1071"),
            ("backtrack_walk", "fastga_tpu_torch/csrc/backtrack_walk.cu",
             "fastga_tpu/ops/wave_pallas.py:954"),
            ("merge_path", "fastga_tpu_torch/csrc/merge_path.cu",
             "fastga_tpu/ops/merge_pallas.py:204"),
            ("fused_scan", "fastga_tpu_torch/csrc/fused_scan.cu",
             "fastga_tpu/ops/scan_pallas.py:205")):
        k = kern[name]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None,
            equal=k["max_abs_err"] == 0))
    log(f"launches (uniform / repeatrich): " + ", ".join(
        f"{n} {launches[n]} / {launches_rr[n]}" for n in KERNELS))
    for row in summary:
        if not row["equal"] or row["launches"] <= 0 or row["ms"] is None:
            raise SystemExit(f"kernel row incomplete: {row}")
    log(smi)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
