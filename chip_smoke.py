"""Chip smoke test of the PyTorch/CUDA port (fastga_tpu_torch) on one GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (every one runs; any failure exits non-zero before the summary):
1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the nvcc build of the three wave kernels;
2. each kernel against its plain PyTorch version on the card, at the main
   path's widths (wave_chunk at n=512/W=256/chunk=96/k=4 in both
   directions, again on an indel-rich batch whose wide bands overflow
   W=256, and at the W=512 and W=2048 rescue geometries, compared through
   canon_state; wave0 and backtrack_walk bit for bit), with kernel ms,
   plain ms and the floor (the larger of bytes over HBM rate and integer
   operations over the float32 peak);
3. the rescue lanes on the card: BatchAligner items that exhaust their
   wave budget or overflow the W=256 band go to the W=512 lane and must
   equal the exact scalar engine;
4. the main path on the uniform scenario (192 x 50 kb per side), which must
   give 288 alignments covering 9,600,142 bp, with every kernel launched;
5. the main path on the repeat-rich scenario (24 Mbp per side), which must
   give 92,988 alignments covering 187,735,625 bp;
6. exactness: a small mutated pair with an inversion through the card path
   and the port's exact scalar engine (engine="ref") gives equal records;
7. the device busy share of the uniform run under torch.profiler (its
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
# JAX package's own runs in BENCH_r04.json/BENCH_r05.json): alignments and
# bp covered
UNIFORM_EXPECT = (288, 9_600_142)
REPEAT_RICH_EXPECT = (92_988, 187_735_625)


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps, windows=1):
    """Mean ms per call over ``reps`` calls between CUDA events, after
    three warm-up calls; the median over ``windows`` such windows (the
    first timed kernel of a process can run at idle clocks)."""
    import torch
    for _ in range(3):
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


PHASES = {
    "seed pipeline": ("aligner.gix", "aligner.merge", "aligner.chain"),
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


def phase_uniform():
    from fastga_tpu_torch.ops import wave_kernels as wk
    g1, g2 = uniform_gdbs()
    wk.reset_launches()
    ovls, stats, _ = run_main_path("uniform", g1, g2)
    launches = dict(wk.LAUNCHES)
    log(f"  launches[uniform]: {json.dumps(launches)}")
    if (stats["nlive"], stats["cov"]) != UNIFORM_EXPECT:
        raise SystemExit(f"uniform: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {UNIFORM_EXPECT}")
    for name, c in launches.items():
        if c <= 0:
            raise SystemExit(f"uniform: kernel {name} was never launched")
    return launches


def phase_repeatrich(mbp):
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
    from fastga_tpu_torch.ops import wave_kernels as wk
    wk.reset_launches()
    _, stats, _ = run_main_path("repeatrich", g1, g2)
    log(f"  launches[repeatrich]: {json.dumps(wk.LAUNCHES)}")
    if (stats["nlive"], stats["cov"]) != REPEAT_RICH_EXPECT:
        raise SystemExit(f"repeatrich: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {REPEAT_RICH_EXPECT}")


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

    from fastga_tpu_torch.ops import wave_kernels as wk
    from fastga_tpu_torch.ops.wave_ref import AlignSpec
    t0 = time.perf_counter()
    wk.build_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    for name in ("wave_chunk", "wave0", "backtrack_walk"):
        p = os.path.join(os.path.dirname(wk.__file__), "..", "_build",
                         name + ".ptxas.txt")
        if os.path.exists(p):
            for line in open(p).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    kern = phase_kernels(spec)
    phase_rescue()
    launches = phase_uniform()
    phase_repeatrich(REPEAT_RICH_MBP)
    phase_exact()
    phase_profile()

    summary = []
    for name, src, rep in (
            ("wave_chunk", "fastga_tpu_torch/csrc/wave_chunk.cu",
             "fastga_tpu/ops/wave_pallas.py:73"),
            ("wave0", "fastga_tpu_torch/csrc/wave0.cu",
             "fastga_tpu/ops/wave_pallas.py:1071"),
            ("backtrack_walk", "fastga_tpu_torch/csrc/backtrack_walk.cu",
             "fastga_tpu/ops/wave_pallas.py:954")):
        k = kern[name]
        summary.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None,
            equal=k["max_abs_err"] == 0))
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
