"""Chip smoke test of the PyTorch/CUDA port (fastga_tpu_torch) on one GPU.

    python3 chip_smoke.py                   # every phase, one card
    python3 chip_smoke.py --compare DIR     # kernel times: DIR (an unpacked
                                            # earlier commit) and this
                                            # checkout, in turns
    python3 chip_smoke.py --time-wave DIR   # one tree's kernel times

Phases (every one runs; any failure exits non-zero before the summary):
1. environment: the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the nvcc build of the five kernels (csrc/*.cu), beside
   the host seed path's references of phases 10 and 11 and phase 12's
   host .gix files in worker processes, which end before phase 2, so that
   no phase is timed beside them;
2. each wave kernel against its plain PyTorch version on the card, at the
   main path's widths: wave_chunk at n=512/W=256/G=384 in both directions,
   again on an indel-rich batch whose wide bands overflow W=256, at the
   W=512 and W=2048 rescue geometries, on a batch whose snakes run through
   a 20 kb exact repeat and on one anchored at sequence ends, compared
   through canon_state; the n=64 long lane at G=6,144 (one launch equal to
   16 launches of 384, the first and last equal to the plain stepper);
   wave0 bit for bit at n=512/W=256, on the long lane's batch, at W=512
   and W=2048, on bands of up to W-1 and past W diagonals, on the
   exact-repeat and sequence-end batches and with dead rows (valid = 0,
   some with wide bands), timed beside its launch floor (an empty kernel
   at its grid); backtrack_walk
   bit for bit on a random log and on the logs wave_chunk wrote; with
   kernel ms (wave_chunk also at G=1,536), live waves (max, mean) and us a
   wave, plain ms and the floor (the larger of bytes over HBM rate and
   integer operations over the float32 peak);
3. the rescue lanes on the card: BatchAligner items that exhaust their
   wave budget or overflow the W=256 band go to the W=512 lane and must
   equal the exact scalar engine;
4. the main path on the uniform scenario (192 x 50 kb per side) with the
   device seed pipeline: 3,799,831 seeds, 288 tubes, 288 alignments
   covering 9,600,142 bp, a TubeBatch equal to the host seed path's, and
   every kernel launched; the wave kernels' launches by shape; then its
   device_tubes again with the chain in A-contig panels (CHAIN_DEV_CAP
   lowered below its seed bucket), equal to the monolithic run;
5. the main path on the repeat-rich scenario (24 Mbp per side): 22,902,602
   seeds, 99,999 tubes, 92,988 alignments covering 187,735,625 bp, the
   int64 coverage sum run once on fused_scan, the wave kernels' launches
   by shape, then a second run under torch.profiler (CUDA activity only)
   for each kernel's device time and count, with no cummax kernel;
6. merge_path and fused_scan against their plain versions, bit for bit on
   every row, on the inputs the main path gave them (the uniform
   merge_seeds merge, the repeat-rich chain merge, every scan spec either
   run called, the int64 coverage sum included, in both directions) and at
   odd shapes (the scan tile's edges, more than 10,000 tiles, a misaligned
   view, int64 sums past 2^31), with kernel ms, plain ms, the byte bound
   and a yardstick that computes less (torch.sort of the first key,
   torch.cumsum of the channels);
7. exactness: a small mutated pair with an inversion through the card path
   and the port's exact scalar engine (engine="ref") gives equal records;
8. the device busy share of the uniform run under torch.profiler (its
   Chrome trace goes to fastga_tpu_torch/_build/profile/);
9. the command line (fastga_tpu_torch.cli), in process on the card, with
   its files under fastga_tpu_torch/_build/cli/: `fastga -T1 S.fasta`
   (self seeds on the card) and `alntopaf` of its `-1:` file give
   tests/golden/ref_self.paf (the C reference's PAF) byte for byte, and
   `fastga -1:` on the E/F pair the C
   reference's three records; `fastga -v -1:X.1aln A B` and `fastga -v A B`
   on the uniform and repeat-rich scenarios (written as FASTA) give the
   records of phases 4-5 (read back from the .1aln) and as many PAF lines,
   every kernel launched, and the wall time split into FASTA parse and GDB
   build, alignment and writing (the CLI's -v phase lines); one `python
   -m fastga_tpu_torch.cli.fastga` subprocess on a small mutated pair
   prints the in-process PAF; `gixmake` (the device GIX build) on the
   uniform FASTAs writes the host build's .gix files byte for byte, and
   `fastga A.gix B.gix` gives the uniform records; `fastga -v -M` on the
   repeat-rich FASTAs with the repeats in lower case and `fastga -v -S` on
   the upper-case ones seed on the card (every kernel launched, a PAF line
   a record) with the wall time split;
10. the self and kmer-panel seed routes: align_genomes(A, A) on the
   repeat-rich A genome takes device_tubes_self (its expansion past the
   JAX package's seed cap, its chain in A-contig panels) with every kernel
   launched and the host seed path's TubeBatch, seeds and seed-length sum
   (computed in phase 1's workers);
   device_tubes_paneled(panels=4) on the uniform and repeat-rich pairs and
   on A as self equals phases 4-5 and the self run; the uniform pair at
   2,560 x 50 kb (128 Mbp a side, past _MAX_DEV_BASES) goes through
   device_tubes_paneled alone, with every kernel
   launched and the TubeBatch of a single-shot device_tubes (its
   _MAX_DEV_BASES raised for that one call; at 96 Mbp if 128 Mbp does not
   fit on the card); each route's peak device memory; then merge_path
   and fused_scan against their plain versions, bit for bit, on the
   largest input of each column count and scan spec these routes gave
   them, with kernel ms, plain ms and the byte bound;
11. masked tables and -S: the repeat-rich pair with its repeat intervals
   as masks (the shape of a RepeatMasker annotation), through
   device_tubes_tables with hard masks (the main path's 22,902,602 seeds
   and 99,999 tubes: a mask byte is at most KMER, below KMER + 1), with
   -M, with -S -M and as a masked self run, and through
   device_tubes(symmetric=True): each TubeBatch, seed count and
   seed-length sum equal to the host seed path's (build_gix with the
   masks, the host seed functions, chain_tubes: computed in phase 1's
   workers), each seed expansion's total before compaction against its
   slots, its kept seeds and alive driving rows; align_genomes with -M
   and with -S on
   the card (the route taken, the host path's seeds and tubes, every
   kernel launched); then merge_path and fused_scan against their plain
   versions, bit for bit, on the largest input of each column count and
   scan spec these routes gave them, with kernel ms, plain ms and the
   byte bound;
12. past the caps and the tools: where the JAX package sweeps the chain on
   the host or declines after upload, the port stays on the card.  On the
   repeat-rich pair with CHAIN_DEV_CAP below the seeds' bucket (the chain
   in A-contig panels), and again with CHAIN_DEV_CAP so low that the
   larger A contigs' seeds pass a chain panel (each swept in a window of
   its own bucket) and the bucket passes 6 x CHAIN_DEV_CAP: phase 5's
   TubeBatch from device_tubes inside align_genomes and phase 5's records,
   the chain's time beside the monolithic chain's; the uniform pair with a
   poly-A contig in B, whose GIX entries pass its padded bases (the JAX
   entry cap): build_gix_device equal to build_gix, and align_genomes on
   the card with phase 4's seeds and records; the uniform pair through the
   paneled route with its panel planes built in blocks of 2^20 positions
   (every panel table at its entries' bucket): phase 4's seeds and
   records.  Then the genome,
   index and annotation tools
   as `python -m fastga_tpu_torch.cli.<tool>` subprocesses on the
   repeat-rich FASTAs of phase 9 (repeats in lower case) under
   fastga_tpu_torch/_build/cli/tools/: fatogdb then gdbtofa give back
   each contig's sequence and case; gdbstat and gdbshow -h the contig
   count and bases; gdbshow a range equal to the FASTA's slice; gixmake
   on the card, then gixshow k-mers equal to the sequence at their
   position and orientation; gixcp, gixmv and gixrm byte-equal files and
   none left behind; gixxfer's usage; the repeat intervals as BED through
   bedtoano and back through anotobed, anostat and anoshow; fastks A.fa
   B.fa (indices built on the card) printing the histogram of the port's
   fastks on .gix files of the host build_gix (a worker process of phase
   1), each tool's wall time logged with the card's line.
13. the alignment tools and the ONEaln library (fastga_tpu_torch.cli:
   alnchain, alnplot, alnshow, alntopsl, alnreset, oneview, paftoaln,
   paftopsl; fastga_tpu_torch.api), each tool's main in process, under
   fastga_tpu_torch/_build/cli/aln/: (a) tests/test_alnchain.py's
   rearranged pair through `fastga -1:` on the card (every kernel
   launched; the records of `fastga -Eref`), then alnchain with four
   option sets, alntopaf -x then paftoaln, paftopsl and alnplot with three
   argument sets equal to the C goldens (golden/alnchain.json,
   paftoaln.json, paftopsl.txt, plot_*.eps) and alntopsl to the PAF route;
   on phase 9's E/F .1aln alnshow with six argument sets and alntopsl
   equal to golden/ref_show_*.txt and ref_psl.txt, oneview ASCII <->
   binary and alnreset keeping every data line; AlnReader on
   golden/onealn/apigold.1aln equal to onealn/oracle.json; (b) on phase
   9's repeat-rich .1aln (92,988 records): AlnReader's CIGAR and CS tag of
   the first 1,000 records consuming the records' spans, alnchain (every
   kept record an input record), alnplot (one EPS segment a record past
   its filter) and alnshow @1 (one line a record of scaffold 1), each
   tool's wall time logged with the card's line.

14. the sharded seed route (fastga_tpu_torch.parallel), every run on the
   one card: (a) a one-rank NCCL group in this process: sharded_tubes on
   the repeat-rich pair gives phase 5's TubeBatch (22,902,602 seeds), on A
   as self the host path's self TubeBatch (54,119,834 seeds, phase 10's),
   and align_genomes(mesh=) phase 5's records with stats["sharded"] == 1
   and every kernel launched; (b) two gloo ranks sharing the card
   (spawned processes, distributed.init): the repeat-rich pair through
   sharded_tubes and align_genomes(mesh=) on each rank, phase 5's
   TubeBatch and records, each rank's peak device memory and times; (c)
   four gloo ranks: the uniform pair, phase 4's TubeBatch and records, and
   mesh.py's three steps at __graft_entry__.py's shapes against one rank's
   computation; (d) merge_path and fused_scan against their plain
   versions, bit for bit, on the largest input of each column count and
   scan spec (a) gave them, with kernel ms, plain ms and the byte bound.
   No run across several cards is made: NCCL between cards and the
   exchange's cost over NVLink stay unmeasured.

The second-to-last line is the per-kernel JSON summary (launches: the
uniform main path's plus phase 14 (a)'s align_genomes(mesh=)), the last
line the device summary.
"""

import contextlib
import hashlib
import io
import json
import os
import re
import shutil
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
HERE = os.path.dirname(os.path.abspath(__file__))
CLI_DIR = os.path.join(HERE, "fastga_tpu_torch", "_build", "cli")
# the C reference's records of the E/F pair (tests/test_e2e.py)
EF_RECORDS = [(0, 0, 10025, 0, 0, 10000, False, 504),
              (0, 10025, 20008, 0, 9988, 19988, True, 488),
              (0, 20008, 30000, 0, 20000, 29988, False, 491)]


def log(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


def cuda_ms(fn, reps, windows=1, warm=3, queued=True):
    """Mean ms per call over ``reps`` calls between CUDA events, after
    ``warm`` warm-up calls; the median over ``windows`` such windows (the
    first timed kernel of a process can run at idle clocks).  ``queued``:
    a spin kernel (about 1 ms a call) holds the card before the first event
    while the host queues the calls, so the events time the calls back to
    back on the card and not the host's launch work between them (which
    exceeds a small kernel's time)."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(2_000_000 * reps)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def dev_us(e):
    """A profiler event's own device time, us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0)) or 0


def _edge_pair(rng, n, kind):
    """Pool words, (aw, alen, bw, blen) and anti for the exact-repeat and
    sequence-end batches.  B is A with 1% substitutions and no indels, so
    x and y stay aligned.  ``exact``: B[10,000:30,000) copies A exactly and
    the tubes are anchored 100-2,000 bases before or after that stretch,
    so one wave's snake runs up to 20,000 bases, past the kernel's
    8,192-base sequence window.  ``ends``: A sits at pool word 0 and B ends
    at the pool's last word (no guard words), and the tubes are anchored
    within 64 bases of a sequence's start or end, so fetches clamp at both
    ends of the pool."""
    from fastga_tpu_torch.ops import seqpack
    L = 40_000 if kind == "exact" else 20_000
    A = rng.integers(0, 4, L).astype(np.uint8)
    B = A.copy()
    sub = rng.random(L) < 0.01
    if kind == "exact":
        sub[10_000:30_000] = False
    B[sub] = (B[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    wa, wb = seqpack.pack_u32(A), seqpack.pack_u32(B)
    side = np.arange(n) % 2 == 0
    if kind == "exact":
        x0 = np.where(side, rng.integers(8_000, 9_900, n),
                      rng.integers(30_100, 32_000, n))
    else:
        x0 = np.where(side, rng.integers(10, 64, n),
                      rng.integers(L - 64, L - 10, n))
    cols = [np.full(n, v, np.int32) for v in (0, L, len(wa), L)]
    return np.concatenate([wa, wb]), cols, (2 * x0).astype(np.int32)


def seeded_batch(n, W, seed, kind="plain"):
    """n tubes over seeded sequence pairs: pool, targs and the wave-0
    columns, as CUDA tensors.  ``plain`` pairs synth.uniform_pair contigs
    (8 x 50 kb, 1% divergence) with bands of at most +-20 diagonals;
    ``long`` does the same over 4 x 700 kb contigs, so tubes live for
    thousands of waves (the n=64 long lane's budget, G = 6,144).  ``wide``
    pairs 8%-divergent indel-rich contigs and gives every odd tube a band
    of W-5 to W-1 diagonals, which overflows W-4 on the first wave unless
    the WAVE_LAG prune narrows it: the band-overflow fallback of the
    stepper.  ``exact`` and ``ends``: see _edge_pair."""
    import torch

    from fastga_tpu_torch import convert
    from fastga_tpu_torch.ops import seqpack
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(seed)
    if kind in ("exact", "ends"):
        words, (aw, alen, bw, blen), anti = _edge_pair(rng, n, kind)
    else:
        contigs, clen = (4, 700_000) if kind == "long" else (8, 50_000)
        if kind == "wide":
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
        words = pool.words
        ci = np.arange(n) % contigs
        aw = np.array([pool.offs[("a", c)][0] for c in ci], np.int32)
        alen = np.array([pool.offs[("a", c)][1] for c in ci], np.int32)
        bw = np.array([pool.offs[("b", c)][0] for c in ci], np.int32)
        blen = np.array([pool.offs[("b", c)][1] for c in ci], np.int32)
        anti = (2 * rng.integers(500, clen - 500, n)).astype(np.int32)
    half = min(20, W // 8)
    dgmin = rng.integers(-half, 0, n).astype(np.int32)
    dgmax = rng.integers(1, half, n).astype(np.int32)
    if kind == "wide":
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
    return convert.pool_from_numpy(words, dev), targs, cols


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


def check_wave0(n, W, seed, direction, kind="plain", widen=0, dead=0,
                timed=False, reps=50):
    """wave0 against wave0_plain, bit for bit, on a seeded batch (``widen``
    moves each tube's dgmin down and dgmax up by that much: bands wider
    than W; ``dead``: valid = 0 on every dead-th tube from the first, dead
    rows).  ``timed``: kernel ms (queued events), the same events unqueued
    (the host's launch work), the launch floor (an empty kernel at wave0's
    grid), plain ms and the bound."""
    import ctypes

    import torch

    from fastga_tpu_torch.ops import cuda_build, wave_kernels as wk
    pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, W, seed, kind)
    dgmin, dgmax = dgmin - widen, dgmax + widen
    if dead:
        valid = valid.clone()
        valid[::dead] = 0
    st_k = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    st_p = wk.wave0_plain(pool, targs, dgmin, dgmax, anti, valid, W,
                          direction)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(st_k, st_p):
        if not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()))
    r = dict(err=err, ms=None, plain_ms=None, bound_ms=None, bound_by=None)
    if not timed:
        return r

    def call():
        return wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    r["ms"] = cuda_ms(call, reps, windows=5)
    r["call_ms"] = cuda_ms(call, reps, windows=5, queued=False)
    lib = cuda_build.build_kernels()["wave0"]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    r["floor_ms"] = cuda_ms(lambda: lib.wave0_floor_launch(
        ctypes.c_int(n), ctypes.c_int(W), stream), reps, windows=5)
    r["plain_ms"] = cuda_ms(lambda: wk.wave0_plain(
        pool, targs, dgmin, dgmax, anti, valid, W, direction), 2)
    # bytes: the eight tube columns read, the pool words the band snakes
    # span, the state written
    x_span = (st_k[8].double() - anti.double() / 2).abs().cpu().numpy()
    span = float(2 * np.ceil((x_span + W + 80) / 16).sum() * 4)
    nbytes = 8 * n * 4 + span + n * W * 16 + n * 16 * 4
    slots = int((dgmax - dgmin + 1).clamp(min=0).sum())
    r["bound_ms"], r["bound_by"] = bound(nbytes, slots * OPS_WAVE0_SLOT)
    return r


def canon_diff(a, b):
    """(max abs difference, keys that differ) of two canon_state dicts."""
    err, bad = 0, []
    for key in a:
        if not np.array_equal(a[key], b[key]):
            bad.append(key)
            err = max(err, int(np.abs(a[key].astype(np.int64)
                                      - b[key].astype(np.int64)).max()))
    return err, bad


def rel_dif(st, st_in):
    """``st`` with dif counted from ``st_in`` (canon_state masks the log
    rows of a run that starts past wave 0 by that count)."""
    return tuple(st[:17]) + (st[17] - st_in[17],)


def slot_waves(ch, live):
    """In-band slots over the live waves of a kernel's choice log (a live
    row logs CH_NONE outside the band)."""
    import torch
    G = ch.shape[0]
    rows = torch.arange(G, device=ch.device)[:, None] < live[None, :]
    return int(((ch != 3).sum(2) * rows).sum())


def chunk_bound(st0, st_k, ch_k, W):
    """Bytes (state in and out, a log row and kbase word per live wave, the
    pool words the live lanes span, the tube columns) and operations (per
    in-band slot of a live wave) of one wave_chunk call."""
    n = st0[0].shape[0]
    live = (st_k[17].long() - st0[17].long()).clamp(min=0)
    nbytes = (2 * (n * W * 16 + n * 16 * 4) + int(live.sum()) * (W + 4)
              + _pool_span_bytes(st0, st_k) + 6 * n * 4)
    return live, bound(nbytes, slot_waves(ch_k, live) * OPS_CHUNK_SLOT)


def check_chunk(n, W, chunk, k, seed, direction, spec, kind="plain",
                reps=5, plain=True):
    """wave_chunk at G = k * chunk on a seeded batch: against chunk_plain
    through canon_state (unless ``plain`` is False: timing only), kernel
    ms, the bound and the live-wave counts.  ``logs`` keeps the kernel's
    state and logs for the walk."""
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    G = k * chunk
    pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, W, seed,
                                                            kind)
    st0 = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    st_k, ch_k, kb_k = wk.wave_chunk(pool, targs, st0, spec, direction, G)
    err, bad, plain_ms, fell = 0, [], None, 0
    if plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, ch_p, band_p = wk.chunk_plain(pool, targs, st0, spec,
                                            direction, G)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, bad = canon_diff(wk.canon_state(st_k, (ch_k, kb_k), W),
                              wk.canon_state(st_p, (ch_p, band_p[:, :, 2]),
                                             W))
        # tubes the plain stepper flagged while alive (band overflow or an
        # empty band)
        fell = int((st_p[16] & ~st0[16]).sum())
    ms = cuda_ms(lambda: wk.wave_chunk(pool, targs, st0, spec, direction, G,
                                       logs=(ch_k, kb_k)), reps, windows=5)
    live, (bms, by) = chunk_bound(st0, st_k, ch_k, W)
    # tubes whose best point crossed the exact stretch of the exact batch
    # (its snake ran up to 20,000 bases in one wave)
    bx = st_k[8].long()
    crossed = int(((bx >= 30_000) if direction > 0 else (bx < 10_000)).sum())
    return dict(err=err, bad=bad, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, waves_max=int(live.max()),
                waves_mean=float(live.double().mean()), fell=fell,
                crossed=crossed, logs=(st_k, ch_k, kb_k))


def check_long(spec, direction, seed=202, reps=2):
    """The n=64 long lane's geometry at its largest budget (W=256, G =
    64 x 96 = 6,144) on the ``long`` batch: one launch of G waves equals
    16 launches of 384 in a row (canon_state, logs included), and the
    first and the last of those 384-wave launches equal chunk_plain from
    the same input state.  Kernel ms of the G-wave launch."""
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    n, W, G, piece = 64, 256, 64 * 96, 4 * 96
    pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, W, seed,
                                                            "long")
    st0 = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, W, direction)
    st_k, ch_k, kb_k = wk.wave_chunk(pool, targs, st0, spec, direction, G)
    st, pieces = st0, []
    for _ in range(G // piece):
        st_in = st
        st, ch, kb = wk.wave_chunk(pool, targs, st_in, spec, direction,
                                   piece)
        pieces.append((st_in, st, ch, kb))
    err, bad = canon_diff(
        wk.canon_state(st_k, (ch_k, kb_k), W),
        wk.canon_state(st, (torch.cat([p[2] for p in pieces]),
                            torch.cat([p[3] for p in pieces])), W))
    plain_ms = None
    for st_in, st_out, ch, kb in (pieces[0], pieces[-1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st_p, ch_p, band_p = wk.chunk_plain(pool, targs, st_in, spec,
                                            direction, piece)
        torch.cuda.synchronize()
        if plain_ms is None:
            plain_ms = (time.perf_counter() - t0) * 1e3
        e, b = canon_diff(
            wk.canon_state(rel_dif(st_out, st_in), (ch, kb), W),
            wk.canon_state(rel_dif(st_p, st_in), (ch_p, band_p[:, :, 2]), W))
        err, bad = max(err, e), bad + [f"piece:{x}" for x in b]
    ms = cuda_ms(lambda: wk.wave_chunk(pool, targs, st0, spec, direction, G,
                                       logs=(ch_k, kb_k)), reps, windows=3)
    live, (bms, by) = chunk_bound(st0, st_k, ch_k, W)
    return dict(err=err, bad=bad, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, waves_max=int(live.max()),
                waves_mean=float(live.double().mean()),
                fell=int((st_k[16] & ~st0[16]).sum()),
                last_alive=int(pieces[-1][0][15].sum()),
                logs=(st_k, ch_k, kb_k))


def random_logs(G, n, W, seed, far=False):
    """A random choice log, kbase log, trim diagonals and trim waves;
    ``far`` puts the trim diagonals about 2^30 from the kbase values (the
    walk kernel's exact path for diagonals far from the band)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    ch = torch.randint(0, 4, (G, n, W), generator=g, dtype=torch.uint8)
    kb = torch.randint(-40, 40, (G, n), generator=g, dtype=torch.int32)
    td = torch.randint(-100, 100, (n,), generator=g, dtype=torch.int32)
    if far:
        td = td + torch.where(torch.arange(n) % 2 == 0, 1, -1).to(
            torch.int32) * ((1 << 30) + 1000)
    tw = torch.randint(0, G + 1, (n,), generator=g, dtype=torch.int32)
    return tuple(t.cuda() for t in (ch, kb, td, tw))


def check_walk(ch, kb, td, tw, reps=20):
    """backtrack_walk against walk_plain, bit for bit; kernel and plain ms;
    the bound counts what these logs need: a log byte and a kbase word for
    each wave that steps (w < trim_wave), a D word for every wave."""
    from fastga_tpu_torch.ops import wave_kernels as wk
    G, n, W = ch.shape
    d0k, Dk = wk.backtrack_walk(ch, kb, td, tw)
    d0p, Dp = wk.walk_plain(ch, kb, td, tw)
    err = max(int((d0k - d0p).abs().max()), int((Dk - Dp).abs().max()))
    ms = cuda_ms(lambda: wk.backtrack_walk(ch, kb, td, tw), reps, windows=5)
    plain_ms = cuda_ms(lambda: wk.walk_plain(ch, kb, td, tw), 1, warm=1)
    steps = int(tw.long().clamp(0, G).sum())
    nbytes = steps * (1 + 4) + G * n * 4 + 3 * n * 4
    bms, by = bound(nbytes, steps * OPS_WALK_STEP)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, steps=steps)


def _chunk_line(r, n, W, G, d, kind):
    per = 1e3 * r["ms"] / max(r["waves_max"], 1)
    plain = ("" if r["plain_ms"] is None
             else f" plain {r['plain_ms']:.1f} ms")
    return (f"wave_chunk dir={d:+d} n={n} W={W} G={G} {kind}: max_abs_err="
            f"{r['err']} {r['bad']} live waves mean {r['waves_mean']:.1f} "
            f"max {r['waves_max']} fell {r['fell']} kernel {r['ms']:.4f} ms "
            f"({per:.3f} us a wave){plain} bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})")


def _walk_line(r, what):
    return (f"backtrack_walk {what}: max_abs_err={r['err']} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.1f} ms bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}; {r['steps']} steps)")


def phase_kernels(spec):
    """Each wave kernel against its plain version on the card, with its
    time.  wave_chunk: the main shape (n=512/W=256/G=384) on the plain and
    the wide batch, the W=512 and W=2048 rescue geometries, the exact-repeat
    and sequence-end batches, the long lane (check_long), all in both
    directions; timed alone at G=1,536 too.  backtrack_walk on a random log
    and on the logs wave_chunk wrote at each timed shape."""
    rows = {}
    out = {}
    for d in (+1, -1):
        r = check_wave0(512, 256, 101, d, timed=True)
        log(f"wave0 dir={d:+d} n=512 W=256: max_abs_err={r['err']} "
            f"kernel {r['ms']:.4f} ms (with the host's launch work "
            f"{r['call_ms']:.4f} ms) launch floor "
            f"{r['floor_ms']:.4f} ms plain {r['plain_ms']:.3f} ms "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        rows.setdefault("wave0", []).append(r)
    # the long lane's batch, the rescue widths, bands of up to W-1 and
    # past W diagonals (one to nine strides), the exact-repeat and
    # sequence-end batches; dead rows (valid = 0) on every third tube of a
    # plain batch and of two wide ones, where tubes 3, 9, 15, ... have the
    # wide bands
    for n, W, kind, widen, dead in (
            (64, 256, "long", 0, 0), (32, 512, "plain", 0, 0),
            (32, 2048, "plain", 0, 0), (512, 256, "wide", 0, 0),
            (64, 256, "wide", 40, 0), (32, 256, "exact", 0, 0),
            (32, 256, "ends", 0, 0), (512, 256, "plain", 0, 3),
            (512, 256, "wide", 0, 3), (64, 256, "wide", 40, 3)):
        for d in (+1, -1):
            r = check_wave0(n, W, 102, d, kind, widen, dead)
            log(f"wave0 dir={d:+d} n={n} W={W} {kind}"
                f"{f' widened by {widen}' if widen else ''}"
                f"{f' dead every {dead}' if dead else ''}: "
                f"max_abs_err={r['err']}")
            rows["wave0"].append(r)
    r = check_walk(*random_logs(1536, 512, 256, 303))
    log(_walk_line(r, "G=1536 n=512 W=256 random log"))
    rows["backtrack_walk"] = [r]
    r = check_walk(*random_logs(96, 64, 256, 304, far=True))
    log(_walk_line(r, "G=96 n=64 W=256 random log, diagonals 2^30 off"))
    rows["backtrack_walk"].append(r)
    walk_logs = []
    for (n, W, chunk, k, kind, plain) in (
            (512, 256, 96, 4, "plain", True), (512, 256, 96, 4, "wide", True),
            (32, 512, 96, 4, "plain", True), (32, 2048, 24, 4, "plain", True),
            (32, 256, 96, 4, "exact", True), (32, 256, 96, 4, "ends", True),
            (512, 256, 96, 16, "plain", False)):
        for d in (+1, -1):
            r = check_chunk(n, W, chunk, k, 202, d, spec, kind, plain=plain)
            log(_chunk_line(r, n, W, k * chunk, d, kind)
                + ("" if kind != "exact" else
                   f" crossed the exact stretch {r['crossed']}"))
            if kind == "wide" and r["fell"] == 0:
                raise SystemExit("wave_chunk: the wide batch overflowed no "
                                 "band; the fallback branch went unchecked")
            if kind == "exact" and r["crossed"] == 0:
                raise SystemExit("wave_chunk: no tube of the exact batch "
                                 "crossed its exact stretch")
            if kind == "plain" and W == 256:
                walk_logs.append((f"G={k * chunk} n={n} W={W} dir={d:+d} "
                                  "real log", r["logs"]))
            r.pop("logs")
            rows.setdefault("wave_chunk", []).append(
                dict(r, shape=(n, W, chunk, k, d, kind)))
    for d in (+1, -1):
        r = check_long(spec, d)
        log(_chunk_line(r, 64, 256, 6144, d, "long")
            + f" (= 16 x 384-wave launches; first and last equal to the "
            f"plain stepper; {r['last_alive']} tubes alive at the last)")
        walk_logs.append((f"G=6144 n=64 W=256 dir={d:+d} real log",
                          r.pop("logs")))
        rows["wave_chunk"].append(dict(r, shape=(64, 256, 96, 64, d,
                                                 "long")))
    for what, (st, ch, kb) in walk_logs:
        r = check_walk(ch, kb, st[14], st[13])
        log(_walk_line(r, what))
        rows["backtrack_walk"].append(r)
    del walk_logs
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


CHAIN_M2 = 50_331_648    # repeat-rich's chain sweep rows (2 x CHAIN_DEV_CAP)


def seeded_scan_inputs(M, seed):
    """The chain sweep's two scan inputs at M rows, made on the card from
    a seed: 13 int32 channels and a break flag (1%) for the per-chain
    aggregates, and chain-shaped coverage rows (novel bases 0-255, a break
    at row 0) whose sums pass 2^31."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = tuple(torch.randint(-2 ** 20, 2 ** 20, (M,), generator=g,
                               device="cuda", dtype=torch.int32)
                 for _ in range(13))
    brk = torch.rand(M, generator=g, device="cuda") < 0.01
    brk[0] = True
    novel = torch.randint(0, 256, (M,), generator=g, device="cuda",
                          dtype=torch.int32)
    cbrk = torch.rand(M, generator=g, device="cuda") < 1e-7
    cbrk[0] = True
    return vals, brk.to(torch.int32), novel, cbrk


def time_wave(tree):
    """The kernels of the fastga_tpu_torch under ``tree`` (this checkout,
    or an unpacked earlier commit) timed on seeded inputs: wave_chunk at
    the main shapes (n=512/W=256, G=384 and 1,536) and the long lane's
    (n=64, G=6,144), in both directions, backtrack_walk on the log it
    wrote and on a random log; wave0 at n=512/W=256, the long lane's n=64
    and the rescue lane's n=32/W=512; fused_scan at the chain aggregates'
    spec (13 max channels, 1 flag, M = 50,331,648) and the chain sweep's
    int64 coverage route (device_pipeline._seg_cumsum) at the same M.
    Prints one JSON line with a digest of each output."""
    import hashlib
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from fastga_tpu_torch.ops import (cuda_build, device_pipeline as dp,
                                      scan_kernels as sk, wave_kernels as wk)
    from fastga_tpu_torch.ops.wave_ref import AlignSpec
    cuda_build.build_kernels()
    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))

    def digest(arrs):
        h = hashlib.sha1()
        for a in arrs:
            if isinstance(a, torch.Tensor):
                a = a.cpu().numpy()
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]
    out = {"tree": os.path.abspath(tree), "card": smi_line()}
    for n, W, kind in ((512, 256, "plain"), (64, 256, "long"),
                       (32, 512, "plain")):
        args = seeded_batch(n, W, 202, kind)
        for d in (+1, -1):
            pool, targs, cols = args
            st0 = wk.wave0(pool, targs, *cols, W, d)
            out[f"wave0 n={n} W={W} dir={d:+d}"] = dict(
                wave0_ms=cuda_ms(lambda: wk.wave0(pool, targs, *cols, W, d),
                                 50, windows=5),
                wave0_digest=digest(st0))
    vals, brk, novel, cbrk = seeded_scan_inputs(CHAIN_M2, 404)
    chain13 = (("max", 0),) * 13
    outs = sk.fused_scan(vals, chain13, (brk,))
    out[f"fused_scan M={CHAIN_M2} 13xmax/f0"] = dict(
        scan_ms=cuda_ms(lambda: sk.fused_scan(vals, chain13, (brk,)), 10,
                        windows=5),
        scan_digest=digest(outs),
        bound_ms=bound(4 * CHAIN_M2 * (1 + 2 * 13), 0)[0])
    del outs
    cov = dp._seg_cumsum(novel, cbrk)
    out[f"coverage route M={CHAIN_M2} (_seg_cumsum)"] = dict(
        cov_ms=cuda_ms(lambda: dp._seg_cumsum(novel, cbrk), 5, windows=5),
        cov_digest=digest((cov,)), cov_max=int(cov.max()),
        # int32 rows and a bool flag in, int64 sums out
        bound_ms=bound(CHAIN_M2 * (4 + 1 + 8), 0)[0])
    del cov, vals, brk, novel, cbrk
    for n, k, kind in ((512, 4, "plain"), (512, 16, "plain"),
                       (64, 64, "long")):
        G = 96 * k
        pool, targs, (dgmin, dgmax, anti, valid) = seeded_batch(n, 256, 202,
                                                                kind)
        for d in (+1, -1):
            st0 = wk.wave0(pool, targs, dgmin, dgmax, anti, valid, 256, d)
            st, ch, kb = wk.wave_chunk(pool, targs, st0, spec, d, G)
            can = wk.canon_state(st, (ch, kb), 256)
            d0, D = wk.backtrack_walk(ch, kb, st[14], st[13])
            live = (st[17].long() - st0[17].long()).clamp(min=0)
            out[f"n={n} G={G} dir={d:+d}"] = dict(
                chunk_ms=cuda_ms(lambda: wk.wave_chunk(
                    pool, targs, st0, spec, d, G, logs=(ch, kb)),
                    5 if G <= 1536 else 2, windows=5),
                walk_ms=cuda_ms(lambda: wk.backtrack_walk(
                    ch, kb, st[14], st[13]), 20, windows=5),
                waves_max=int(live.max()),
                waves_mean=float(live.double().mean()),
                chunk_digest=digest(can[key] for key in sorted(can)),
                walk_digest=digest((d0.cpu().numpy(), D.cpu().numpy())))
            del ch, kb
    lg = random_logs(1536, 512, 256, 303)
    d0, D = wk.backtrack_walk(*lg)
    out["random log G=1536 n=512"] = dict(
        walk_ms=cuda_ms(lambda: wk.backtrack_walk(*lg), 20, windows=5),
        walk_digest=digest((d0.cpu().numpy(), D.cpu().numpy())))
    torch.cuda.synchronize()
    print("TIMING " + json.dumps(out), flush=True)


def compare_trees(parent):
    """time_wave of ``parent`` (an unpacked earlier commit) and of this
    checkout, each in its own process, in the order parent, this, this,
    parent, on one card; prints each reading and whether the outputs'
    digests agree."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tree in (parent, here, here, parent):
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--time-wave", tree], capture_output=True,
                           text=True, timeout=900)
        lines = [x for x in p.stdout.splitlines() if x.startswith("TIMING ")]
        if p.returncode != 0 or not lines:
            raise SystemExit(f"time_wave {tree} failed ({p.returncode}):\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
        runs.append(json.loads(lines[0][len("TIMING "):]))
    log(f"card: {runs[0]['card']}")
    same = True
    for key in runs[0]:
        if key in ("tree", "card"):
            continue
        for what in ("chunk", "walk", "wave0", "scan", "cov"):
            if what + "_ms" not in runs[0][key]:
                continue
            ms = [r[key][what + "_ms"] for r in runs]
            dg = {r[key][what + "_digest"] for r in runs}
            same = same and len(dg) == 1
            extra = ""
            if "bound_ms" in runs[1][key]:
                extra = f" bound {runs[1][key]['bound_ms']:.5f} ms"
            if what == "chunk":
                wm = runs[1][key]["waves_max"]
                extra = (f" waves max {wm} mean "
                         f"{runs[1][key]['waves_mean']:.1f}; us a wave "
                         f"parent {1e3 * ms[0] / wm:.3f} this "
                         f"{1e3 * ms[1] / wm:.3f}")
            log(f"{what} {key}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, this "
                f"{ms[1]:.4f} / {ms[2]:.4f} ms{extra}; outputs "
                f"{'equal' if len(dg) == 1 else 'DIFFER'}")
    print("AB " + json.dumps(runs), flush=True)
    return 0 if same else 1


# -- the seed pipeline's kernels ----------------------------------------------


class SeedCapture:
    """Wraps the device pipeline's kernel entry points and its seed routes
    (device_tubes, device_tubes_self, device_tubes_paneled,
    device_tubes_tables) for one run, to keep the inputs the run gave the
    kernels (per merge column count and per scan spec, the largest call),
    each route called with whether it declined (a ``Declined`` it passes
    on) and its peak device memory
    (``max_memory_allocated`` above the allocation at its start), the
    TubeBatch and arguments of the route that returned one, the panel
    counts the paneled route ran at, the reason of each route that
    declined, the chain sweep's A-contig panels,
    and each seed pass (``fits``: its expansion's total before a masked or
    -S flip pass drops any seed, the slots ``_expansion_slots`` gave it,
    its seeds and its alive driving rows).  The wrapped calls launch the
    kernels as before.
    ``inputs=False`` keeps no kernel inputs (they would stay alive past
    their use and raise the routes' peak memory)."""

    ROUTES = ("device_tubes", "device_tubes_self", "device_tubes_paneled",
              "device_tubes_tables")

    def __init__(self, inputs=True):
        self.inputs = inputs
        self.merge = {}
        self.scan = {}
        self.scan_calls = {}
        self.tubes = None
        self.tubes_args = None
        self.routes = []
        self.reasons = []
        self.mem = {}
        self.panels = []
        self.chain_panels = 0
        self.fits = []
        self.expansions = []

    def __enter__(self):
        import torch

        from fastga_tpu_torch.ops import device_pipeline as tp
        names = (("merge_sorted_streams", "fused_scan", "_panel_plane",
                  "_chain_panel", "_expansion_slots", "_merge_seeds_sum",
                  "_self_seeds_sum") + self.ROUTES)
        self._orig = {n: getattr(tp, n) for n in names}
        orig = self._orig

        def merge_w(opsA, opsB):
            m = opsA[0].shape[0] + opsB[0].shape[0]
            old = self.merge.get(len(opsA))
            if self.inputs and (old is None or m > old[0][0].shape[0]
                                + old[1][0].shape[0]):
                self.merge[len(opsA)] = (opsA, opsB)
            return orig["merge_sorted_streams"](opsA, opsB)

        def scan_w(values, spec, flags=(), reverse=False):
            key = (tuple(spec), len(flags), bool(reverse))
            self.scan_calls[key] = self.scan_calls.get(key, 0) + 1
            old = self.scan.get(key)
            if self.inputs and (old is None
                                or values[0].shape[0] > old[0][0].shape[0]):
                self.scan[key] = (tuple(values), tuple(flags))
            return orig["fused_scan"](values, spec, flags, reverse)

        def plane_w(prep, total, P):
            self.panels.append(P)
            return orig["_panel_plane"](prep, total, P)

        def chain_w(*a):
            self.chain_panels += 1
            return orig["_chain_panel"](*a)

        def slots_w(total, ns_cap):
            slots = orig["_expansion_slots"](total, ns_cap)
            self.expansions.append((int(total), slots))
            return slots

        def pass_w(name):
            def w(*a, **k):
                out = orig[name](*a, **k)
                total, slots = self.expansions[-1]
                self.fits.append(dict(total=total, slots=slots,
                                      nseeds=int(out[6]),
                                      nalive=int(out[7])))
                return out
            return w

        def route_w(name):
            def w(*a, **k):
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                try:
                    res = orig[name](*a, **k)
                except tp.Declined as e:
                    self.routes.append((name, False))
                    self.reasons.append(e.reason)
                    raise
                torch.cuda.synchronize()
                self.mem[name] = torch.cuda.max_memory_allocated() - base
                self.routes.append((name, True))
                self.tubes, self.tubes_args = res, (a, k)
                return res
            return w

        tp.merge_sorted_streams, tp.fused_scan = merge_w, scan_w
        tp._panel_plane, tp._chain_panel = plane_w, chain_w
        tp._expansion_slots = slots_w
        for n in ("_merge_seeds_sum", "_self_seeds_sum"):
            setattr(tp, n, pass_w(n))
        for n in self.ROUTES:
            setattr(tp, n, route_w(n))
        return self

    def __exit__(self, *exc):
        from fastga_tpu_torch.ops import device_pipeline as tp
        for n, f in self._orig.items():
            setattr(tp, n, f)

    def fold_into(self, merge, scan):
        """Keep this run's kernel inputs in ``merge`` / ``scan`` where
        they are the largest call of their column count / spec."""
        for key, ops in self.merge.items():
            old = merge.get(key)
            if old is None or (ops[0][0].shape[0] + ops[1][0].shape[0]
                               > old[0][0].shape[0] + old[1][0].shape[0]):
                merge[key] = ops
        for key, vf in self.scan.items():
            if key not in scan or vf[0][0].shape[0] > scan[key][0][0].shape[0]:
                scan[key] = vf


class WaveCapture:
    """Records the shape of every wave kernel launch of one main-path run,
    in order: wave_chunk and backtrack_walk by (n, W, G, direction), wave0
    by (n, W, direction); the walk takes the direction of the wave_chunk
    call before it.  The wrapped calls launch the kernels as before."""

    def __enter__(self):
        from fastga_tpu_torch.ops import wave_kernels as wk
        self.calls = []
        self._orig = (wk.wave0, wk.wave_chunk, wk.backtrack_walk)
        wave0, chunk, walk = self._orig
        last = [0]

        def wave0_w(pool, targs, dgmin, dgmax, anti, valid, W, direction):
            self.calls.append(("wave0", targs[0].shape[0], W, "-",
                               direction))
            return wave0(pool, targs, dgmin, dgmax, anti, valid, W,
                         direction)

        def chunk_w(pool, targs, st, spec, direction, G, logs=None):
            last[0] = direction
            self.calls.append(("wave_chunk",) + tuple(st[0].shape)
                              + (G, direction))
            return chunk(pool, targs, st, spec, direction, G, logs)

        def walk_w(ch, kb, trim_diag, trim_wave):
            G, N, W = ch.shape
            self.calls.append(("backtrack_walk", N, W, G, last[0]))
            return walk(ch, kb, trim_diag, trim_wave)

        wk.wave0, wk.wave_chunk, wk.backtrack_walk = wave0_w, chunk_w, walk_w
        return self

    def __exit__(self, *exc):
        from fastga_tpu_torch.ops import wave_kernels as wk
        wk.wave0, wk.wave_chunk, wk.backtrack_walk = self._orig

    def report(self, name, kernel_us=None):
        """Launches by shape; with ``kernel_us`` ({kernel: [device us of
        each launch, in order]}), each shape's device ms."""
        from collections import Counter
        us = {}
        if kernel_us is not None:
            seen = Counter()
            for key in self.calls:
                i = seen[key[0]]
                seen[key[0]] += 1
                us[key] = us.get(key, 0.0) + kernel_us[key[0]][i]
        for key, c in sorted(Counter(self.calls).items(),
                             key=lambda kv: str(kv[0])):
            kern, n, W, G, d = key
            t = (f": {us[key] / 1e3:.3f} ms device (mean "
                 f"{us[key] / 1e3 / c:.4f} ms)" if key in us else "")
            log(f"  wave launches[{name}]: {kern} n={n} W={W} G={G} "
                f"dir={d:+d} x{c}{t}")


def profile_kernels(name, g1, g2):
    """The main path once more under torch.profiler, CUDA activity only:
    each device kernel's total time and count (self_device_time_total is
    the total over a kernel's calls, not a per-call time; the mean per
    call is printed beside it), and the wave kernels' device time by
    launch shape (their kernels in start order, matched to the shapes
    WaveCapture recorded in call order)."""
    import torch

    from fastga_tpu_torch.models import aligner
    torch.cuda.synchronize()
    with WaveCapture() as wcap, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        aligner.align_genomes(g1, g2, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = [e for e in p.key_averages() if dev_us(e) > 0]
    busy = sum(dev_us(e) for e in ka) / 1e6
    if busy <= 0:
        log(f"profile[{name}]: device time not measured (the profiler "
            "recorded none)")
        return
    # torch.cummax / cummin run as this scan kernel: none on the main path
    cum = [e.key for e in ka if "scan_innermost_dim_with_indices" in e.key
           or "cummax" in e.key or "cummin" in e.key]
    if cum:
        raise SystemExit(f"profile[{name}]: cummax/cummin kernels on the "
                         f"main path: {cum}")
    log(f"profile[{name}]: no cummax/cummin kernel")
    log(f"profile[{name}]: device busy {busy:.4f} s of {wall:.3f} s wall "
        f"under the profiler (idle share {1 - busy / wall:.4f})")
    ours = ("wave_chunk_kernel", "wave0_kernel", "backtrack_walk_kernel",
            "merge", "scan")
    top = sorted(ka, key=dev_us, reverse=True)
    for i, e in enumerate(top):
        if i < 12 or any(k in e.key for k in ours):
            log(f"  device[{name}] {e.key[:90]}: total {dev_us(e) / 1e3:.3f} "
                f"ms x{e.count} (mean {dev_us(e) / 1e3 / e.count:.4f} ms)")
    per = {}
    for kern in ("wave0", "wave_chunk", "backtrack_walk"):
        evs = sorted((e for e in p.events()
                      if kern + "_kernel" in e.name and dev_us(e) > 0),
                     key=lambda e: e.time_range.start)
        per[kern] = [dev_us(e) for e in evs]
    n_calls = {k: sum(1 for c in wcap.calls if c[0] == k) for k in per}
    if any(len(per[k]) != n_calls[k] for k in per):
        log(f"profile[{name}]: device ms by shape not measured (kernels "
            f"{ {k: len(v) for k, v in per.items()} }, calls {n_calls})")
        wcap.report(name)
        return
    wcap.report(name, per)


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


def check_scan(values, spec, flags, reverse, reps=10, timed=True):
    """fused_scan against its plain version on every row; ``timed``: kernel
    and plain ms, the byte bound (4 bytes per row for each flag, twice the
    value's bytes for each channel: read once, written once) and the
    yardstick: torch.cumsum of the stacked channels (it computes less)."""
    import torch

    from fastga_tpu_torch.ops import scan_kernels as sk
    dt = torch.int64 if spec[0][0] == "sum64" else torch.int32
    got = sk.fused_scan(values, spec, flags, reverse)
    want = sk.fused_scan_plain([v.to(dt) for v in values], spec,
                               [f.to(torch.int32) for f in flags], reverse)
    torch.cuda.synchronize()
    err = 0
    for a, b in zip(got, want):
        if a.dtype != dt or not torch.equal(a, b):
            err = max(err, int((a.long() - b.long()).abs().max()), 1)
    M = values[0].shape[0]
    shape = (M, len(values), len(flags), bool(reverse))
    if not timed:
        return dict(err=err, shape=shape)
    ms = cuda_ms(lambda: sk.fused_scan(values, spec, flags, reverse), reps,
                 windows=5)
    plain_ms = cuda_ms(lambda: sk.fused_scan_plain(values, spec, flags,
                                                   reverse), 1, warm=1)
    stack = torch.stack([v.to(dt) for v in values])
    yard_ms = cuda_ms(lambda: torch.cumsum(stack, 1, dtype=dt), 2)
    esize = 8 if dt == torch.int64 else 4
    bms, by = bound(M * (4 * len(flags) + 2 * esize * len(values)), 0)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, yard_ms=yard_ms, shape=shape)


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
    # sizes (the coverage sum: uniform's int32 "sum", repeat-rich's
    # int64 "sum64")
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
    # odd sizes, the tile's edges +-1 (fused_scan.cu cuts 4,096-row tiles
    # for up to 6 int32 channels and the int64 one, 2,048 for more), more
    # than 10,000 tiles (the look-back runs past its
    # 32-tile windows), a misaligned view (4-byte copies and stores), the
    # int64 channel past 2^31 of either sign: every row against the plain
    # version
    g = torch.Generator(device="cuda").manual_seed(403)
    spec6 = (("sum", None), ("max", 0), ("min", 1), ("last", 1),
             ("sum", 0), ("max", None))
    spec13 = tuple((("max", "last", "min", "sum")[i % 4], i % 2)
                   for i in range(13))
    spec16 = spec6 + spec6 + spec6[:4]
    sum64 = (("sum64", 0),)
    cases = [(M, spec6, False) for M in (1, 3, 1023, 1024, 1025, 2047, 2048,
                                         2049, 4095, 4096, 4097, 12325)]
    cases += [(12325, spec6, True)]
    cases += [(M, spec13, False) for M in (2047, 2048, 2049,
                                           10_000 * 2048 + 517)]
    cases += [(M, spec16, False) for M in (2047, 2048, 2049)]
    cases += [(M, sum64, False) for M in (4097, 3 * 2 ** 20 + 5)]
    for M, spec, shifted in cases:
        lo, hi = ((-2 ** 31, 2 ** 31) if spec is not sum64
                  else (0, 2 ** 20) if M > 2 ** 20 else (-2 ** 40, 2 ** 40))
        dt = torch.int64 if spec is sum64 else torch.int32
        vals = [torch.randint(lo, hi, (M + shifted,), generator=g,
                              device="cuda", dtype=dt)[shifted:]
                for _ in spec]
        fl = [(torch.rand(M + shifted, generator=g, device="cuda") < p)
              .to(torch.int32)[shifted:] for p in (1e-4, 0.3)[:len(spec)]]
        for rev in (False, True):
            r = check_scan(vals, spec, fl, rev, timed=False)
            past = ""
            if spec is sum64:
                past = f" (largest sum {int(torch.cumsum(vals[0], 0).max())})"
            log(f"fused_scan M={M} {_spec_str(spec)} reverse={rev}"
                f"{' misaligned' if shifted else ''}: max_abs_err "
                f"{r['err']}{past}")
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


def run_main_path(name, g1, g2, **kw):
    """align_genomes on the card (``kw``: its tables and options) with the
    spans on; prints the records, the phase split (fastga_tpu bench.py's
    span names) and the stats."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.utils import prof
    prof.ENABLED = True
    prof.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ovls, stats = aligner.align_genomes(g1, g2, device="cuda", **kw)
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
    """The device TubeBatch against the host seed path's (the path of
    masks, -S and engine="ref") on the same input, every field."""
    from fastga_tpu_torch.io.gix import build_gix
    from fastga_tpu_torch.ops import chain as chainm, merge as mergem
    t1, t2 = build_gix(g1), build_gix(g2)
    seeds = mergem.adaptamer_seeds(t1, t2, freq=10)
    host = chainm.chain_tubes(seeds, int(g1.contig_lengths().max()),
                              int(g2.contig_lengths().max()), alens_of(g1))
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
    with SeedCapture() as cap, WaveCapture() as wcap:
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path("uniform", g1, g2)
        launches = dict(cuda_build.LAUNCHES)
    main_run = scenario_files("uniform", g1, g2, ovls, wall)
    check_launches("uniform", launches)
    wcap.report("uniform")
    if (stats["nlive"], stats["cov"]) != UNIFORM_EXPECT:
        raise SystemExit(f"uniform: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {UNIFORM_EXPECT}")
    check_seeds("uniform", stats, UNIFORM_SEEDS)
    check_routes("uniform", cap, [("device_tubes", True)])
    check_host_tubes(g1, g2, cap.tubes[0])
    check_paneled(cap)
    return launches, cap, main_run


def repeat_rich(mbp):
    """fastga_tpu bench.py's main input: synth.repeat_rich_pair at ``mbp``
    Mbp a side (seed 0xBE7C4); the two GDBs and their soft-masked repeat
    intervals (io.gdb.MaskIval lists, the shape of a RepeatMasker
    annotation)."""
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(0xBE7C4)
    pair, masks = synth.repeat_rich_pair(
        rng, int(mbp * 1e6), ncontig=max(8, int(mbp)), repeat_frac=0.55,
        copies_per_subfam=12)
    g1, iv1 = synth.to_gdb("a", pair["A"], masks["A"])
    g2, iv2 = synth.to_gdb("b", pair["B"], masks["B"])
    return g1, g2, iv1, iv2


def phase_repeatrich(mbp):
    from fastga_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    g1, g2, iv1, iv2 = repeat_rich(mbp)
    log(f"repeatrich: {mbp:g} Mbp/side x{g1.ncontig} contigs, "
        f"{len(iv1):,} / {len(iv2):,} repeat intervals (gen "
        f"{time.perf_counter() - t0:.1f} s)")
    with SeedCapture() as cap:
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path("repeatrich", g1, g2)
        launches = dict(cuda_build.LAUNCHES)
    main_run = scenario_files("repeatrich", g1, g2, ovls, wall)
    del ovls
    log(f"  launches[repeatrich]: {json.dumps(launches)}")
    # the int64 coverage sum (255 * M2 >= 2^31 here) is one fused_scan
    # call of its own: one launch more than the int32 specs' count
    calls = {_spec_str(k[0]) + ("" if not k[2] else " reverse"): c
             for k, c in cap.scan_calls.items()}
    wide = sum(c for k, c in cap.scan_calls.items() if k[0][0][0] == "sum64")
    log(f"  fused_scan calls[repeatrich]: {json.dumps(calls)}; "
        f"{launches['fused_scan']} launches = "
        f"{launches['fused_scan'] - wide} int32 + {wide} int64 coverage sum")
    if wide != 1 or sum(cap.scan_calls.values()) != launches["fused_scan"]:
        raise SystemExit("repeatrich: the int64 coverage sum did not run "
                         "once on fused_scan")
    if (stats["nlive"], stats["cov"]) != REPEAT_RICH_EXPECT:
        raise SystemExit(f"repeatrich: nlive {stats['nlive']} cov "
                         f"{stats['cov']}; expected {REPEAT_RICH_EXPECT}")
    check_seeds("repeatrich", stats, REPEAT_RICH_SEEDS)
    check_routes("repeatrich", cap, [("device_tubes", True)])
    profile_kernels("repeatrich", g1, g2)
    return launches, cap, main_run, (g1, g2, iv1, iv2)


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


# -- the command line ------------------------------------------------------


def records_digest(ovls):
    """sha256 over the records in order: coordinates, strand, diffs and
    trace."""
    h = hashlib.sha256()
    for o in ovls:
        h.update(repr((int(o.aread), int(o.abpos), int(o.aepos),
                       int(o.bread), int(o.bbpos), int(o.bepos),
                       bool(o.bcomp), int(o.diffs),
                       [(int(d), int(b)) for d, b in o.trace])).encode())
    return h.hexdigest()


def write_fasta(path, names, seqs, width=80, lower=None):
    """Upper-case FASTA of base-code arrays, ``width`` bases a line;
    ``lower``: io.gdb.MaskIval intervals (by sequence index) written in
    lower case, FASTA's soft mask."""
    from fastga_tpu_torch.utils import dna
    soft = {}
    for m in lower or ():
        soft.setdefault(m.contig, []).append((m.beg, m.end))
    with open(path, "wb") as f:
        for i, (name, codes) in enumerate(zip(names, seqs)):
            body = np.frombuffer(dna.to_ascii(codes, True), np.uint8)
            if i in soft:
                low = np.zeros(len(body), bool)
                for b, e in soft[i]:
                    low[b:e] = True
                body = np.where(low, body | 0x20, body).astype(np.uint8)
            full = len(body) // width
            f.write(b">%s\n" % name.encode())
            f.write(np.concatenate(
                [body[:full * width].reshape(full, width),
                 np.full((full, 1), 10, np.uint8)], 1).tobytes())
            if len(body) % width:
                f.write(body[full * width:].tobytes() + b"\n")


def scenario_files(name, g1, g2, ovls, wall):
    """Write a main-path scenario's genomes as FASTA files (one scaffold a
    contig, as synth.to_gdb builds them) for the command line phase, with
    the main path's record digest, count, coverage and wall time."""
    d = os.path.join(CLI_DIR, name)
    os.makedirs(d, exist_ok=True)
    paths = []
    for tag, g in (("A", g1), ("B", g2)):
        paths.append(os.path.join(d, tag + ".fa"))
        write_fasta(paths[-1], [s.header for s in g.scaffolds],
                    [g.get_contig(i) for i in range(g.ncontig)])
    return dict(name=name, fasta=paths, digest=records_digest(ovls),
                n=len(ovls), cov=sum(o.aepos - o.abpos for o in ovls),
                wall=wall)


def run_cli(tool, argv, out_path=None):
    """``fastga_tpu_torch.cli.<tool>.main(argv)`` in this process on the
    card; stdout to ``out_path`` (else returned), stderr captured.
    Returns (stdout or None, stderr, wall s); a non-zero status fails."""
    import importlib

    import torch
    main = importlib.import_module(f"fastga_tpu_torch.cli.{tool}").main
    err = io.StringIO()
    out = open(out_path, "w") if out_path else io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        text = None if out_path else out.getvalue()
    finally:
        out.close()
    if rc != 0:
        raise SystemExit(f"cli: {tool} {' '.join(argv)} exited {rc}: "
                         f"{err.getvalue()[-2000:]}")
    return text, err.getvalue(), wall


def cli_split(err, wall):
    """The -v phase lines of fastga: (parse + GDB build, alignment,
    writing) seconds of a run that took ``wall``."""
    w = dict(re.findall(r"Resources for (.+?):\s+\S+u\s+\S+s\s+(\S+)w",
                        err))
    parse = float(w["genome/index resolution"])
    align = float(w["seed merge + alignment search"])
    return parse, align, wall - parse - align


def read_records(path):
    from fastga_tpu_torch.io import alncode
    return alncode.read_aln(path).overlaps


def self_fasta(path):
    """tests/test_self.py's S.fasta (seed 777): a 30 kb base with a
    mutated copy and a mutated inverted copy of 5 kb of it."""
    rng = np.random.default_rng(777)
    base = rng.integers(0, 4, 30000)
    seg = base[2000:7000]

    def mut(x, r=.03):
        x = x.copy()
        m = rng.random(len(x)) < r
        x[m] = (x[m] + rng.integers(1, 4, m.sum())) % 4
        return x

    g = np.concatenate([base, mut(seg), (3 - mut(seg))[::-1],
                        rng.integers(0, 4, 3000)])
    txt = "".join("acgt"[x] for x in g)
    with open(path, "w") as f:
        f.write(">s1\n" + "\n".join(txt[i:i + 70]
                                    for i in range(0, len(txt), 70)) + "\n")


def diverged_pair(seed=5150, n=30000):
    """tests/test_wave_ref.py's E/F pair: 3% substitutions, 1% insertions,
    1% deletions, the middle third of F inverted."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    out = []
    i = 0
    while i < n:
        r = rng.random()
        if r < 0.03:
            out.append((a[i] + rng.integers(1, 4)) % 4)
            i += 1
        elif r < 0.04:
            out.append(rng.integers(0, 4))
        elif r < 0.05:
            i += 1
        else:
            out.append(a[i])
            i += 1
    b = np.array(out, dtype=np.uint8)
    b = np.concatenate([b[:10000], (3 - b[10000:20000])[::-1], b[20000:]])
    return a, b


def cli_goldens(d):
    """The C goldens through the command line on the card."""
    s_fa = os.path.join(d, "S.fasta")
    self_fasta(s_fa)
    gold = open(os.path.join(HERE, "tests", "golden", "ref_self.paf")).read()
    from fastga_tpu_torch.models import aligner
    align, seen = aligner.align_genomes, []
    aligner.align_genomes = lambda *a, **k: seen.append(align(*a, **k)) \
        or seen[-1]
    try:
        paf, _, wall = run_cli("fastga", ["-T1", s_fa])
    finally:
        aligner.align_genomes = align
    if paf != gold:
        raise SystemExit("cli: fastga -T1 S.fasta differs from "
                         "tests/golden/ref_self.paf")
    if [st["seed_pipeline"] for _, st in seen] != ["device"]:
        raise SystemExit(f"cli: fastga -T1 S.fasta seeded on "
                         f"{[st.get('seed_pipeline') for _, st in seen]}, "
                         f"not the device")
    aln = os.path.join(d, "self")
    run_cli("fastga", ["-T1", f"-1:{aln}", s_fa])
    paf2, _, _ = run_cli("alntopaf", [aln + ".1aln"])
    if paf2 != gold:
        raise SystemExit("cli: alntopaf of fastga -T1 -1: S.fasta differs "
                         "from tests/golden/ref_self.paf")
    log(f"cli goldens: fastga -T1 S.fasta (device self seeds) and alntopaf "
        f"of its .1aln equal ref_self.paf ({gold.count(chr(10))} lines; "
        f"fastga {wall:.3f} s)")
    a, b = diverged_pair()
    e_fa, f_fa = os.path.join(d, "E.fasta"), os.path.join(d, "F.fasta")
    write_fasta(e_fa, ["e1"], [a], width=60)
    write_fasta(f_fa, ["f1"], [b], width=60)
    run_cli("fastga", [f"-1:{d}/EvF", e_fa, f_fa])
    ovls = read_records(os.path.join(d, "EvF.1aln"))
    got = [(o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos, o.bcomp,
            o.diffs) for o in ovls]
    sums = all(sum(b for _, b in o.trace) == o.bepos - o.bbpos
               and sum(dd for dd, _ in o.trace) == o.diffs for o in ovls)
    if got != EF_RECORDS or not sums:
        raise SystemExit(f"cli: fastga -1: E F gives {got} (trace sums "
                         f"{'equal' if sums else 'differ'}); expected the "
                         f"C reference's {EF_RECORDS}")
    log("cli goldens: fastga -1: E.fasta F.fasta gives the C reference's "
        "three records, trace sums equal to the spans")


def cli_scenario(run, d):
    """fastga -v -1: and fastga -v (PAF) on a main-path scenario's FASTA
    files: the main path's records and as many PAF lines, every kernel
    launched, the wall time split."""
    from fastga_tpu_torch.ops import cuda_build
    name = run["name"]
    A, B = run["fasta"]
    aln = os.path.join(d, name)
    cuda_build.reset_launches()
    _, err, wall = run_cli("fastga", ["-v", f"-1:{aln}", A, B])
    launches = dict(cuda_build.LAUNCHES)
    split = cli_split(err, wall)
    t0 = time.perf_counter()
    ovls = read_records(aln + ".1aln")
    t_read = time.perf_counter() - t0
    got = (len(ovls), sum(o.aepos - o.abpos for o in ovls))
    same = records_digest(ovls) == run["digest"]
    if got != (run["n"], run["cov"]) or not same:
        raise SystemExit(f"cli[{name}]: the .1aln holds {got}; the main "
                         f"path's records are {(run['n'], run['cov'])}, "
                         f"digest {'equal' if same else 'different'}")
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"cli[{name}]: kernels {missing} were never "
                         f"launched by the CLI run")
    paf = aln + ".paf"
    cuda_build.reset_launches()
    _, err2, wall2 = run_cli("fastga", ["-v", A, B], out_path=paf)
    launches2 = dict(cuda_build.LAUNCHES)
    with open(paf) as f:
        nlines = sum(1 for _ in f)
    if nlines != len(ovls) or any(launches2.get(k, 0) <= 0 for k in KERNELS):
        raise SystemExit(f"cli[{name}]: PAF has {nlines} lines for "
                         f"{len(ovls)} records, launches {launches2}")
    split2 = cli_split(err2, wall2)
    log(f"cli[{name}]: {got[0]:,} records, {got[1]:,} bp, equal to the main "
        f"path's; PAF {nlines:,} lines; launches {json.dumps(launches)}")
    for what, w, (p, a, wr) in (("-1:X.1aln", wall, split),
                                ("(PAF)", wall2, split2)):
        log(f"  wall[{name}] fastga {what}: {w:.3f} s = FASTA parse and GDB "
            f"build {p:.3f} + alignment {a:.3f} + writing {wr:.3f}; "
            f"align_genomes (main path) {run['wall']:.3f} s")
    log(f"  read_aln[{name}]: {t_read:.3f} s")


def cli_python_m(d):
    """One `python -m fastga_tpu_torch.cli.fastga` subprocess on the card
    on a small mutated pair: status 0 and the in-process PAF."""
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(0xC11)
    a = rng.integers(0, 4, 20000).astype(np.uint8)
    b = synth.mutate(rng, a, 0.03, indel_frac=0.2)
    A, B = os.path.join(d, "mA.fa"), os.path.join(d, "mB.fa")
    write_fasta(A, ["mA"], [a])
    write_fasta(B, ["mB"], [b])
    want, _, _ = run_cli("fastga", [A, B])
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "fastga_tpu_torch.cli.fastga",
                        A, B], cwd=HERE, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != 0 or p.stdout != want or not want:
        raise SystemExit(f"cli: python -m fastga_tpu_torch.cli.fastga "
                         f"exited {p.returncode}, PAF "
                         f"{'equal' if p.stdout == want else 'different'} "
                         f"({len(want.splitlines())} lines in process): "
                         f"{p.stderr[-2000:]}")
    log(f"cli: python -m fastga_tpu_torch.cli.fastga: rc 0, "
        f"{len(want.splitlines())} PAF lines equal to the in-process run's "
        f"({wall:.1f} s with interpreter start)")


def cli_gixmake(run, d):
    """gixmake (the device GIX build) on the uniform FASTAs: the host
    build's files byte for byte, and fastga A.gix B.gix gives the uniform
    records."""
    from fastga_tpu_torch.io import gdb as gdbm, gix as gixm
    from fastga_tpu_torch.ops import cuda_build
    g = os.path.join(d, "gix")
    os.makedirs(os.path.join(g, "host"), exist_ok=True)
    walls = []
    for src, tag in zip(run["fasta"], "AB"):
        shutil.copy(src, os.path.join(g, tag + ".fa"))
        cuda_build.reset_launches()
        walls.append(run_cli("gixmake", [os.path.join(g, tag + ".fa")])[2])
        if cuda_build.LAUNCHES["fused_scan"] <= 0:
            raise SystemExit("cli: gixmake did not build on the card")
    t0 = time.perf_counter()
    table = gixm.build_gix(gdbm.read_gdb(os.path.join(g, "A")))
    t_host = time.perf_counter() - t0
    gixm.write_gix(table, os.path.join(g, "host", "A"))

    def files(root):
        stub, parts = gixm.gix_paths(root)
        return {p: open(os.path.join(os.path.dirname(stub), p), "rb").read()
                for p in sorted(os.listdir(os.path.dirname(stub)))
                if p == os.path.basename(stub)
                or p.startswith(os.path.basename(parts))}
    dev_files = files(os.path.join(g, "A"))
    if len(dev_files) < 2 or dev_files != files(os.path.join(g, "host", "A")):
        raise SystemExit("cli: gixmake's .gix files differ from the host "
                         "build_gix + write_gix of the same GDB")
    aln = os.path.join(g, "AvB")
    run_cli("fastga", [f"-1:{aln}", os.path.join(g, "A.gix"),
                       os.path.join(g, "B.gix")])
    if records_digest(read_records(aln + ".1aln")) != run["digest"]:
        raise SystemExit("cli: fastga A.gix B.gix differs from the uniform "
                         "records")
    log(f"cli: gixmake A and B on the card ({walls[0]:.3f} / {walls[1]:.3f} "
        f"s; host build_gix of A {t_host:.3f} s): {len(dev_files)} files "
        f"({table.n:,} entries) equal to the host build's; fastga A.gix "
        f"B.gix gives the uniform records")


def cli_masks_sym(run, gs, d):
    """fastga -v -M on the repeat-rich FASTAs with the repeats in lower
    case, and fastga -v -S on the upper-case ones (PAF): seeds on the card,
    the wall time split."""
    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.ops import cuda_build
    g1, g2, iv1, iv2 = gs
    lc = []
    for tag, g, iv in (("A", g1, iv1), ("B", g2, iv2)):
        lc.append(os.path.join(d, f"{run['name']}_{tag}lc.fa"))
        write_fasta(lc[-1], [sc.header for sc in g.scaffolds],
                    [g.get_contig(i) for i in range(g.ncontig)], lower=iv)
    align, seen = aligner.align_genomes, []
    aligner.align_genomes = lambda *a, **k: seen.append(align(*a, **k)) \
        or seen[-1]
    try:
        for flag, files in (("-M", lc), ("-S", run["fasta"])):
            paf = os.path.join(d, f"{run['name']}{flag}.paf")
            cuda_build.reset_launches()
            _, err, wall = run_cli("fastga", ["-v", flag] + files,
                                   out_path=paf)
            launches = dict(cuda_build.LAUNCHES)
            st = seen[-1][1]
            with open(paf) as f:
                nlines = sum(1 for _ in f)
            if st["seed_pipeline"] != "device" or nlines != st["nlive"] \
                    or any(launches.get(k, 0) <= 0 for k in KERNELS):
                raise SystemExit(f"cli[{run['name']}] fastga {flag}: seeds "
                                 f"{st['seed_pipeline']} "
                                 f"({st.get('seed_decline', '')}), "
                                 f"{nlines} PAF lines for {st['nlive']} "
                                 f"records, launches {launches}")
            p, a, wr = cli_split(err, wall)
            log(f"cli[{run['name']}] fastga -v {flag} (PAF): device seeds, "
                f"{st['nseeds']:,} seeds, {st['nhits']:,} tubes, "
                f"{nlines:,} records; wall {wall:.3f} s = FASTA parse, GDB "
                f"and GIX build {p:.3f} + alignment {a:.3f} + writing "
                f"{wr:.3f}; launches {json.dumps(launches)}")
    finally:
        aligner.align_genomes = align


def phase_cli(run_u, run_rr, gs_rr):
    """The command line on the card (phase 9)."""
    t0 = time.perf_counter()
    d = os.path.join(CLI_DIR, "run")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    cli_goldens(d)
    cli_scenario(run_u, d)
    cli_scenario(run_rr, d)
    cli_masks_sym(run_rr, gs_rr, d)
    cli_python_m(d)
    cli_gixmake(run_u, d)
    log(f"cli: phase {time.perf_counter() - t0:.1f} s")


# -- phase 10: self comparison and kmer-panel streaming ----------------------

BIG_CONTIGS = 2560    # uniform pair past _MAX_DEV_BASES: 128 Mbp a side


def alens_of(g):
    """Contig length by rank, the aligner's for a run without tables."""
    from fastga_tpu_torch.io.gix import _length_perm
    lens = g.contig_lengths()
    lens_eff = np.concatenate([lens, np.full(max(0, 8 - len(lens)), 40)])
    perm = _length_perm(lens_eff)[0]
    return np.where(perm < len(lens), lens[np.minimum(perm, len(lens) - 1)],
                    40)


def check_routes(name, cap, want):
    if cap.routes != want:
        raise SystemExit(f"{name}: device seed routes {cap.routes}; "
                         f"expected {want}")


def check_launches(name, launches):
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise SystemExit(f"{name}: kernels {missing} were never launched")
    log(f"  launches[{name}]: {json.dumps(launches)}")


def check_host_self(got, ref):
    """The self run's TubeBatch, seed count and seed-length sum against the
    host seed path's on the same genome (build_gix, self_adaptamer_seeds,
    chain_tubes: HOST_REFS["self"], each step timed in its worker
    process)."""
    out, t_gix, _ = ref
    host, ns, hpl, t_seed, t_chain = out["self"]
    tubes, dns, pl = got
    bad = tube_diff(host, tubes)
    if bad or (dns, pl) != (ns, hpl):
        raise SystemExit(f"self: device TubeBatch ({tubes.n} tubes, {dns} "
                         f"seeds, length sum {pl}) differs from the host "
                         f"path's ({host.n}, {ns}, {hpl}): {bad}")
    log(f"self: device TubeBatch, seeds and seed-length sum equal to the "
        f"host path's ({host.n:,} tubes, {ns:,} seeds, length sum "
        f"{hpl:,}); host seeding {t_gix + t_seed + t_chain:.3f} s = "
        f"build_gix {t_gix:.3f} + self_adaptamer_seeds {t_seed:.3f} + "
        f"chain_tubes {t_chain:.3f} (in a worker process)")


def run_self(g, host_ref):
    """align_genomes(g, g) on the card: device_tubes_self (with the chain
    in A-contig panels past CHAIN_DEV_CAP seeds), every kernel launched,
    the host path's TubeBatch (``host_ref``: HOST_REFS["self"]'s
    result)."""
    from fastga_tpu_torch.ops import cuda_build
    with SeedCapture() as cap:
        cuda_build.reset_launches()
        _, stats, wall = run_main_path("self", g, g)
        launches = dict(cuda_build.LAUNCHES)
    check_routes("self", cap, [("device_tubes_self", True)])
    if stats.get("seed_pipeline") != "device":
        raise SystemExit(f"self: seed pipeline {stats.get('seed_pipeline')}")
    check_launches("self", launches)
    from fastga_tpu_torch.ops import device_pipeline as tp
    cap2 = 2 * max(1 << 12, tp._pad_bucket(int(g.contig_lengths().sum())))
    fit_lines("self", cap)
    log(f"self: the JAX package's seed cap 2 * E1 = {cap2:,}"
        + (": exceeded" if cap.tubes[1] > cap2 else ""))
    log(f"self: device_tubes_self, {cap.tubes[1]:,} seeds, "
        f"{cap.tubes[0].n:,} tubes, chain in {cap.chain_panels} A-contig "
        f"panels")
    route_alone("self", "device_tubes_self",
                *cap.tubes_args)
    check_host_self(cap.tubes, host_ref)
    return cap, launches


def route_alone(what, name, args, kwargs):
    """One more call of a seed route on the arguments a run gave it, with
    no kernel inputs kept: its seeding time and peak device memory."""
    import torch

    from fastga_tpu_torch.ops import device_pipeline as tp
    with SeedCapture(inputs=False) as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(tp, name)(*args, **kwargs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    log(f"{what}: {name} alone {dt:.3f} s, peak device memory "
        f"{cap.mem[name] / 2**30:.3f} GiB")


def check_forced_panels(name, ref, selfish):
    """device_tubes_paneled(panels=4) on a route's arguments: the route's
    TubeBatch, seed count and seed-length sum."""
    import torch

    from fastga_tpu_torch.ops import device_pipeline as tp
    want, (a, k) = ref
    with SeedCapture() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if selfish:
            got = tp.device_tubes_paneled(a[0], None, a[1], panels=4, **k)
        else:
            got = tp.device_tubes_paneled(a[0], a[1], a[2], panels=4, **k)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    bad = tube_diff(want[0], got[0])
    if bad or got[1:] != want[1:]:
        raise SystemExit(f"{name} panels=4: {got[0].n} tubes, {got[1]} "
                         f"seeds, length sum {got[2]}; differs from "
                         f"{want[0].n}, {want[1]}, {want[2]}: {bad}")
    log(f"{name} panels=4: ran at {cap.panels} panels, TubeBatch, seeds and "
        f"seed-length sum equal ({got[0].n:,} tubes, {got[1]:,} seeds); "
        f"{dt:.3f} s")
    return cap


def big_pair(ncontig):
    from fastga_tpu_torch.utils import synth
    t0 = time.perf_counter()
    pair = synth.uniform_pair(np.random.default_rng(0xBE7C4), ncontig,
                              50_000)
    g1, g2 = (synth.to_gdb(t, pair[t.upper()])[0] for t in "ab")
    log(f"uniform{ncontig}: {ncontig} x 50 kb a side "
        f"({int(g1.contig_lengths().sum()):,} / "
        f"{int(g2.contig_lengths().sum()):,} bases; gen "
        f"{time.perf_counter() - t0:.1f} s)")
    return g1, g2


def same_tubes(what, want, got, other):
    bad = tube_diff(want[0], got[0])
    if bad or got[1:] != want[1:]:
        raise SystemExit(f"{what}: paneled TubeBatch ({got[0].n}, {got[1]}, "
                         f"{got[2]}) differs from the {other}'s "
                         f"({want[0].n}, {want[1]}, {want[2]}): {bad}")
    log(f"{what}: TubeBatch, seeds and seed-length sum equal to the "
        f"{other}'s ({got[0].n:,} tubes, {got[1]:,} seeds)")


def single_shot(g1, g2, what):
    """device_tubes of a pair with _MAX_DEV_BASES raised for this one call
    (timed, with its peak device memory), or None when it does not fit on
    the card."""
    import torch

    from fastga_tpu_torch.ops import device_pipeline as tp
    old = tp._MAX_DEV_BASES
    tp._MAX_DEV_BASES = 1 << 28
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    try:
        with SeedCapture(inputs=False) as cap:
            t0 = time.perf_counter()
            got = tp.device_tubes(g1, g2, alens_of(g1), device="cuda")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as e:
        log(f"{what}: the single-shot route does not fit on the card "
            f"({base / 2**30:.3f} GiB allocated before it; "
            f"{str(e).splitlines()[0]})")
        return None
    finally:
        tp._MAX_DEV_BASES = old
    log(f"{what}: single-shot device_tubes {dt:.3f} s, {got[1]:,} seeds, "
        f"{got[0].n:,} tubes, peak device memory "
        f"{cap.mem['device_tubes'] / 2**30:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB allocated before it")
    return got


def run_big():
    """The 128 Mbp uniform pair: first a single-shot device_tubes of it
    (its _MAX_DEV_BASES raised), then align_genomes, which must route it
    to device_tubes_paneled alone on the card (a genome past
    _MAX_DEV_BASES) and give the same TubeBatch.  If the single-shot route
    does not fit on the card, the comparison runs at 96 Mbp (the paneled
    route called directly)."""
    import torch

    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.ops import device_pipeline as tp
    g1, g2 = big_pair(BIG_CONTIGS)
    want = single_shot(g1, g2, "uniform128")
    torch.cuda.empty_cache()
    with SeedCapture() as cap:
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path("uniform128", g1, g2)
        launches = dict(cuda_build.LAUNCHES)
    del ovls
    check_routes("uniform128", cap, [("device_tubes_paneled", True)])
    if stats.get("seed_pipeline") != "device":
        raise SystemExit(f"uniform128: seed pipeline "
                         f"{stats.get('seed_pipeline')}")
    check_launches("uniform128", launches)
    log(f"uniform128: device_tubes_paneled at {cap.panels[-1]} panels "
        f"({cap.panels}), {cap.tubes[1]:,} seeds, {cap.tubes[0].n:,} tubes, "
        f"chain in {cap.chain_panels} A-contig panels")
    route_alone("uniform128", "device_tubes_paneled", *cap.tubes_args)
    if want is not None:
        same_tubes("uniform128", want, cap.tubes, "single-shot route")
        return cap, launches
    del g1, g2
    cap.tubes = cap.tubes_args = None
    torch.cuda.empty_cache()
    n = BIG_CONTIGS * 3 // 4
    s1, s2 = big_pair(n)
    want = single_shot(s1, s2, f"uniform{n}")
    if want is None:
        raise SystemExit(f"uniform{n}: the single-shot route does not fit "
                         f"on the card either")
    got = tp.device_tubes_paneled(s1, s2, alens_of(s1), device="cuda")
    same_tubes(f"uniform{n}", want, got, "single-shot route")
    return cap, launches


def phase_seed_routes(g_rr, rr_ref, u_ref, host_self):
    """Phase 10: the self and kmer-panel seed routes on the card, then
    merge_path and fused_scan against their plain versions on the largest
    inputs of each column count and spec these routes gave them.  The 128
    Mbp pair runs first: its single-shot reference needs most of the
    card.
    ``host_self``: the self run's host reference."""
    t0 = time.perf_counter()
    merge, scan = {}, {}
    cap_b, launches_b = run_big()
    cap_b.fold_into(merge, scan)
    del cap_b
    cap_s, launches_s = run_self(g_rr, host_self)
    cap_s.fold_into(merge, scan)
    self_ref = (cap_s.tubes, cap_s.tubes_args)
    del cap_s
    for name, ref, selfish in (("uniform", u_ref, False),
                               ("repeatrich", rr_ref, False),
                               ("self", self_ref, True)):
        check_forced_panels(name, ref, selfish).fold_into(merge, scan)
    del self_ref
    kern = seed_kernel_rows(merge, scan, "routes")
    log(f"seed routes: phase {time.perf_counter() - t0:.1f} s")
    return launches_s, launches_b, kern


def seed_kernel_rows(merge, scan, tag):
    """merge_path and fused_scan against their plain versions on captured
    inputs, every merge column count and every scan spec, timed."""
    rows = {"merge_path": [], "fused_scan": []}
    for ncol, (opsA, opsB) in sorted(merge.items()):
        r = check_merge(opsA, opsB)
        log(f"merge_path[{tag}] E1={r['shape'][0]} E2={r['shape'][1]} "
            f"cols={r['shape'][2]}: unequal rows {r['err']} kernel "
            f"{r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        rows["merge_path"].append(r)
    for (spec, _, reverse), (values, flags) in sorted(
            scan.items(), key=lambda kv: -len(kv[0][0])
            * kv[1][0][0].shape[0]):
        r = check_scan(values, spec, flags, reverse)
        log(f"fused_scan[{tag}] M={r['shape'][0]} {_spec_str(spec)} "
            f"flags={len(flags)} reverse={reverse}: max_abs_err {r['err']} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})")
        rows["fused_scan"].append(r)
    for name, rs in rows.items():
        if not rs or max(x["err"] for x in rs) != 0:
            raise SystemExit(f"{name}[{tag}]: kernel disagrees with its "
                             f"plain version or was not called: {rs}")
    return rows


# -- phase 11: masked tables and -S ------------------------------------------

# the host seed path's variants of phases 10 and 11 on the repeat-rich
# pair, one worker process each: (name, soft mask, symmetric; None for
# self), on masked tables or not
HOST_REFS = {
    "self": ([("self", False, None)], False),
    "masked": ([("hard mask", False, False), ("-M", True, False)], True),
    "symmetric": ([("-S", False, True)], False),
    "symmetric masked": ([("-S -M", True, True)], True),
    "self masked": ([("self -M", True, None)], True),
}


def host_reference(what, mbp):
    """One HOST_REFS entry on the repeat-rich pair, in a worker process:
    build_gix (with the repeat intervals as masks where masked), the host
    seed functions and chain_tubes, each timed.  Returns ({variant:
    (TubeBatch, seeds, length sum, seed s, chain s)}, build_gix s, and the
    masked tables of "masked", which the card's runs take)."""
    from fastga_tpu_torch.io.gix import build_gix
    from fastga_tpu_torch.ops import chain as chainm, merge as mergem
    variants, masked = HOST_REFS[what]
    g1, g2, iv1, iv2 = repeat_rich(mbp)
    t0 = time.perf_counter()
    t1 = build_gix(g1, masks=iv1 if masked else None)
    t2 = (None if what.startswith("self")
          else build_gix(g2, masks=iv2 if masked else None))
    t_gix = time.perf_counter() - t0
    amax = int(g1.contig_lengths().max())
    bmax = int(g2.contig_lengths().max())
    out = {}
    for name, soft, sym in variants:
        t0 = time.perf_counter()
        if sym is None:
            seeds = mergem.self_adaptamer_seeds(t1, freq=10, soft_mask=soft)
        else:
            seeds = mergem.adaptamer_seeds(t1, t2, freq=10, soft_mask=soft)
            if sym:
                extra = mergem.adaptamer_seeds_flip(t1, t2, freq=10,
                                                    soft_mask=soft)
                seeds = mergem.SeedBatch(*[
                    np.concatenate([getattr(seeds, f), getattr(extra, f)])
                    for f in ("plen", "acont", "apost", "bcont", "bpost",
                              "bcomp")])
        t_seed = time.perf_counter() - t0
        tubes = chainm.chain_tubes(seeds, amax, amax if sym is None else bmax,
                                   alens_of(g1))
        out[name] = (tubes, seeds.n, int(seeds.plen.astype(np.int64).sum()),
                     t_seed, time.perf_counter() - t0 - t_seed)
        del seeds
    return out, t_gix, (t1, t2) if what == "masked" else None


def start_host_references(mbp):
    """The host references of phases 10-12, started in spawned worker
    processes while the kernels build: one per HOST_REFS entry, and
    phase 12's host .gix files and their fastks (``host_tool_files``,
    under "tools")."""
    import multiprocessing
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    pool = multiprocessing.get_context("spawn").Pool(len(HOST_REFS) + 1)
    pending = {what: pool.apply_async(host_reference, (what, mbp))
               for what in HOST_REFS}
    pending["tools"] = pool.apply_async(host_tool_files, (mbp, TOOLS_DIR))
    return pool, pending


def join_host_references(pool, pending, t0):
    """Wait for every host reference and stop the workers, so that no
    phase is timed beside them."""
    try:
        refs = {what: res.get(timeout=900) for what, res in pending.items()}
    finally:
        pool.terminate()
        pool.join()
    for what in HOST_REFS:
        log(f"host[{what}]: build_gix {refs[what][1]:.3f} s"
            f"{' (with the repeat masks)' if HOST_REFS[what][1] else ''}")
    log(f"host references: {time.perf_counter() - t0:.1f} s from the "
        f"script's start, {len(refs)} worker processes, kernel build "
        f"alongside")
    return refs


def same_as_host(what, got, ref, dt):
    """A device route's (TubeBatch, seeds, length sum) against a host
    reference's, with both seeding times."""
    tubes, ns, pl, t_seed, t_chain = ref
    bad = tube_diff(tubes, got[0])
    if bad or got[1:] != (ns, pl):
        raise SystemExit(f"{what}: device TubeBatch ({got[0].n} tubes, "
                         f"{got[1]} seeds, length sum {got[2]}) differs "
                         f"from the host path's ({tubes.n}, {ns}, {pl}): "
                         f"{bad}")
    log(f"{what}: device TubeBatch, seeds and seed-length sum equal to the "
        f"host path's ({tubes.n:,} tubes, {ns:,} seeds, length sum {pl:,}); "
        f"device route {dt:.3f} s, host seeds + chain {t_seed:.3f} + "
        f"{t_chain:.3f} s (in a worker process)")


def fit_lines(what, cap):
    """Each seed pass of a route: its expansion's total before compaction
    against its slots, its kept seeds and alive driving rows."""
    for i, f in enumerate(cap.fits):
        if f["slots"] < f["total"]:
            raise SystemExit(f"{what}: an expansion of {f['total']} seeds "
                             f"took {f['slots']} slots")
        log(f"  expansion[{what}] {i + 1}: total before compaction "
            f"{f['total']:,}, slots {f['slots']:,}, kept {f['nseeds']:,}, "
            f"alive driving rows {f['nalive']:,}")


def device_route(what, fn, *args, **kw):
    """One seed route on the card under SeedCapture: (result, capture,
    seconds)."""
    import torch
    with SeedCapture() as cap:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*args, device="cuda", **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    fit_lines(what, cap)
    return got, cap, dt


def main_path_route(name, g1, g2, route, ref, **kw):
    """align_genomes on the card through a phase-11 route: the route taken,
    every kernel launched, the host reference's seeds and tubes."""
    from fastga_tpu_torch.ops import cuda_build
    with SeedCapture(inputs=False) as cap:
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path(name, g1, g2, **kw)
        launches = dict(cuda_build.LAUNCHES)
    check_routes(name, cap, [(route, True)])
    check_seeds(name, stats, (ref[1], ref[0].n))
    check_launches(name, launches)
    if not ovls:
        raise SystemExit(f"{name}: no alignments")
    return launches


def phase_masks(gs, refs):
    """Phase 11: the masked-table and -S routes on the repeat-rich pair
    against the host references of the worker processes, align_genomes
    through them, then merge_path and fused_scan on the largest inputs of
    each column count and scan spec these routes gave them."""
    from fastga_tpu_torch.ops import device_pipeline as tp
    t0 = time.perf_counter()
    g1, g2, _, _ = gs
    ref = {k: v for out, _, _ in refs.values() for k, v in out.items()}
    t1, t2 = refs["masked"][2]
    log(f"masked tables: {t1.n:,} / {t2.n:,} entries, "
        f"{int((t1.maskb > 0).sum()):,} / {int((t2.maskb > 0).sum()):,} "
        f"with a mask byte")
    alens = alens_of(g1)
    amax = int(g1.contig_lengths().max())
    bmax = int(g2.contig_lengths().max())
    merge, scan = {}, {}
    for name, soft, sym, selfish in (
            ("hard mask", False, False, False), ("-M", True, False, False),
            ("-S -M", True, True, False), ("self -M", True, False, True)):
        res, cap, dt = device_route(
            name, tp.device_tubes_tables, t1, t1 if selfish else t2, alens,
            amax, amax if selfish else bmax, soft_mask=soft, symmetric=sym)
        same_as_host(name, res, ref[name], dt)
        cap.fold_into(merge, scan)
        if name == "hard mask" and (res[1], res[0].n) != REPEAT_RICH_SEEDS:
            raise SystemExit(f"hard mask: {res[1]} seeds, {res[0].n} tubes; "
                             f"the main path's are {REPEAT_RICH_SEEDS}")
    res, cap, dt = device_route("-S", tp.device_tubes, g1, g2, alens,
                                symmetric=True)
    n1, n2 = (tp._pad_bucket(int(g.contig_lengths().sum())) for g in (g1, g2))
    log(f"-S: the JAX package's slots {n1:,} (normal pass) and {n2:,} "
        f"(flip pass), its flip pass's alive cap {n2 // 2:,}")
    same_as_host("-S", res, ref["-S"], dt)
    cap.fold_into(merge, scan)
    del cap
    route_alone("-S", "device_tubes",
                (g1, g2, alens), dict(symmetric=True, device="cuda"))
    launches = {
        "-M": main_path_route("masked -M", g1, g2, "device_tubes_tables",
                              ref["-M"], t1=t1, t2=t2,
                              params=_params(soft_mask=True)),
        "-S": main_path_route("symmetric -S", g1, g2, "device_tubes",
                              ref["-S"], symmetric=True)}
    kern = seed_kernel_rows(merge, scan, "masks")
    log(f"masks and -S: phase {time.perf_counter() - t0:.1f} s")
    return launches, kern


# -- phase 12: past the device caps; the genome, index and annotation tools --

TOOLS_DIR = os.path.join(CLI_DIR, "tools")


@contextlib.contextmanager
def lowered(**kw):
    """device_pipeline's names (module constants, ``_plane_table``) set
    to ``kw`` for the enclosed block, as phase 4 lowers CHAIN_DEV_CAP."""
    from fastga_tpu_torch.ops import device_pipeline as tp
    old = {k: getattr(tp, k) for k in kw}
    for k, v in kw.items():
        setattr(tp, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(tp, k, v)


class ChainTimer:
    """The wall seconds of each chain sweep of a run (``_run_chain``, the
    card synchronised before and after) and the windows of its A-contig
    panels (``_chain_panel``: the panel's seeds and the window's rows)."""

    def __enter__(self):
        import torch

        from fastga_tpu_torch.ops import device_pipeline as tp
        self.chain, self.windows = [], []
        self._orig = run_chain, panel = tp._run_chain, tp._chain_panel

        def run_w(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_chain(*a)
            torch.cuda.synchronize()
            self.chain.append(time.perf_counter() - t0)
            return res

        def panel_w(*a):
            self.windows.append((a[4], a[5]))
            return panel(*a)
        tp._run_chain, tp._chain_panel = run_w, panel_w
        return self

    def __exit__(self, *exc):
        from fastga_tpu_torch.ops import device_pipeline as tp
        tp._run_chain, tp._chain_panel = self._orig


def host_tool_files(mbp, d):
    """In a worker process: the repeat-rich pair's GDBs and host GIX
    (build_gix) written as d/host/{A,B}, then the port's fastks on the two
    .gix files (its main in process: no card).  Returns fastks' stdout
    and each step's seconds."""
    from fastga_tpu_torch.cli import fastks
    from fastga_tpu_torch.io import gdb as gdbm, gix as gixm
    g1, g2, _, _ = repeat_rich(mbp)
    os.makedirs(os.path.join(d, "host"), exist_ok=True)
    times = {}
    roots = []
    for tag, g in (("A", g1), ("B", g2)):
        roots.append(os.path.join(d, "host", tag))
        t0 = time.perf_counter()
        table = gixm.build_gix(g)
        times[f"build_gix {tag}"] = time.perf_counter() - t0
        g.srcpath = tag + ".fa"
        gdbm.write_gdb(g, roots[-1])
        gixm.write_gix(table, roots[-1])
        del table
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if fastks.main([r + ".gix" for r in roots], device="cpu") != 0:
            raise SystemExit("host fastks on the .gix files failed")
    times["fastks"] = time.perf_counter() - t0
    return out.getvalue(), times


def chain_past_caps(name, gs, rr_ref, run_rr, kw, t_dev):
    """align_genomes on the repeat-rich pair with device_pipeline's caps
    set to ``kw``: the chain swept on the card in A-contig panels, where
    the JAX package sweeps on the host; device_tubes' TubeBatch (inside
    align_genomes) equal to phase 5's, and phase 5's records."""
    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.ops import device_pipeline as tp
    want, ns, pl = rr_ref[0]
    err = io.StringIO()
    with lowered(**kw), SeedCapture(inputs=False) as cap, \
            ChainTimer() as ct, contextlib.redirect_stderr(err):
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path(name, *gs[:2])
        launches = dict(cuda_build.LAUNCHES)
        panel = tp.CHAIN_DEV_CAP // 2
    check_routes(name, cap, [("device_tubes", True)])
    check_seeds(name, stats, REPEAT_RICH_SEEDS)
    bad = tube_diff(want, cap.tubes[0])
    digest = records_digest(ovls)
    own = [n for n, w in ct.windows if n > panel]
    if bad or cap.tubes[1:] != (ns, pl) or len(ct.chain) != 1 \
            or sum(n for n, _ in ct.windows) != ns \
            or any(w != max(panel, tp._pad_bucket(n))
                   for n, w in ct.windows) \
            or digest != run_rr["digest"] or "declined" in err.getvalue() \
            or (stats["nlive"], stats["cov"]) != REPEAT_RICH_EXPECT:
        raise SystemExit(f"{name}: windows {ct.windows}, TubeBatch "
                         f"{bad or 'equal'}, records {stats['nlive']} / "
                         f"{stats['cov']} (digest {digest == run_rr['digest']})"
                         f"; stderr {err.getvalue()[-1000:]}")
    log(f"{name}: chain in {len(ct.windows)} A-contig panels of up to "
        f"{panel:,} seeds, {len(own)} of them a contig past that in a "
        f"window of its own bucket ({own}); device_tubes' TubeBatch equal to "
        f"phase 5's ({want.n:,} tubes, {ns:,} seeds, length sum {pl:,}); "
        f"{len(ovls):,} records equal to phase 5's; chain {ct.chain[0]:.3f} s "
        f"against the monolithic chain's {t_dev:.3f} s; align_genomes "
        f"{wall:.3f} s; launches {json.dumps(launches)}")
    return launches, own


def uniform_past_caps(name, gs, run_u, kw, routes, want=None, scans=None):
    """align_genomes on the uniform pair ``gs`` with device_pipeline's caps
    set to ``kw``: seeded on the card by ``routes`` (one route, the
    paneled one past a lowered _MAX_DEV_BASES), with phase
    4's records and no decline printed, and phase 4's seeds and tubes or
    ``want``'s (the host path's TubeBatch and seed count); ``scans`` lists
    each ``_plane_table`` call's (entries, rows)."""
    from fastga_tpu_torch.ops import cuda_build
    err = io.StringIO()
    with lowered(**kw), SeedCapture(inputs=False) as cap, \
            contextlib.redirect_stderr(err):
        cuda_build.reset_launches()
        ovls, stats, wall = run_main_path(name, *gs)
        launches = dict(cuda_build.LAUNCHES)
    check_routes(name, cap, routes)
    check_seeds(name, stats, UNIFORM_SEEDS if want is None
                else (want[1], want[0].n))
    bad = want is not None and tube_diff(want[0], cap.tubes[0])
    if bad or records_digest(ovls) != run_u["digest"] \
            or (stats["nlive"], stats["cov"]) != UNIFORM_EXPECT \
            or "declined" in err.getvalue():
        raise SystemExit(f"{name}: TubeBatch {bad or 'equal'}, records "
                         f"{stats['nlive']} / {stats['cov']}; stderr "
                         f"{err.getvalue()[-1000:]}")
    log(f"{name}: seeded on the card ({stats['nseeds']:,} seeds, "
        f"{stats['nhits']} tubes"
        + (", the host path's TubeBatch" if want is not None else "")
        + f"); {len(ovls)} records equal to phase 4's; "
        f"align_genomes {wall:.3f} s; launches {json.dumps(launches)}"
        + (f"; panel tables (entries, rows) {scans}"
           if scans is not None else ""))
    return launches


def phase_past_caps(gs_rr, rr_ref, run_rr, run_u):
    """Phase 12 (a): past the caps after upload where the JAX package
    sweeps on the host or declines, the port stays on the card, at full
    size."""
    import torch

    from fastga_tpu_torch.io.gix import build_gix
    from fastga_tpu_torch.ops import chain as chainm, merge as mergem
    from fastga_tpu_torch.ops import device_pipeline as tp
    from fastga_tpu_torch.utils import synth
    t0 = time.perf_counter()
    args, kwargs = rr_ref[1]
    with ChainTimer() as ct:
        got = tp.device_tubes(*args, **kwargs)
    if tube_diff(rr_ref[0][0], got[0]) or ct.windows:
        raise SystemExit("past caps: device_tubes at the default caps "
                         "differs from phase 5's")
    t_dev = ct.chain[0]
    bucket = tp._pad_bucket(REPEAT_RICH_SEEDS[0])
    launches = {}
    launches["paneled chain"], _ = chain_past_caps(
        "chain (CHAIN_DEV_CAP below the bucket)", gs_rr, rr_ref, run_rr,
        dict(CHAIN_DEV_CAP=bucket - 1), t_dev)
    # a chain panel (CHAIN_DEV_CAP // 2) below the mean seeds of an A
    # contig: the larger contigs' seeds pass it, and the seeds' bucket
    # passes 6 x CHAIN_DEV_CAP (both where the JAX package sweeps on the
    # host)
    per = REPEAT_RICH_SEEDS[0] // gs_rr[0].ncontig
    launches["contig windows"], own = chain_past_caps(
        "chain (contigs past a chain panel)", gs_rr, rr_ref, run_rr,
        dict(CHAIN_DEV_CAP=2 * per - 2), t_dev)
    if not own or bucket <= 6 * (2 * per - 2):
        raise SystemExit(f"past caps: no contig past a panel ({own})")
    # the uniform pair's B genome with a poly-A contig up to the bucket
    # past a quarter more bases: two entries a base there, so its GIX
    # entries pass its padded bases N (the JAX package's entry cap); the
    # poly-A contig adds a tube but no record, so the records stay phase
    # 4's, and the tubes are the host path's
    rng = np.random.default_rng(0xBE7C4)
    pair = synth.uniform_pair(rng, 192, 50_000)
    tot = sum(map(len, pair["B"]))
    polya = np.zeros(tp._pad_bucket(tot + tot // 4) - tot, np.uint8)
    gs = (synth.to_gdb("a", pair["A"])[0],
          synth.to_gdb("b", pair["B"] + [polya])[0])
    del pair
    t1 = time.perf_counter()
    host = build_gix(gs[1])
    t_host = time.perf_counter() - t1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tab = tp.build_gix_device(gs[1], "cuda")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    N = tp._pad_bucket(int(gs[1].contig_lengths().sum()))
    bad = [f for f in ("kbytes", "post", "cont", "comp", "lcp", "maskb",
                       "prefix_index", "perm", "post_bytes", "cont_bytes",
                       "freq", "seqtot")
           if not np.array_equal(np.asarray(getattr(tab, f)),
                                 np.asarray(getattr(host, f)))]
    if bad or tab.n <= N:
        raise SystemExit(f"past caps: build_gix_device with {tab.n} entries "
                         f"(N {N}) differs from build_gix ({bad})")
    log(f"past caps: B with a {len(polya):,}-base poly-A contig: "
        f"build_gix_device {tab.n:,} entries past N = {N:,} in {dt:.3f} s, "
        f"equal to the host build_gix ({t_host:.3f} s) field by field")
    t1 = time.perf_counter()
    seeds = mergem.adaptamer_seeds(build_gix(gs[0]), host, freq=10)
    want = (chainm.chain_tubes(seeds, int(gs[0].contig_lengths().max()),
                               int(gs[1].contig_lengths().max()),
                               alens_of(gs[0])), seeds.n)
    log(f"past caps: the host path's TubeBatch ({want[0].n} tubes, "
        f"{want[1]:,} seeds) {time.perf_counter() - t1:.3f} s")
    del host, tab, seeds
    launches["entries"] = uniform_past_caps(
        "GIX entries past N", gs, run_u, {}, [("device_tubes", True)], want)
    gs = uniform_gdbs()     # the plain pair, without the poly-A contig
    scans = []
    table = tp._plane_table

    def table_w(*a):
        T = table(*a)
        scans.append((a[3], len(T[0])))
        return T
    launches["panel tables"] = uniform_past_caps(
        "panel planes in blocks of 2^20 positions", gs, run_u,
        dict(_MAX_DEV_BASES=1 << 20, PANEL_BLOCK=1 << 20,
             _plane_table=table_w),
        [("device_tubes_paneled", True)], scans=scans)
    if not scans or any(r != tp._pad_bucket(n) for n, r in scans):
        raise SystemExit(f"past caps: panel tables {scans}")
    log(f"past caps: phase {time.perf_counter() - t0:.1f} s")
    return launches


def run_tool(tool, args, cwd, rc=0):
    """``python -m fastga_tpu_torch.cli.<tool> args`` in ``cwd``: (stdout,
    stderr, wall s); another exit status than ``rc`` fails."""
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", f"fastga_tpu_torch.cli.{tool}",
                        *args], cwd=cwd, env=env, capture_output=True,
                       text=True, timeout=600)
    wall = time.perf_counter() - t0
    if p.returncode != rc or "Traceback" in p.stderr:
        raise SystemExit(f"tools: {tool} {' '.join(args)} exited "
                         f"{p.returncode}: {p.stderr[-2000:]}")
    return p.stdout, p.stderr, wall


def fasta_records(path):
    """{header: sequence} of a FASTA file, case kept."""
    with open(path, "rb") as f:
        text = f.read()
    out = {}
    for rec in text.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        out[head.decode()] = body.replace(b"\n", b"")
    return out


def phase_tools(gs_rr, host_tools):
    """Phase 12 (b): the genome, index and annotation tools as `python -m`
    subprocesses at full size, on the repeat-rich pair (its FASTAs with
    the repeats in lower case, from phase 9) and its repeat intervals as
    BED."""
    from fastga_tpu_torch.io import gix as gixm
    from fastga_tpu_torch.ops.constants import KMER
    from fastga_tpu_torch.utils import dna
    t0 = time.perf_counter()
    g1, g2, iv1, _ = gs_rr
    d = TOOLS_DIR
    walls = {}

    def tool(name, args, rc=0, cwd=d):
        out, err, walls[name] = run_tool(name.split()[0], args, cwd, rc)
        return out, err

    src = os.path.join(CLI_DIR, "run", "repeatrich_{}lc.fa")
    for tag in "AB":
        shutil.copy(src.format(tag), os.path.join(d, tag + ".fa"))
    for tag, g in (("A", g1), ("B", g2)):
        tool(f"fatogdb {tag}", [tag + ".fa"])
    # fatogdb, then gdbtofa with the case mask: the FASTA's sequence and
    # case, contig for contig
    out, _ = tool("gdbtofa", ["#A.1ano", "A", "Aback.fa"])
    want = fasta_records(os.path.join(d, "A.fa"))
    back = fasta_records(os.path.join(d, "Aback.fa"))
    if back != want:
        raise SystemExit(f"tools: gdbtofa gives {len(back)} records, "
                         f"{sum(a == b for a, b in zip(back.values(), want.values()))}"
                         f" of {len(want)} equal to the input's")
    nbases = sum(len(v) for v in want.values())
    lower = sum(int((np.frombuffer(v, np.uint8) >= 97).sum())
                for v in want.values())
    out, _ = tool("gdbstat", ["A"])
    m = re.search(r"([\d,]+) contigs containing ([\d,]+)bp", out)
    if not m or (int(m[1].replace(",", "")),
                 int(m[2].replace(",", ""))) != (g1.ncontig, g1.seqtot):
        raise SystemExit(f"tools: gdbstat says {m and m.group(0)}; the "
                         f"genome has {g1.ncontig} contigs, {g1.seqtot} bp")
    out, _ = tool("gdbshow -h", ["-h", "A"])
    spans = re.findall(r":: Contig \d+ <0,(\d+)>", out)
    if len(spans) != g1.ncontig or sum(map(int, spans)) != g1.seqtot:
        raise SystemExit(f"tools: gdbshow -h lists {len(spans)} contigs")
    # 500 bases from the middle of scaffold 3 (gdbshow prints lower case)
    sc = g1.scaffolds[2]
    b = sc.slen // 2
    out, _ = tool("gdbshow range", ["A", f"@3:{b}-{b + 500}"])
    got = "".join(out.splitlines()[1:])
    if got != want[sc.header][b:b + 500].decode().lower():
        raise SystemExit(f"tools: gdbshow @3:{b}-{b + 500} differs from "
                         f"the FASTA's slice")
    # gixmake on the card, then gixshow at a spread of addresses
    for tag in "AB":
        tool(f"gixmake {tag}", [tag])
    seqs = [g1.get_contig(i) for i in range(g1.ncontig)]
    with gixm.KmerStream(os.path.join(d, "A")) as ks:
        n = ks.nels
    nshown = 0
    # entry ranges, then DNA prefixes (9 and 6 bases) of k-mers they showed
    addrs = ["0-3"] + [f"{i}-{i + 3}" for i in (n // 3, 2 * n // 3, n - 4)]
    for addr in addrs:
        out, _ = tool(f"gixshow {addr}", ["A", addr])
        lines = out.splitlines()[1:]
        if not lines:
            raise SystemExit(f"tools: gixshow {addr} shows no k-mer")
        if addr == addrs[1]:
            addrs += [lines[0].split()[1][:9], lines[-1].split()[1][:6]]
        for ln in lines:
            f = ln.split()
            kmer, ctg, post = f[1], int(f[5]), int(f[7])
            s = seqs[ctg]
            k = (dna.revcomp(s[post - KMER:post]) if f[4] == "-"
                 else s[post:post + KMER])
            if dna.to_ascii(k).decode() != kmer:
                raise SystemExit(f"tools: gixshow {addr}: {ln!r} is not "
                                 f"the sequence at its position")
            if not addr[0].isdigit() and not kmer.startswith(addr):
                raise SystemExit(f"tools: gixshow {addr}: {ln!r}")
            nshown += 1

    # gixcp, gixmv and gixrm: byte-equal files where each should be
    def ensemble(root):
        base = os.path.basename(root)
        return {n: open(os.path.join(d, n), "rb").read()
                for n in sorted(os.listdir(d))
                if n == base + ".gix" or n.startswith(f".{base}.ktab.")}
    a = ensemble("A")
    tool("gixcp", ["-n", "A", "C"])
    c = ensemble("C")
    tool("gixmv", ["-n", "C", "D"])
    dd = ensemble("D")
    tool("gixrm", ["-f", "D"])
    ren = {k.replace("A", "{}", 1): v for k, v in a.items()}
    if len(a) < 2 or ensemble("A") != a or ensemble("C") or ensemble("D") \
            or {k.replace("C", "{}", 1): v for k, v in c.items()} != ren \
            or {k.replace("D", "{}", 1): v for k, v in dd.items()} != ren:
        raise SystemExit("tools: gixcp / gixmv / gixrm left other files")
    _, err = tool("gixxfer", [], rc=1)
    if "gixcp" not in err or "gixmv" not in err:
        raise SystemExit(f"tools: gixxfer's usage: {err}")
    # the repeat intervals as BED, through bedtoano and back
    bed = "".join(f"{g1.scaffolds[m.contig].header}\t{m.beg}\t{m.end}\t\t0"
                  f"\t+\n" for m in sorted(iv1, key=lambda m: (m.contig,
                                                              m.beg)))
    with open(os.path.join(d, "rep.bed"), "w") as f:
        f.write(bed)
    tool("bedtoano", ["rep.bed", "A"])
    out, _ = tool("anotobed", ["rep.1ano"])
    if "".join(ln + "\n" for ln in out.splitlines()
               if not ln.startswith("#")) != bed:
        raise SystemExit("tools: bedtoano then anotobed differs from the "
                         "BED")
    out, _ = tool("anostat", ["rep.1ano"])
    m = re.search(r"There are ([\d,]+) ", out)
    if not m or int(m[1].replace(",", "")) != len(iv1):
        raise SystemExit(f"tools: anostat: {out[:300]}")
    out, _ = tool("anoshow", ["rep.1ano"])
    if sum(ln.startswith("[") for ln in out.splitlines()) != len(iv1):
        raise SystemExit("tools: anoshow does not list every interval")
    # fastks on the two FASTAs (indices built on the card) against fastks
    # on .gix files of the host build_gix (computed in a worker process)
    ks = os.path.join(d, "ks")
    os.makedirs(ks)
    for tag in "AB":
        shutil.copy(os.path.join(d, tag + ".fa"), ks)
    out, _ = tool("fastks", ["A.fa", "B.fa"], cwd=ks)
    host_out, host_times = host_tools
    if out != host_out or len(out.splitlines()) != KMER + 1:
        raise SystemExit(f"tools: fastks A.fa B.fa differs from fastks on "
                         f"the host build's .gix files:\n{out}\n{host_out}")
    log(f"tools: fastks histogram (the same on the host .gix files; host "
        f"{', '.join(f'{k} {v:.3f} s' for k, v in host_times.items())}, "
        f"in a worker process):\n" + out.rstrip())
    log(f"tools: {len(want)} contigs, {nbases:,} bases ({lower:,} in lower "
        f"case) back from gdbtofa; gdbstat and gdbshow -h {g1.ncontig} "
        f"contigs, {g1.seqtot:,} bp; {nshown} gixshow k-mers equal to the "
        f"sequence; gixcp / gixmv / gixrm byte-equal; {len(iv1):,} "
        f"intervals through bedtoano, anotobed, anostat and anoshow")
    smi = smi_line()
    for name, w in walls.items():
        log(f"  wall[{name}]: {w:.3f} s ({smi})")
    log(f"tools: phase {time.perf_counter() - t0:.1f} s")


# -- phase 13: the alignment tools and the ONEaln library ---------------------

ALN_DIR = os.path.join(CLI_DIR, "aln")
GOLD_DIR = os.path.join(HERE, "tests", "golden")
# tests/test_alnchain.py's option sets, each a key of golden/alnchain.json
CHAIN_CASES = (("default", []), ("s1000", ["-s1000"]),
               ("cf", ["-c0.1", "-f200"]), ("n3", ["-n3", "-s500"]))
PLOT_CASES = (([], "plot_default.eps"), (["-L", "-G"], "plot_LG.eps"),
              (["-S", "-W800"], "plot_SW_sel.eps"))
# tests/test_convert.py's ALNshow cases: (arguments before and after the
# .1aln, golden)
SHOW_CASES = (([], [], "ref_show_plain.txt"), (["-a"], [], "ref_show_a.txt"),
              (["-r", "-w60"], [], "ref_show_r_w60.txt"),
              (["-a", "-n"], [], "ref_show_a_n.txt"),
              ([], ["@1-", "@1"], "ref_show_sel_rev.txt"),
              (["-a", "-b0"], ["@1:0-12k"], "ref_show_a_b0_sel.txt"))
AT_SCALE_CIGARS = 1000


def golden(name):
    with open(os.path.join(GOLD_DIR, name)) as f:
        return f.read()


def rearranged_fasta(d):
    """tests/test_alnchain.py's rearranged pair (numpy rng 4242, five
    segments, B in two contigs) as A.fasta and B.fasta in ``d``."""
    rng = np.random.default_rng(4242)

    def mut(x, r=.04):
        x = x.copy()
        m = rng.random(len(x)) < r
        x[m] = (x[m] + rng.integers(1, 4, m.sum())) % 4
        return x

    def wrap(s):
        return "\n".join(s[i:i + 70] for i in range(0, len(s), 70))

    segs = [rng.integers(0, 4, n) for n in (8000, 6000, 7000, 5000, 9000)]
    A = np.concatenate(segs)
    B = np.concatenate([mut(segs[2]), mut(segs[0]), (3 - mut(segs[3]))[::-1],
                        mut(segs[0]), mut(segs[4]), mut(segs[1][:3000]),
                        mut(segs[1][2000:])])
    text = lambda x: "".join("acgt"[v] for v in x)
    cut = len(B) // 2
    paths = os.path.join(d, "A.fasta"), os.path.join(d, "B.fasta")
    with open(paths[0], "w") as f:
        f.write(">a1\n" + wrap(text(A)) + "\n")
    with open(paths[1], "w") as f:
        f.write(">b1\n" + wrap(text(B[:cut])) + "\n>b2\n"
                + wrap(text(B[cut:])) + "\n")
    return paths


def record_fields(o):
    return (o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos,
            bool(o.bcomp), o.diffs, tuple(map(tuple, o.trace)))


def first_difference(want, got):
    """The first record and field where two record lists differ."""
    names = ("aread", "abpos", "aepos", "bread", "bbpos", "bepos", "bcomp",
             "diffs", "trace")
    for i, (w, g) in enumerate(zip(want, got)):
        for n, a, b in zip(names, record_fields(w), record_fields(g)):
            if a != b:
                return f"record {i} {n}: {a} against {b}"
    return f"{len(want)} records against {len(got)}"


def aln_check(what, ok):
    if not ok:
        raise SystemExit(f"aln tools: {what}")


def oneview_data(path):
    """The data lines of a ONEcode file (oneview -h)."""
    return run_cli("oneview", ["-h", path])[0]


def aln_goldens(d, walls):
    """Phase 13 (a): the C goldens through the tools, on the rearranged
    pair aligned by fastga on the card and on phase 9's E/F .1aln."""
    from fastga_tpu_torch import api
    from fastga_tpu_torch.io import alncode
    from fastga_tpu_torch.ops import cuda_build

    def tool(name, argv, out_path=None):
        out, err, walls[name] = run_cli(name.split()[0], argv, out_path)
        return out, err

    A, B = rearranged_fasta(d)
    rr = os.path.join(d, "rr.1aln")
    cuda_build.reset_launches()
    tool("fastga rr", [f"-1:{rr}", A, B])
    launches = dict(cuda_build.LAUNCHES)
    aln_check(f"fastga on the rearranged pair launched {launches}",
              all(launches[k] > 0 for k in KERNELS))
    tool("fastga -Eref rr", ["-Eref", f"-1:{d}/rr_ref", A, B])
    card, ref = read_records(rr), read_records(os.path.join(d, "rr_ref.1aln"))
    aln_check(f"the card's records on the rearranged pair differ from "
              f"-Eref's: {first_difference(ref, card)}",
              list(map(record_fields, card)) == list(map(record_fields, ref)))

    chain_gold = json.loads(golden("alnchain.json"))
    for tag, flags in CHAIN_CASES:
        out = os.path.join(d, f"rr.{tag}.1aln")
        tool(f"alnchain {tag}", flags + [f"-o{out}", rr])
        got = [list(record_fields(o)[:6]) for o in read_records(out)]
        aln_check(f"alnchain {tag} differs from golden/alnchain.json",
                  got == chain_gold[tag])
    paf = os.path.join(d, "rrx.paf")
    tool("alntopaf -x", ["-x", rr], out_path=paf)
    imp = os.path.join(d, "imp")
    os.makedirs(imp)
    shutil.copy(paf, os.path.join(imp, "rr.paf"))
    tool("paftoaln", [os.path.join(imp, "rr.paf"), A, B])
    got = [list(record_fields(o)[:6]) + [int(o.bcomp), o.diffs]
           for o in read_records(os.path.join(imp, "rr.1aln"))]
    aln_check("paftoaln differs from golden/paftoaln.json",
              got == json.loads(golden("paftoaln.json")))
    psl, _ = tool("paftopsl", [paf])
    aln_check("paftopsl differs from golden/paftopsl.txt",
              psl == golden("paftopsl.txt"))
    aln_check("alntopsl differs from the PAF -> PSL route",
              tool("alntopsl rr", [rr])[0] == psl)
    for args, name in PLOT_CASES:
        sel = ["@1-", "@1"] if name == "plot_SW_sel.eps" else []
        eps, _ = tool(f"alnplot {name}", args + [rr] + sel)
        aln_check(f"alnplot {' '.join(args)} differs from golden/{name}",
                  eps == golden(name))
    log(f"aln tools: the rearranged pair through fastga on the card "
        f"({len(card)} records, equal to -Eref's; launches "
        f"{json.dumps(launches)}): alnchain x{len(CHAIN_CASES)}, paftoaln, "
        f"paftopsl, alntopsl and alnplot x{len(PLOT_CASES)} equal to the C "
        f"goldens")

    run_dir = os.path.join(CLI_DIR, "run")
    ef = os.path.join(run_dir, "EvF.1aln")
    for pre, post, name in SHOW_CASES:
        text, _ = tool(f"alnshow {name}", pre + [ef] + post)
        aln_check(f"alnshow {' '.join(pre + post)} differs from golden/{name}",
                  text == golden(name).replace("\nours:", "\nEvF:"))
    aln_check("alntopsl EvF differs from golden/ref_psl.txt",
              tool("alntopsl EvF", [ef])[0] == golden("ref_psl.txt"))
    # oneview: binary -> ASCII -> binary -> ASCII keeps every data line
    # and the records
    a1, b1, a2 = (os.path.join(d, n) for n in ("a1.1aln", "b1.1aln",
                                                 "a2.1aln"))
    tool("oneview", ["-o", a1, ef])
    tool("oneview -b", ["-b", "-o", b1, a1])
    tool("oneview back", ["-o", a2, b1])
    with open(a1) as f:
        aln_check("oneview -o wrote binary", f.read(6) == "1 3 al")
    data = oneview_data(ef)
    aln_check("oneview ASCII -> binary -> ASCII changed the data lines",
              oneview_data(a1) == oneview_data(a2) == oneview_data(b1) == data
              and list(map(record_fields, read_records(b1)))
              == list(map(record_fields, read_records(ef))))
    # alnreset: new source lines, the same data lines
    rs = os.path.join(d, "reset.1aln")
    shutil.copy(ef, rs)
    e_fa, f_fa = (os.path.join(run_dir, n) for n in ("E.fasta", "F.fasta"))
    tool("alnreset", [rs, e_fa, f_fa])
    af = alncode.read_aln(rs)
    aln_check("alnreset did not rewrite the source lines or changed the data",
              (af.db1_name, af.db2_name) == (e_fa, f_fa)
              and oneview_data(rs) == data)
    # AlnReader on the ONEalnTEST capture
    gdir = os.path.join(GOLD_DIR, "onealn")
    gold = json.loads(golden(os.path.join("onealn", "oracle.json")))
    t0 = time.perf_counter()
    r = api.AlnReader(os.path.join(gdir, "apigold.1aln"))
    aln_check("AlnReader count", r.count == len(gold["cig_f"]))
    for i in range(r.count):
        rec = r[i]
        buf = io.StringIO()
        rec.show_alignment(buf, indent=8, width=100, border=10, coord=9,
                           reversed=True)
        got = (rec.cigar(show_x=True), rec.cigar(show_x=True, reversed=True),
               rec.cs_tag(False, False), rec.cs_tag(False, True),
               " ".join(map(str, rec.indel_array(False))),
               " ".join(map(str, rec.indel_array(True))))
        want = tuple(gold[k][i] for k in ("cig_f", "cig_r", "cs_f", "cs_r",
                                          "ind_f", "ind_r"))
        shown = buf.getvalue().rstrip("\n").split("\n")
        aln_check(f"AlnReader record {i} differs from onealn/oracle.json",
                  got == want
                  and shown == gold["show_r"][i].split("\n")[:len(shown)])
    walls["AlnReader apigold"] = time.perf_counter() - t0
    log(f"aln tools: EvF.1aln through alnshow x{len(SHOW_CASES)} and alntopsl "
        f"equal to the C goldens; oneview ASCII <-> binary and alnreset keep "
        f"its {data.count(chr(10))} data lines; AlnReader on apigold.1aln "
        f"equal to onealn/oracle.json ({r.count} records)")


_CIGAR = re.compile(r"(\d+)([MIDX=])")
_CS = re.compile(r"([=*+\-])([a-z]+)")


def cigar_spans(cg):
    """(seq1, seq2) bases an ONEaln CIGAR consumes: M, X, = and D the
    first, M, X, = and I the second."""
    ops = _CIGAR.findall(cg)
    return (sum(int(n) for n, op in ops if op in "MX=D"),
            sum(int(n) for n, op in ops if op in "MX=I"))


def cs_spans(cs):
    """(seq1, seq2) bases an ONEaln CS tag consumes: '=' runs both, '*'
    pairs one each, '-' the first, '+' the second."""
    a = b = 0
    for op, s in _CS.findall(cs):
        n = len(s) // 2 if op == "*" else len(s)
        a += n if op in "=*-" else 0
        b += n if op in "=*+" else 0
    return a, b


def aln_at_scale(d, walls):
    """Phase 13 (b): the tools on phase 9's repeat-rich .1aln (the
    main path's records, written by fastga on the card), held to
    invariants."""
    from fastga_tpu_torch import api
    rr = os.path.join(CLI_DIR, "run", "repeatrich.1aln")
    t0 = time.perf_counter()
    reader = api.AlnReader(rr)
    walls["AlnReader open"] = time.perf_counter() - t0
    aln_check(f"AlnReader counts {reader.count} records",
              reader.count == REPEAT_RICH_EXPECT[0])
    ovls = reader._af.overlaps
    t0 = time.perf_counter()
    for i in range(AT_SCALE_CIGARS):
        rec = reader[i]
        spans = (rec.epos1 - rec.bpos1, abs(rec.epos2 - rec.bpos2))
        cg, cs = rec.cigar(), rec.cs_tag()
        aln_check(f"record {i}: CIGAR spans {cigar_spans(cg)}, CS spans "
                  f"{cs_spans(cs)}, the record's {spans}",
                  cigar_spans(cg) == cs_spans(cs) == spans)
    walls[f"cigar + cs_tag x{AT_SCALE_CIGARS}"] = time.perf_counter() - t0

    out = os.path.join(d, "repeatrich.chain.1aln")
    _, err, walls["alnchain"] = run_cli("alnchain", [f"-o{out}", rr])
    kept = read_records(out)
    m = re.search(r"retained (\d+) alignments in (\d+) chains", err)
    inputs = set(map(record_fields, ovls))
    aln_check(f"alnchain keeps {len(kept)} records ({err.strip()}), each an "
              f"input record: {all(record_fields(o) in inputs for o in kept)}",
              m and int(m[1]) == len(kept) > 0
              and all(record_fields(o) in inputs for o in kept))

    eps = os.path.join(d, "repeatrich.eps")
    _, _, walls["alnplot"] = run_cli("alnplot", [rr], out_path=eps)
    with open(eps) as f:
        nseg = sum(ln.endswith(" L\n") for ln in f)
    # alnplot's defaults: both spans at least 100 bases, identity at least
    # 0.7, and no length threshold under 100,000 records
    passing = sum(
        o.aepos - o.abpos >= 100 and o.bepos - o.bbpos >= 100
        and 2.0 * ((o.aepos - o.abpos + o.bepos - o.bbpos - o.diffs) // 2)
        / (o.aepos - o.abpos + o.bepos - o.bbpos) >= 0.7 for o in ovls)
    aln_check(f"the EPS holds {nseg} segments for {passing} records past the "
              f"filter", nseg == passing)

    show, _, walls["alnshow @1"] = run_cli("alnshow", [rr, "@1"])
    lines = show.splitlines()[2:]
    want = sum(rec.seq1 == 1 for rec in reader)
    aln_check(f"alnshow @1 lists {len(lines)} records, scaffold 1 has {want}",
              len(lines) == want > 0)
    log(f"aln tools at scale: repeatrich.1aln ({reader.count:,} records): "
        f"alnchain keeps {len(kept):,} in {m[2]} chains, each an input "
        f"record; the EPS {nseg:,} segments, one a record past the filter; "
        f"alnshow @1 {len(lines):,} records; {AT_SCALE_CIGARS:,} CIGARs and "
        f"CS tags with the records' spans")


def phase_alntools():
    """Phase 13: the alignment tools and the ONEaln library, in process,
    on the .1aln files fastga writes on the card."""
    t0 = time.perf_counter()
    shutil.rmtree(ALN_DIR, ignore_errors=True)
    os.makedirs(ALN_DIR)
    walls = {}
    aln_goldens(ALN_DIR, walls)
    t_a = time.perf_counter() - t0
    aln_at_scale(ALN_DIR, walls)
    smi = smi_line()
    for name, w in walls.items():
        log(f"  wall[{name}]: {w:.3f} s ({smi})")
    log(f"aln tools: phase {time.perf_counter() - t0:.1f} s (goldens "
        f"{t_a:.1f} s)")


# -- phase 14: the sharded seed route (fastga_tpu_torch/parallel) ------------

SHARD_DIR = os.path.join(HERE, "fastga_tpu_torch", "_build", "sharded")
# seconds a group of spawned ranks may take, and a collective may wait
SHARD_TIMEOUT = 300
SHARD_SPANS = ("devpipe.gix1", "devpipe.gix2", "devpipe.exchange",
               "devpipe.merge", "devpipe.chain")


def free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def timed_route(fn, *args, **kw):
    """One call on the card: (result, seconds, peak device memory above
    the allocation at its start, GiB)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - base) / 2**30)


def sharded_seeds(mesh, g1, g2):
    """sharded_tubes on the card with the spans on: (result, seconds, peak
    GiB, {span: seconds})."""
    from fastga_tpu_torch.parallel import sharded
    from fastga_tpu_torch.utils import prof
    prof.ENABLED = True
    prof.reset()
    try:
        res, dt, peak = timed_route(sharded.sharded_tubes, g1, g2,
                                    alens_of(g1), mesh)
        rep = prof.report()
    finally:
        prof.ENABLED = False
    return res, dt, peak, {k: rep[k][0] for k in SHARD_SPANS if k in rep}


def sharded_one(gs_rr, rr_tubes, host_self, run_rr):
    """Phase 14 (a): a one-rank NCCL group in this process.  The
    repeat-rich pair through sharded_tubes gives phase 5's TubeBatch, A as
    self the host path's self TubeBatch (phase 10's), and
    align_genomes(mesh=) phase 5's records with stats["sharded"] == 1 and
    every kernel launched.  Returns the launches and the capture of the
    seed kernels' inputs (part d)."""
    import datetime

    import torch.distributed as td

    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.parallel import sharded
    td.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1,
        rank=0, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT))
    try:
        mesh = sharded.make_mesh(1)
        if (mesh.backend, mesh.device.type) != ("nccl", "cuda"):
            raise SystemExit(f"sharded D=1: mesh {mesh}")
        # NCCL sets its communicator up at the first collective
        t0 = time.perf_counter()
        td.barrier()
        log(f"sharded D=1: NCCL communicator set-up (the first "
            f"collective) {time.perf_counter() - t0:.3f} s")
        g1, g2 = gs_rr[:2]
        with SeedCapture() as cap:
            got, dt, peak, spans = sharded_seeds(mesh, g1, g2)
            same_tubes("sharded D=1 repeatrich", rr_tubes, got,
                       "phase 5 device_tubes")
            log(f"sharded D=1 repeatrich: sharded_tubes {dt:.3f} s, peak "
                f"device memory {peak:.3f} GiB, spans {json.dumps(spans)}")
            got, dt, peak, spans = sharded_seeds(mesh, g1, None)
            check_host_self(got, host_self)
            log(f"sharded D=1 self: sharded_tubes {dt:.3f} s, peak device "
                f"memory {peak:.3f} GiB, spans {json.dumps(spans)}")
            cuda_build.reset_launches()
            ovls, stats, wall = run_main_path("sharded1", g1, g2, mesh=mesh)
            launches = dict(cuda_build.LAUNCHES)
        digest = records_digest(ovls)
        del ovls
        check_launches("sharded1", launches)
        check_seeds("sharded1", stats, REPEAT_RICH_SEEDS)
        if (stats.get("sharded") != 1 or digest != run_rr["digest"]
                or (stats["nlive"], stats["cov"]) != REPEAT_RICH_EXPECT):
            same = digest == run_rr["digest"]
            raise SystemExit(f"sharded1: stats {stats}; records "
                             f"{'equal' if same else 'differ'}")
        log(f"sharded D=1: align_genomes(mesh=) {wall:.3f} s, "
            f"{stats['nlive']:,} records equal to phase 5's, "
            f"stats['sharded'] {stats['sharded']}")
    finally:
        td.destroy_process_group()
    return launches, cap


def graft_pool(nt, seqlen, seed=7):
    """__graft_entry__.py's synthetic tubes (``_synthetic``): nt pairs of
    seqlen bases, B 2% mutated, in one pool; (pool words as int32, aw, bw,
    lengths)."""
    from fastga_tpu_torch.ops import seqpack
    rng = np.random.default_rng(seed)
    seqs = {}
    for i in range(nt):
        A = rng.integers(0, 4, seqlen).astype(np.uint8)
        B = A.copy()
        mut = rng.random(seqlen) < 0.02
        B[mut] = (B[mut] + rng.integers(1, 4, mut.sum())) % 4
        seqs[("A", i)] = A
        seqs[("B", i)] = B
    pool = seqpack.SeqPool.build(seqs)
    aw = np.array([pool.offs[("A", i)][0] for i in range(nt)], np.int32)
    bw = np.array([pool.offs[("B", i)][0] for i in range(nt)], np.int32)
    return (np.asarray(pool.words, np.uint32).view(np.int32), aw, bw,
            np.full(nt, seqlen, np.int32))


def mesh_steps(mesh):
    """mesh.py's three steps at __graft_entry__.py's shapes (4 tubes of
    2 kb a rank at W=64 and 8 waves; 4,096 bases a rank; [D, D, 8, 4]
    seed blocks), each against the same computation on one rank: the
    whole batch through the plain kernel versions on the host, every
    shard's syncmers by numpy, the exchange as a transpose.  Returns what
    differs and the live count."""
    import torch

    from fastga_tpu_torch.ops import syncmer, wave, wave_kernels as wk
    from fastga_tpu_torch.ops.wave_ref import AlignSpec
    from fastga_tpu_torch.parallel import mesh as pmesh
    D, r = mesh.size, mesh.rank
    nt = 4 * D
    words, aw, bw, ln = graft_pool(nt, 2048)
    cols = [torch.as_tensor(x) for x in (
        words, aw, ln, bw, ln, np.full(nt, -2, np.int32),
        np.full(nt, 2, np.int32), np.full(nt, 2048, np.int32))]
    spec = AlignSpec(0.7)
    cfg = wave.WaveConfig(n=4, w=64, chunk=8, max_chunks=2)
    trima, alive = pmesh.sharded_wave_step(
        pmesh.make_mesh(D, device=mesh.device), spec, cfg)(*cols)
    pool, aw_, ln_, bw_, _, dgmin, dgmax, anti = cols
    targs = (aw_, ln_, bw_, ln_, torch.full_like(aw_, -(1 << 30)),
             torch.full_like(aw_, 1 << 30))
    st = wk.wave0(pool, targs, dgmin, dgmax, anti, torch.ones_like(aw_),
                  cfg.w, +1)
    st, _, _ = wk.wave_chunk(pool, targs, st, spec, +1, cfg.chunk)
    bad = []
    if not np.array_equal(trima.cpu().numpy().astype(np.int64),
                          st[10][4 * r:4 * (r + 1)].numpy()
                          .astype(np.int64)) \
            or int(alive) != int(st[15].sum()):
        bad.append("wave step")
    bases = np.random.default_rng(3).integers(0, 4, (D, 1, 4096)) \
        .astype(np.int32)
    hist = pmesh.sharded_seed_histogram(mesh)(
        torch.as_tensor(bases), torch.full((D, 1), 4096, dtype=torch.int32))
    want = np.zeros(1024, np.int64)
    for b in bases[:, 0].astype(np.int64):
        b10 = (b[:-4] << 8) | (b[1:-3] << 6) | (b[2:-2] << 4) \
            | (b[3:-1] << 2) | b[4:]
        want += np.bincount(b10[syncmer.syncmer_positions(
            b.astype(np.uint8))], minlength=1024)
    if not np.array_equal(hist.cpu().numpy(), want[None]):
        bad.append("histogram")
    seeds = np.arange(D * D * 8 * 4, dtype=np.int32).reshape(D, D, 8, 4)
    ex = pmesh.sharded_seed_exchange(mesh, D)(torch.as_tensor(seeds))
    if not np.array_equal(ex.cpu().numpy(), seeds[:, r][None]):
        bad.append("exchange")
    return bad, int(alive)


def shard_rank(D, rank, port, scenario, out_dir):
    """One rank of phase 14 (b)/(c), a spawned process on the card: a gloo
    group (ranks that share a card), the scenario's pair through
    sharded_tubes and align_genomes(mesh=), at (c) mesh.py's steps; its
    results, peak device memory and times to a file."""
    import pickle

    import torch
    import torch.distributed as td

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.parallel import distributed
    t0 = time.perf_counter()
    if not distributed.init(f"127.0.0.1:{port}", D, rank,
                            timeout=SHARD_TIMEOUT):
        raise SystemExit("distributed.init found no configuration")
    mesh = distributed.global_mesh()
    if (mesh.backend, mesh.device.type, mesh.size) != ("gloo", "cuda", D):
        raise SystemExit(f"rank {rank}: mesh {mesh}")
    g1, g2 = (uniform_gdbs() if scenario == "uniform"
              else repeat_rich(REPEAT_RICH_MBP)[:2])
    cuda_build.build_kernels()
    td.barrier()
    t_ready = time.perf_counter() - t0
    got, t_seed, peak_seed, spans = sharded_seeds(mesh, g1, g2)
    cuda_build.reset_launches()
    (ovls, stats), t_align, peak_align = timed_route(
        aligner.align_genomes, g1, g2, mesh=mesh)
    launches = dict(cuda_build.LAUNCHES)
    out = dict(tubes=got, digest=records_digest(ovls),
               records=(len(ovls), sum(o.aepos - o.abpos for o in ovls)),
               stats={k: v for k, v in stats.items()
                      if isinstance(v, (int, float, str))},
               launches=launches, t_ready=t_ready, t_seed=t_seed,
               t_align=t_align, peak_seed=peak_seed, peak_align=peak_align,
               spans=spans)
    del ovls
    if scenario == "uniform":
        out["mesh"] = mesh_steps(mesh)
    with open(os.path.join(out_dir, f"{scenario}{D}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    td.barrier()
    td.destroy_process_group()


def spawn_ranks(D, scenario):
    """D spawned ranks on the one card (the parent holds a CUDA context, so
    not forked); any rank that fails, or a group past SHARD_TIMEOUT, stops
    them all and the script.  Returns each rank's results and the wall."""
    import multiprocessing
    import pickle
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    os.makedirs(SHARD_DIR)
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    ps = [ctx.Process(target=shard_rank,
                      args=(D, r, port, scenario, SHARD_DIR))
          for r in range(D)]
    for p in ps:
        p.start()
    try:
        while any(p.is_alive() for p in ps):
            if any(p.exitcode not in (None, 0) for p in ps) \
                    or time.perf_counter() - t0 > SHARD_TIMEOUT:
                break
            time.sleep(0.5)
    finally:
        for p in ps:
            if p.is_alive():
                p.terminate()
            p.join()
    codes = [p.exitcode for p in ps]
    if codes != [0] * D:
        raise SystemExit(f"sharded {scenario} D={D}: ranks exited {codes} "
                         f"after {time.perf_counter() - t0:.1f} s")
    res = []
    for r in range(D):
        with open(os.path.join(SHARD_DIR, f"{scenario}{D}_{r}.pkl"),
                  "rb") as f:
            res.append(pickle.load(f))
    return res, time.perf_counter() - t0


def check_ranks(what, res, want_tubes, run, expect, wall):
    """Every rank's TubeBatch, records and stats against the single-device
    run's; logs each rank's times, peak memory and spans."""
    D = len(res)
    for r, o in enumerate(res):
        same_tubes(f"{what} rank {r}", want_tubes, o["tubes"],
                   "single-device route")
        st = o["stats"]
        if (o["digest"] != run["digest"] or o["records"] != expect
                or st.get("sharded") != D
                or st.get("seed_pipeline") != "device"):
            raise SystemExit(f"{what} rank {r}: records {o['records']} "
                             f"(digest equal: {o['digest'] == run['digest']})"
                             f", stats {st}")
        log(f"  {what} rank {r}: ready {o['t_ready']:.1f} s; sharded_tubes "
            f"{o['t_seed']:.3f} s, peak device memory {o['peak_seed']:.3f} "
            f"GiB, spans {json.dumps(o['spans'])}; align_genomes(mesh=) "
            f"{o['t_align']:.3f} s, peak {o['peak_align']:.3f} GiB; "
            f"launches {json.dumps(o['launches'])}")
    log(f"{what}: {D} gloo ranks on one card, every rank's TubeBatch and "
        f"{expect[0]:,} records ({expect[1]:,} bp) equal to the "
        f"single-device run's, stats['sharded'] {D}; the route's wall "
        f"{wall:.1f} s (the ranks' start included)")


def phase_sharded(gs_rr, rr_tubes, u_tubes, host_self, run_rr, run_u):
    """Phase 14: the sharded seed route.  (a) one NCCL rank in this
    process; (b) two gloo ranks sharing the card, repeat-rich; (c) four,
    uniform, and mesh.py's steps; (d) merge_path and fused_scan against
    their plain versions on the largest inputs (a) gave them."""
    import torch
    t0 = time.perf_counter()
    log("sharded route: every run below is on ONE card; no run across "
        "several cards was made (NCCL between cards and the exchange's "
        "cost over NVLink are not measured)")
    launches, cap = sharded_one(gs_rr, rr_tubes, host_self, run_rr)
    t_a = time.perf_counter() - t0
    merge, scan = {}, {}
    cap.fold_into(merge, scan)
    del cap
    torch.cuda.empty_cache()
    res, wall = spawn_ranks(2, "repeatrich")
    check_ranks("sharded D=2 repeatrich", res, rr_tubes, run_rr,
                REPEAT_RICH_EXPECT, wall)
    res, wall = spawn_ranks(4, "uniform")
    check_ranks("sharded D=4 uniform", res, u_tubes, run_u, UNIFORM_EXPECT,
                wall)
    for r, o in enumerate(res):
        bad, alive = o["mesh"]
        if bad:
            raise SystemExit(f"mesh.py at 4 ranks, rank {r}: {bad} differ "
                             f"from one rank's computation")
    log(f"mesh.py at 4 ranks: sharded_wave_step ({alive} live tubes of 16), "
        f"sharded_seed_histogram and sharded_seed_exchange equal to one "
        f"rank's computation on every rank")
    kern = seed_kernel_rows(merge, scan, "sharded")
    log(f"sharded route: phase {time.perf_counter() - t0:.1f} s ((a) "
        f"{t_a:.1f} s)")
    return launches, kern


def _params(**kw):
    from fastga_tpu_torch.models import aligner
    return aligner.FastGAParams(**kw)


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if argv[:1] == ["--time-wave"] and len(argv) == 2:
        time_wave(argv[1])
        return 0
    if argv[:1] == ["--compare"] and len(argv) == 2:
        return compare_trees(argv[1])
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from fastga_tpu_torch.ops import cuda_build
    from fastga_tpu_torch.ops.wave_ref import AlignSpec
    t0 = time.perf_counter()
    pool, pending = start_host_references(REPEAT_RICH_MBP)
    try:
        cuda_build.build_kernels()
    except BaseException:
        pool.terminate()
        raise
    log(f"kernel build ({len(KERNELS)} sources): "
        f"{time.perf_counter() - t0:.1f} s")
    refs = join_host_references(pool, pending, t0)
    for name in KERNELS:
        p = os.path.join(cuda_build.BUILD, name + ".ptxas.txt")
        if os.path.exists(p):
            for line in open(p).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    def done(phase):
        log(f"[{time.perf_counter() - t0:.1f} s] phase {phase} done")

    spec = AlignSpec(0.7, 100, False, (0.25, 0.25, 0.25, 0.25))
    kern = phase_kernels(spec)
    done(2)
    phase_rescue()
    done(3)
    launches, cap_u, run_u = phase_uniform()
    done(4)
    launches_rr, cap_rr, run_rr, gs_rr = phase_repeatrich(REPEAT_RICH_MBP)
    done(5)
    kern.update(phase_seed_kernels(cap_u, cap_rr))
    u_ref = (cap_u.tubes, cap_u.tubes_args)
    rr_ref = (cap_rr.tubes, cap_rr.tubes_args)
    del cap_u, cap_rr
    done(6)
    phase_exact()
    done(7)
    phase_profile()
    done(8)
    phase_cli(run_u, run_rr, gs_rr)
    done(9)
    host_self = refs.pop("self")
    launches_s, launches_b, _ = phase_seed_routes(
        gs_rr[0], rr_ref, u_ref, host_self)
    u_tubes = u_ref[0]
    del u_ref
    done(10)
    host_tools = refs.pop("tools")
    launches_m, _ = phase_masks(gs_rr, refs)
    del refs
    done(11)
    launches_c = phase_past_caps(gs_rr, rr_ref, run_rr, run_u)
    rr_tubes = rr_ref[0]
    del rr_ref
    phase_tools(gs_rr, host_tools)
    done(12)
    phase_alntools()
    done(13)
    launches_sh, _ = phase_sharded(gs_rr, rr_tubes, u_tubes, host_self,
                                   run_rr, run_u)
    del gs_rr, rr_tubes, u_tubes, host_self
    done(14)

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
            launches=launches[name] + launches_sh[name],
            max_abs_err=k["max_abs_err"],
            ms=k["ms"], plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
            bound_by=k["bound_by"], library_ms=None,
            equal=k["max_abs_err"] == 0))
    log(f"launches (uniform / repeatrich / self / uniform128 / masked -M "
        f"/ symmetric -S): " + ", ".join(
            f"{n} {launches[n]} / {launches_rr[n]} / {launches_s[n]} / "
            f"{launches_b[n]} / {launches_m['-M'][n]} / "
            f"{launches_m['-S'][n]}" for n in KERNELS))
    log("launches of the sharded route (phase 14 (a), align_genomes(mesh=) "
        "at world size 1): " + json.dumps(launches_sh))
    log("launches past the caps (chain panels / contig windows; GIX "
        "entries past N / panel tables): "
        + ", ".join(f"{n} " + " / ".join(str(launches_c[c].get(n, 0))
                                         for c in launches_c)
                    for n in KERNELS))
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
    sys.exit(main(sys.argv[1:]))
