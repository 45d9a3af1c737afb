"""The port's BatchAligner (plain kernels on the CPU) against the JAX
package's exact scalar engine, wave_ref.local_alignment: every field and
the trace, exactly."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.ops import wave_ref as jwr
from fastga_tpu.utils import dna
from fastga_tpu_torch.ops import seqpack, wave as tw, wave_batch as tb
from fastga_tpu_torch.ops.wave_ref import AlignSpec
from tests.test_wave_device import make_cases
from tests.test_wave_pallas import _mutate


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def specs():
    return jwr.AlignSpec(0.7), AlignSpec(0.7)


def _same(p, q, i):
    assert (p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs) == \
        (q.abpos, q.bbpos, q.aepos, q.bepos, q.diffs), i
    assert [tuple(t) for t in p.trace] == [tuple(t) for t in q.trace], i


def test_batch_aligner_matches_local_alignment(specs):
    jspec, spec = specs
    rng = np.random.default_rng(0xFA57A)
    cases = make_cases(rng, 12)
    seqs = {}
    for i, (A, B) in enumerate(cases):
        seqs[("A", i)] = A
        seqs[("Ar", i)] = dna.revcomp(A)
        seqs[("B", i)] = B
    pool = seqpack.SeqPool.build(seqs)
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    ba = tb.BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                         cfg, device="cpu")
    items, refs = [], []
    for i, (A, B) in enumerate(cases):
        acomp = i % 4 == 3
        anti = int((len(A) // 2 + rng.integers(-200, 200)) * 2)
        dgmin, dgmax = int(rng.integers(-40, 0)), int(rng.integers(1, 40))
        akey = ("Ar" if acomp else "A", i)
        items.append(tb.WorkItem(akey, ("B", i), dgmin, dgmax, anti, acomp,
                                 len(A), len(B)))
        refs.append(jwr.local_alignment(jspec, seqs[akey], B, dgmin, dgmax,
                                        anti, -1, -1, selfie=False,
                                        acomp=acomp, alen=len(A),
                                        blen=len(B)))
    paths = ba.run(items)
    for i, (p, q) in enumerate(zip(refs, paths)):
        _same(p, q, i)


def test_requeue_long_lane_exact(specs):
    """Under-predicted wide batches hand their stragglers to the narrow
    sibling engine (requeues > 0) without changing any result."""
    jspec, spec = specs
    rng = np.random.default_rng(0xFA57A)
    cases = make_cases(rng, 10)
    seqs = {}
    for i, (A, B) in enumerate(cases):
        seqs[("A", i)] = A
        seqs[("B", i)] = B
    pool = seqpack.SeqPool.build(seqs)
    cfg = tw.WaveConfig(n=64, w=256, chunk=16, max_chunks=256)
    eng = tw.WaveEngine(spec, cfg, "cpu")
    eng._small = tw.WaveEngine(spec, tw.WaveConfig(n=32, w=256, chunk=16,
                                                   max_chunks=256), "cpu")
    ba = tb.BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                         cfg, engine=eng)
    refs, first = [], []
    for i, (A, B) in enumerate(cases):
        anti = int((len(A) // 2 + rng.integers(-200, 200)) * 2)
        dgmin, dgmax = int(rng.integers(-40, 0)), int(rng.integers(1, 40))
        # hint=5 waves: far below the need of the divergent pairs
        first.append((i, tb.WorkItem(("A", i), ("B", i), dgmin, dgmax, anti,
                                     False, len(A), len(B), waves_hint=5)))
        refs.append(jwr.local_alignment(jspec, A, B, dgmin, dgmax, anti,
                                        -1, -1, selfie=False, acomp=False,
                                        alen=len(A), blen=len(B)))
    got = {}

    def more_fn(token, p, waves=-1):
        got[token] = p
        return []

    ba.run_stream(first, more_fn)
    assert ba.stats["requeues"] > 0, ba.stats
    for i, p in enumerate(refs):
        _same(p, got[i], i)


def test_band_overflow_rescue_lane(specs):
    """A max_chunks=1 main engine exhausts its budget: the tubes go to the
    W=512 rescue lane and still match the scalar reference."""
    jspec, spec = specs
    rng = np.random.default_rng(11)
    A = rng.integers(0, 4, 8000).astype(np.uint8)
    B = _mutate(A, 0.08, rng)
    seqs = {("a", 0, False): A, ("b", 0): B}
    pool = seqpack.SeqPool.build(seqs)
    cfg = tw.WaveConfig(n=32, w=256, chunk=96, max_chunks=1)
    ba = tb.BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                         cfg, device="cpu")
    items = [tb.WorkItem(("a", 0, False), ("b", 0), -10, 10,
                         1000 + 4000 * i, False, len(A), len(B))
             for i in range(3)]
    got = {}
    ba.run_stream([(i, it) for i, it in enumerate(items)],
                  lambda tok, p, waves=-1: got.__setitem__(tok, p) or [])
    assert ba.stats.get("rescued", 0) > 0, ba.stats
    for i, it in enumerate(items):
        ref = jwr.local_alignment(jspec, A, B, it.dgmin, it.dgmax, it.anti,
                                  -1, -1)
        _same(ref, got[i], i)


def test_wide_band_overflow_rescue_lane(specs):
    """Tubes whose starting band spans W-5 or more diagonals overflow the
    W=256 band on their first wave (fall_band): the W=512 rescue lane
    takes them and still matches the scalar reference."""
    from fastga_tpu_torch.utils import synth
    jspec, spec = specs
    rng = np.random.default_rng(11)
    A = rng.integers(0, 4, 8000).astype(np.uint8)
    B = synth.mutate(rng, A, 0.08, indel_frac=0.4)
    seqs = {("a", 0, False): A, ("b", 0): B}
    pool = seqpack.SeqPool.build(seqs)
    cfg = tw.WaveConfig(n=32, w=256, chunk=96, max_chunks=64)
    ba = tb.BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                         cfg, device="cpu")
    items = [tb.WorkItem(("a", 0, False), ("b", 0), -h, h, 1000 + 4000 * i,
                         False, len(A), len(B))
             for i, h in enumerate((125, 126))]
    got = {}
    ba.run_stream([(i, it) for i, it in enumerate(items)],
                  lambda tok, p, waves=-1: got.__setitem__(tok, p) or [])
    assert ba.stats.get("fall_band", 0) > 0, ba.stats
    assert ba.stats.get("rescued", 0) > 0, ba.stats
    for i, it in enumerate(items):
        ref = jwr.local_alignment(jspec, A, B, it.dgmin, it.dgmax, it.anti,
                                  -1, -1)
        _same(ref, got[i], i)


def test_pool_tail_alignment_exact(specs):
    """A B sequence ending in the pool's last words aligns exactly (the
    fetch clamps at the pool end like the host mirror)."""
    jspec, spec = specs
    rng = np.random.default_rng(7)
    A = rng.integers(0, 4, 8000).astype(np.uint8)
    B = A.copy()
    idx = rng.integers(0, len(B), 640)
    B[idx] = (B[idx] + rng.integers(1, 4, 640)) % 4
    seqs = {("a", 0, False): A, ("b", 0): B}
    pool = seqpack.SeqPool.build(seqs)
    assert pool.offs[("b", 0)][0] + len(B) // 16 > len(pool.words) - 512
    cfg = tw.WaveConfig(n=8, w=256, chunk=96, max_chunks=64)
    ba = tb.BatchAligner(spec, pool.words, pool.offs, lambda k: seqs[k],
                         cfg, device="cpu")
    items = [tb.WorkItem(("a", 0, False), ("b", 0), -20, 20,
                         2000 + 6000 * i, False, len(A), len(B))
             for i in range(3)]
    got = {}
    ba.run_stream([(i, it) for i, it in enumerate(items)],
                  lambda tok, p, waves=-1: got.__setitem__(tok, p) or [])
    for i, it in enumerate(items):
        ref = jwr.local_alignment(jspec, A, B, it.dgmin, it.dgmax, it.anti,
                                  -1, -1)
        _same(ref, got[i], i)
