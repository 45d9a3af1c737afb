"""The port's align_genomes (plain kernels on the CPU, and its exact scalar
engine) against the JAX package's align_genomes(engine="ref"), record for
record: coordinates, diffs, strand and trace."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.io import gdb as jgdb
from fastga_tpu.models import aligner as jal
from fastga_tpu.utils import dna
from fastga_tpu_torch import convert
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import wave as tw
from tests.conftest import mutate
from tests.test_gdb import write_fasta


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(o):
    return (o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos, o.bcomp,
            o.diffs, [tuple(t) for t in o.trace])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A mutated 14 kb pair with an inversion: GDBs for both packages,
    and the JAX package's exact-engine records."""
    rng = np.random.default_rng(0xFA57A)
    a = rng.integers(0, 4, 14000).astype(np.uint8)
    b = mutate(rng, a, sub=0.03, ins=0.006, dele=0.006)
    b = np.concatenate([b[:4000], (3 - b[4000:8000])[::-1], b[8000:]])
    d = tmp_path_factory.mktemp("pair")
    write_fasta(d / "a.fa", [("a", dna.to_ascii(a, True).decode())])
    write_fasta(d / "b.fa", [("b", dna.to_ascii(b, True).decode())])
    g1, _ = jgdb.create_gdb(d / "a.fa", d / "a")
    g2, _ = jgdb.create_gdb(d / "b.fa", d / "b")
    ref, stats = jal.align_genomes(g1, g2, engine="ref")
    t1 = convert.gdb_from_arrays([g1.get_contig(0)], ["a"])
    t2 = convert.gdb_from_arrays([g2.get_contig(0)], ["b"])
    return t1, t2, ref, stats, (g1, g2)


def test_align_genomes_cpu_matches_jax_ref(pair):
    g1, g2, ref, jstats, _ = pair
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    got, stats = tal.align_genomes(g1, g2, device="cpu", cfg=cfg)
    assert len(ref) > 0
    assert [_key(o) for o in got] == [_key(o) for o in ref]
    assert stats["nhits"] == jstats["nhits"]
    assert stats["nlive"] == jstats["nlive"]
    assert stats["cov"] == jstats["cov"]


def test_ref_engine_matches_jax_ref(pair):
    g1, g2, ref, _, _ = pair
    got, _ = tal.align_genomes(g1, g2, engine="ref")
    assert [_key(o) for o in got] == [_key(o) for o in ref]


def test_host_tubes_and_spec_match_jax(pair):
    """The copied host seed path gives the JAX package's TubeBatch, and
    the AlignSpec tables carry across."""
    from fastga_tpu.io import gix as jgix
    from fastga_tpu.ops import chain as jchain, merge as jmerge
    from fastga_tpu.ops.wave_ref import AlignSpec as JSpec
    from fastga_tpu_torch.io import gix as tgix
    from fastga_tpu_torch.ops import chain as tchain, merge as tmerge
    g1, g2, _, _, (j1, j2) = pair

    def tubes(gixm, mergem, chainm, a, b):
        ta, tb = gixm.build_gix(a), gixm.build_gix(b)
        seeds = mergem.adaptamer_seeds(ta, tb, freq=10)
        la, lb = a.contig_lengths(), b.contig_lengths()
        perm = np.asarray(ta.perm)
        alens = np.where(perm < len(la), la[np.minimum(perm, len(la) - 1)],
                         ta.kmer)
        return chainm.chain_tubes(seeds, int(la.max()), int(lb.max()),
                                  alens, chain_break=2000, chain_min=170)
    jt = tubes(jgix, jmerge, jchain, j1, j2)
    tt = tubes(tgix, tmerge, tchain, g1, g2)
    assert jt.n > 0
    conv = convert.tubes_from_arrays(vars(jt))
    for name in vars(tt):
        assert np.array_equal(getattr(conv, name), getattr(tt, name)), name
    js = JSpec(0.7, 100, False, tuple(j1.freq))
    ts = convert.spec_from_arrays(0.7, 100, tuple(g1.freq), js.table,
                                  js.score)
    assert (ts.ave_path, ts.mscore, ts.dscore) == (js.ave_path, js.mscore,
                                                   js.dscore)
