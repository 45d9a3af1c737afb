"""The kmer-panel route's panel plane: each genome's candidates are built
once, into one byte a candidate slot naming the slot's panel, and each
panel's table is gathered from the plane at the bucket of its entries.
Every table equals, column for column, the rows of ``gix_arrays``' full
sorted table whose 24-bit prefix lies in its panel; the candidate blocks
are ceil(total / PANEL_BLOCK) a genome at any panel count; and
``device_tubes_paneled`` returns the single-shot route's seeds, plsum and
tubes, for a pair and for self.  The genomes hold contig seams, contigs
shorter than 40 bases and lengths that are not multiples of 4.  Every
quantity is an integer; the tolerance is zero."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.utils import prof, synth
from tests.test_device_pipeline import _mutate
from tests.test_torch_seedpipe import _alens, _assert_tubes

CPU = torch.device("cpu")
PANELS = [2, 4, 16]
WHATS = ["pair", "self"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gs():
    """Genome 1: seven contigs of 12 to 4,001 bases (three under 40, five
    not a multiple of 4), the longest with a 3%-mutated copy of its first
    half appended; genome 2: a 4%-mutated copy of each contig of 40 bases
    or more, in reverse order, the longest with its middle third
    reverse-complemented, and two short contigs of its own."""
    rng = np.random.default_rng(0x9A7E)
    A = [rng.integers(0, 4, n).astype(np.uint8)
         for n in (2503, 37, 1998, 12, 40, 41, 1001)]
    A[0] = np.concatenate([A[0], _mutate(A[0][:1250], 0.03, rng)])
    B = [_mutate(a, 0.04, rng) for a in A[::-1] if len(a) >= 40]
    q = len(B[-1]) // 3
    B[-1][q:2 * q] = 3 - B[-1][q:2 * q][::-1]
    B += [rng.integers(0, 4, n).astype(np.uint8) for n in (39, 7)]
    g1 = synth.to_gdb("a", A)[0]
    g2 = synth.to_gdb("b", B)[0]
    for g in (g1, g2):
        lens = g.contig_lengths()
        assert (lens % 4 != 0).any() and (lens < 40).any()
    return g1, g2, _alens(g1.contig_lengths())


def _full_rows(g):
    """``gix_arrays``' sorted table of genome ``g``: its six entry columns
    at its entries, and the rows' 24-bit prefixes."""
    lens = g.contig_lengths()
    bps, coff, clen, invp, nc, _ = tp._prep_genome(g, lens, CPU)
    T = tp.gix_arrays(bps, coff, clen, invp, nc)
    n = int(T[7])
    cols = [x[:n] for x in T[:6]]
    return cols, (cols[0].to(torch.int64) & tp.M32) >> 8


_RUNS = {}


def _run(gs, P, what, block=None):
    """``device_tubes_paneled`` at ``P`` panels (``PANEL_BLOCK`` at
    ``block`` when given), with the span record on: (result, the tables
    it gathered as (genome 1's?, panel, table), the planes' entry counts
    a genome, the counters), cached a run."""
    key = (P, what, block)
    if key in _RUNS:
        return _RUNS[key]
    g1, g2, alens = gs
    mp = pytest.MonkeyPatch()
    tables, counts, preps = [], [], []
    plane, table, prep = tp._panel_plane, tp._plane_table, tp._prep_genome

    def prep_w(*a):
        preps.append(prep(*a))
        return preps[-1]

    def plane_w(*a):
        out = plane(*a)
        counts.append(out[1])
        return out

    def table_w(pr, total, pl, n, p):
        T = table(pr, total, pl, n, p)
        tables.append((pr is preps[0], p, T))
        return T
    try:
        mp.setattr(tp, "_prep_genome", prep_w)
        mp.setattr(tp, "_panel_plane", plane_w)
        mp.setattr(tp, "_plane_table", table_w)
        mp.setattr(prof, "ENABLED", True)
        if block is not None:
            mp.setattr(tp, "PANEL_BLOCK", block)
        prof.reset()
        got = tp.device_tubes_paneled(g1, g2 if what == "pair" else None,
                                      alens, panels=P, device=CPU)
        c = prof.counters()
    finally:
        prof.reset()
        mp.undo()
    _RUNS[key] = got, tables, counts, c
    return _RUNS[key]


@pytest.mark.parametrize("P", PANELS)
@pytest.mark.parametrize("who", ["genome 1", "genome 2", "self"])
def test_plane_tables_are_the_full_tables_rows(gs, P, who):
    """Each panel's table from the plane holds, column for column and in
    order, the rows of the genome's full sorted table whose 24-bit prefix
    lies in the panel, at the bucket of their count; padding rows carry
    all-ones keys and no valid bit."""
    _, tables, counts, _ = _run(gs, P, "self" if who == "self" else "pair")
    first = who != "genome 2"
    mine = [(p, T) for f, p, T in tables if f == first]
    assert [p for p, _ in mine] == list(range(P))
    cols, pre = _full_rows(gs[0] if first else gs[1])
    assert counts[0 if first else 1] == [
        int(((pre * P) >> 24 == p).sum()) for p in range(P)]
    for p, T in mine:
        at = (pre * P) >> 24 == p
        n = int(at.sum())
        assert int(T[7]) == n and len(T[0]) == tp._pad_bucket(n)
        for c in range(6):
            assert torch.equal(T[c][:n], cols[c][at]), (p, c)
        assert torch.equal(T[8], (torch.arange(len(T[0])) < n).to(
            torch.int32))
        assert (T[0][n:] == -1).all() and (T[1][n:] == -1).all()


@pytest.mark.parametrize("P", [2, 16])
@pytest.mark.parametrize("what", WHATS)
def test_candidate_blocks_once_a_genome(gs, P, what):
    """``devpipe.candidate_blocks`` counts ceil(total / PANEL_BLOCK)
    blocks a genome (PANEL_BLOCK at 1,000 positions: several a genome),
    whatever the panel count; the result stays the default block's."""
    got, _, _, c = _run(gs, P, what, block=1000)
    tots = [int(g.contig_lengths().sum()) for g in gs[:2]]
    want = sum(-(-t // 1000) for t in (tots if what == "pair" else
                                      tots[:1]))
    assert want > 2 * (2 if what == "pair" else 1)
    assert c["devpipe.candidate_blocks"] == want
    ref = _run(gs, P, what)
    assert got[1:] == ref[0][1:]
    _assert_tubes(ref[0][0], got[0])


@pytest.mark.parametrize("P", PANELS)
@pytest.mark.parametrize("what", WHATS)
def test_paneled_route_is_the_single_shot_route(gs, P, what):
    """``device_tubes_paneled`` at 2, 4 and 16 panels returns the seeds,
    seed-length sum and tubes of ``device_tubes`` (pair) or
    ``device_tubes_self`` (self)."""
    g1, g2, alens = gs
    got = _run(gs, P, what)[0]
    want = (tp.device_tubes(g1, g2, alens, device=CPU) if what == "pair"
            else tp.device_tubes_self(g1, alens, device=CPU))
    assert got is not None and got[0].n > 0 and got[1] > 0
    assert got[1:] == want[1:]
    _assert_tubes(want[0], got[0])


@pytest.mark.parametrize("what", WHATS)
def test_plane_span_inside_the_seed_phase(gs, monkeypatch, what):
    """Through align_genomes (the single-shot route declined on its
    bases), span ``devpipe.panel_plane`` runs once inside
    ``aligner.devpipe``, ahead of the first ``devpipe.panel``, and the
    candidate blocks are one a genome compared."""
    from fastga_tpu_torch.models import aligner as tal
    g1, g2, _ = gs
    monkeypatch.setattr(tal, "_device_align", lambda *a: [])
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", 1000)
    monkeypatch.setattr(prof, "ENABLED", True)
    prof.reset()
    try:
        _, stats = tal.align_genomes(g1, g2 if what == "pair" else g1,
                                     device="cpu")
        ev = prof.events()
        c = prof.counters()
    finally:
        prof.reset()
    assert stats["seed_pipeline"] == "device"
    (outer,) = [e for e in ev if e[3] == "aligner.devpipe"]
    (plane,) = [e for e in ev if e[3] == "devpipe.panel_plane"]
    panels = [e for e in ev if e[3] == "devpipe.panel"]
    assert plane[1] == outer[0] and len(panels) >= 2
    assert all(e[1] == outer[0] and plane[5] <= e[4] for e in panels)
    assert c["devpipe.candidate_blocks"] == (2 if what == "pair" else 1)
