"""The port's self comparison and kmer-panel seed routes against the JAX
package, exactly: self_seeds, device_tubes_self and device_tubes_paneled
(pair and self, four panels) against the JAX functions, the host seed
functions and the port's single-shot routes; then align_genomes' routing
between them on the CPU.  Every quantity is an integer; the tolerance is
zero."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from fastga_tpu.ops import device_pipeline as dp
from fastga_tpu_torch import convert
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import chain as tchain
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import merge as tmerge
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.ops.cuda_build import LAUNCHES
from fastga_tpu_torch.utils import synth
from tests.test_device_pipeline import _gdb, _mutate
from tests.test_torch_seedpipe import _alens, _assert_tubes, _eq, _key

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    """Three contigs of 4-9 kb, each followed by a 3%-mutated copy of its
    first third (tests/test_device_pipeline.py's self genome), and a
    4%-mutated copy of each as the second genome; both packages' GDBs, the
    JAX package's self and paneled tubes, and the port's host self
    seeds."""
    rng = np.random.default_rng(59)
    A = []
    for _ in range(3):
        base = rng.integers(0, 4, int(rng.integers(4000, 9000))
                            ).astype(np.uint8)
        A.append(np.concatenate([base, _mutate(base[:len(base) // 3], 0.03,
                                               rng)]))
    B = [_mutate(a, 0.04, rng) for a in A]
    jg1, jg2 = _gdb(A), _gdb(B)
    tg1, tg2 = synth.to_gdb("a", A)[0], synth.to_gdb("b", B)[0]
    lens1 = jg1.contig_lengths()
    alens = _alens(lens1)
    jself = dp.device_tubes_self(jg1, alens)
    jpself = dp.device_tubes_paneled(jg1, None, alens, panels=4)
    jppair = dp.device_tubes_paneled(jg1, jg2, alens, panels=4)
    t1 = tgix.build_gix(tg1)
    hseeds = tmerge.self_adaptamer_seeds(t1, freq=10)
    amax = int(lens1.max())
    htubes = tchain.chain_tubes(hseeds, amax, amax, alens)
    for r in (jself, jpself, jppair):
        assert r is not None and r[0].n > 0
    return SimpleNamespace(A=A, B=B, jg1=jg1, jg2=jg2, tg1=tg1, tg2=tg2,
                           alens=alens, jself=jself, jpself=jpself,
                           jppair=jppair, hseeds=hseeds, htubes=htubes)


def _same(want, got):
    assert (got[1], got[2]) == (want[1], want[2])   # seeds, length sum
    _assert_tubes(want[0], got[0])


def test_self_seeds_matches_jax(g):
    """The port's self_seeds (with its seed-length sum) on the JAX
    package's GIX table equals the JAX self merge on every valid seed."""
    lens = g.jg1.contig_lengths()
    N = dp._pad_bucket(int(lens.sum()))
    E = max(1 << 12, N)
    nscap = max(2 * E, 1 << 13)
    with jax.enable_x64():
        bps, coff, clen, _, invp, nc, _ = dp._prep_genome(g.jg1, lens)
        T = dp._gix_jit(N, len(coff), E)(bps, coff, clen, invp, nc)
        want = [np.asarray(x) for x in dp._self_jit(
            E, nscap, E, 10, False, False)(T, None)]
    T = convert.table_from_numpy([np.asarray(x) for x in T], CPU)
    got = convert.outputs_to_numpy(tp._self_seeds_sum(T, nscap, 10))
    ns = int(want[6])
    assert ns == g.hseeds.n
    assert got[6:] == tuple(int(x) for x in want[6:])   # ns, nalive, plsum
    for i in range(6):
        assert _eq(want[i][:ns], got[i][:ns]), f"column {i}"
    assert LAUNCHES["fused_scan"] == 0


def test_device_tubes_self_matches_jax_and_host(g):
    got = tp.device_tubes_self(g.tg1, g.alens, device=CPU)
    _same(g.jself, got)
    assert (got[1], got[2]) == (g.hseeds.n,
                                int(g.hseeds.plen.astype(np.int64).sum()))
    _assert_tubes(g.htubes, got[0])


@pytest.mark.parametrize("what", ["pair", "self"])
def test_paneled_matches_jax_and_single_shot(g, what):
    """Four panels, as a pair and as self: the JAX package's paneled
    result and the port's single-shot route's (the host path's for
    self)."""
    if what == "pair":
        got = tp.device_tubes_paneled(g.tg1, g.tg2, g.alens, panels=4,
                                      device=CPU)
        single = tp.device_tubes(g.tg1, g.tg2, g.alens, device=CPU)
        _same(g.jppair, got)
    else:
        got = tp.device_tubes_paneled(g.tg1, None, g.alens, panels=4,
                                      device=CPU)
        single = tp.device_tubes_self(g.tg1, g.alens, device=CPU)
        _same(g.jpself, got)
        _assert_tubes(g.htubes, got[0])
    _same(single, got)


def test_paneled_default_panels_and_verbose(g, capsys):
    """panels=0 takes max(2, 2 * padded bases / 2^24) rounded up to a power
    of two (2 here); verbose prints the JAX package's line a panel."""
    got = tp.device_tubes_paneled(g.tg1, None, g.alens, verbose=True,
                                  device=CPU)
    _same(g.jpself, got)
    lines = capsys.readouterr().err.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["devpipe panel 1/2",
                                                  "devpipe panel 2/2"]
    ns = [int(ln.split("ns=")[1].split()[0]) for ln in lines]
    assert sum(ns) == got[1] and all(" over=0 " in ln for ln in lines)


@pytest.mark.parametrize("cap", ["entries", "seeds", "alive"])
def test_panel_cap_doubles_panels(g, monkeypatch, cap):
    """A panel past one of its caps (below 8 panels here) reruns the run at
    twice the panels: 2, 4, then 8, with the JAX package's tubes."""
    caps = tp._panel_caps
    seen = []

    def small(N1, N2, P, selfish):
        seen.append(P)
        c = list(caps(N1, N2, P, selfish))
        if P < 8:
            i = {"entries": 1, "seeds": 2, "alive": 3}[cap]
            c[i] = 64
            if cap == "entries":
                c[0] = 64
        return tuple(c)
    monkeypatch.setattr(tp, "_panel_caps", small)
    got = tp.device_tubes_paneled(g.tg1, g.tg2, g.alens, panels=2,
                                  device=CPU)
    assert seen == [2, 4, 8]
    _same(g.jppair, got)


def test_panel_cap_past_panel_max_raises(g, monkeypatch):
    monkeypatch.setattr(tp, "PANEL_MAX", 8)
    caps = tp._panel_caps
    monkeypatch.setattr(tp, "_panel_caps", lambda *a: (64,) + caps(*a)[1:])
    with pytest.raises(RuntimeError, match="caps exceeded at 8 panels"):
        tp.device_tubes_paneled(g.tg1, None, g.alens, panels=4, device=CPU)


def test_self_seeds_rerun_at_their_bucket(g):
    """Self seeds past the slots asked for take their own bucket (the 24
    Mbp repeat-rich self run needs 2.82 seeds an entry, past the JAX
    package's 2 * E1), with every seed of a run at ample slots."""
    T = tp._full_table({}, g.tg1, g.tg1.contig_lengths(), 1 << 15, CPU)
    want = convert.outputs_to_numpy(tp._self_seeds_sum(T, 1 << 16, 10))
    got = convert.outputs_to_numpy(tp._self_seeds_sum(T, 4096, 10))
    ns, nscap = want[6], len(got[0])
    assert nscap == tp._pad_bucket(max(ns, 1 << 13)) and 4096 < ns <= nscap
    assert got[6:] == want[6:]
    for i in range(6):
        assert _eq(want[i][:ns], got[i][:ns]), f"column {i}"


def test_global_seed_buffer_grows(g, monkeypatch):
    """A global seed buffer too short for the seeds (here 3,000 rows: the
    first panel's seeds fit, the second's do not) grows to their bucket,
    with the JAX package's tubes."""
    sizes = _short_buffer(monkeypatch)
    got = tp.device_tubes_paneled(g.tg1, None, g.alens, panels=4,
                                  device=CPU)
    _same(g.jpself, got)
    # before and after each append: the second panel's grows the buffer
    assert sizes[:3] == [3000] * 3 and 3000 < sizes[3] < tp._pad_bucket(
        2 * int(g.tg1.contig_lengths().sum()))


def _short_buffer(monkeypatch):
    """Hand the first panel's append a 3,000-row view of the global seed
    buffer; record the buffer rows each append sees and returns."""
    app = tp._append_seeds
    sizes = []

    def short(g1, g2, goff, out, ns):
        if not sizes:
            g1, g2 = g1[:3000], g2[:3000]
        sizes.append(g1.shape[0])
        g1, g2, goff = app(g1, g2, goff, out, ns)
        sizes.append(g1.shape[0])
        return g1, g2, goff
    monkeypatch.setattr(tp, "_append_seeds", short)
    return sizes


def test_paneled_seeds_past_chain_cap_raise(g, monkeypatch):
    """More seeds than the chain sweep takes (CHAIN_PANEL_MAX, here 4,000)
    raise when a panel appends them."""
    _short_buffer(monkeypatch)
    monkeypatch.setattr(tp, "CHAIN_PANEL_MAX", 4000)
    with pytest.raises(RuntimeError, match="the chain sweep's cap 4000"):
        tp.device_tubes_paneled(g.tg1, None, g.alens, panels=4, device=CPU)


# -- align_genomes' routing ---------------------------------------------------

CFG = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)


@pytest.fixture
def no_waves(monkeypatch):
    """align_genomes without its wave phase (the routing tests read the
    seed stats only)."""
    monkeypatch.setattr(tal, "_device_align", lambda *a: [])


def _routes(monkeypatch):
    """Record the device seed functions align_genomes calls."""
    calls = []
    for name in ("device_tubes", "device_tubes_self",
                 "device_tubes_paneled", "device_tubes_tables"):
        fn = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    return calls


def test_self_without_tables_seeds_on_device(g, monkeypatch, no_waves):
    calls = _routes(monkeypatch)
    _, stats = tal.align_genomes(g.tg1, g.tg1, device="cpu")
    assert calls == ["device_tubes_self"]
    assert stats["seed_pipeline"] == "device"
    assert (stats["nseeds"], stats["nhits"]) == (g.hseeds.n, g.htubes.n)


def test_self_with_tables_seeds_on_host(g, monkeypatch, no_waves):
    """A self comparison with its GIX table seeds on the device now: it
    uploads that table (device_tubes_tables) in place of
    device_tubes_self, with the host seed path's seeds and tubes."""
    calls = _routes(monkeypatch)
    t1 = tgix.build_gix(g.tg1)
    _, stats = tal.align_genomes(g.tg1, g.tg1, t1, t1, device="cpu")
    assert calls == ["device_tubes_tables"]
    assert stats["seed_pipeline"] == "device"
    assert (stats["nseeds"], stats["nhits"]) == (g.hseeds.n, g.htubes.n)


@pytest.mark.parametrize("what", ["pair", "self"])
def test_past_single_shot_bases_takes_panels(g, monkeypatch, what):
    """With _MAX_DEV_BASES below the genome's size the single-shot route
    declines and the paneled route runs on the device, with the default
    route's records (on the shortest contig of each genome)."""
    i = int(np.argmin([len(a) for a in g.A]))
    g1 = convert.gdb_from_arrays([g.A[i]], ["a"])
    g2 = g1 if what == "self" else convert.gdb_from_arrays([g.B[i]], ["b"])
    want, wstats = tal.align_genomes(g1, g2, device="cpu", cfg=CFG)
    calls = _routes(monkeypatch)
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", len(g.A[i]) // 2)
    got, stats = tal.align_genomes(g1, g2, device="cpu", cfg=CFG)
    assert calls == ["device_tubes" + ("_self" if what == "self" else ""),
                     "device_tubes_paneled"]
    assert stats["seed_pipeline"] == wstats["seed_pipeline"] == "device"
    assert "seed_decline" not in stats
    assert (stats["nseeds"], stats["nhits"]) == (wstats["nseeds"],
                                                 wstats["nhits"])
    assert len(want) > 0
    assert [_key(o) for o in got] == [_key(o) for o in want]


@pytest.mark.parametrize("what", ["pair", "self"])
def test_freq_past_device_cap_declines_to_host(g, monkeypatch, capsys,
                                               no_waves, what):
    """-f 11: both device routes decline with the JAX package's reason,
    and the host seeds the run with a line on stderr."""
    dp.DECLINE = None
    assert dp.device_tubes_paneled(g.jg1, None if what == "self" else g.jg2,
                                   g.alens, freq=11) is None
    calls = _routes(monkeypatch)
    g2 = g.tg1 if what == "self" else g.tg2
    _, stats = tal.align_genomes(g.tg1, g2, device="cpu",
                                 params=tal.FastGAParams(freq=11))
    assert calls[1:] == ["device_tubes_paneled"]
    assert stats["seed_pipeline"] == "host"
    assert stats["seed_decline"] == tp.DECLINE == dp.DECLINE \
        == "-f 11 > device merge cap 10"
    assert ("device seed pipeline declined (-f 11 > device merge cap 10)"
            in capsys.readouterr().err)


@pytest.mark.parametrize("what", ["pair", "self"])
def test_device_error_propagates(g, monkeypatch, no_waves, what):
    """An error on the device (here a RuntimeError from the single-shot
    route) reaches the caller: no paneled retry, no host seeds."""
    calls = _routes(monkeypatch)
    name = "device_tubes_self" if what == "self" else "device_tubes"

    def boom(*a, **k):
        calls.append(name)
        raise RuntimeError("out of memory on the device")

    def host(*a, **k):
        raise AssertionError("host seeds after a device error")
    monkeypatch.setattr(tp, name, boom)
    for fn in ("self_adaptamer_seeds", "adaptamer_seeds"):
        monkeypatch.setattr(tmerge, fn, host)
    g2 = g.tg1 if what == "self" else g.tg2
    with pytest.raises(RuntimeError, match="out of memory on the device"):
        tal.align_genomes(g.tg1, g2, device="cpu")
    assert calls == [name]
