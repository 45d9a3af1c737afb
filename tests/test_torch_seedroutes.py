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

from fastga_tpu.io import gix as jgix
from fastga_tpu.ops import chain as jchain
from fastga_tpu.ops import device_pipeline as dp
from fastga_tpu.ops import merge as jmerge
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


@pytest.mark.parametrize("who", ["genome 1", "genome 2", "self"])
def test_panel_tables_take_their_entries_bucket(g, monkeypatch, capsys,
                                                who):
    """Each genome's candidates are built once into its panel plane, whose
    counts size each panel's table at the bucket of its entries: every
    panel of the genome gathered once, at _pad_bucket of the entries the
    plane counted, the plane's counts summing to the genome's entries,
    and the JAX package's tubes (``over`` 0 on every verbose line)."""
    selfish = who == "self"
    counts, tables, pre = [], [], []
    plane, table, prep = tp._panel_plane, tp._plane_table, tp._prep_genome
    monkeypatch.setattr(tp, "_prep_genome", lambda *a: pre.append(
        prep(*a)) or pre[-1])

    def plane_w(*a):
        out = plane(*a)
        counts.append(out[1])
        return out

    def table_w(prep_, total, pl, n, p):
        T = table(prep_, total, pl, n, p)
        tables.append((prep_ is pre[0], p, n, len(T[0]), int(T[7])))
        return T
    monkeypatch.setattr(tp, "_panel_plane", plane_w)
    monkeypatch.setattr(tp, "_plane_table", table_w)
    got = tp.device_tubes_paneled(g.tg1, None if selfish else g.tg2,
                                  g.alens, panels=4, verbose=True,
                                  device=CPU)
    _same(g.jpself if selfish else g.jppair, got)
    first = who != "genome 2"
    gd = g.tg1 if first else g.tg2
    full = int(tp._full_table(gd, gd.contig_lengths(), CPU)[7])
    assert len(counts) == (1 if selfish else 2)
    cnt = counts[0 if first else 1]
    assert sum(cnt) == full
    mine = [x[1:] for x in tables if x[0] == first]
    assert mine == [(p, cnt[p], tp._pad_bucket(cnt[p]), cnt[p])
                    for p in range(4)]
    overs = [int(ln.split("over=")[1].split()[0])
             for ln in capsys.readouterr().err.splitlines()]
    assert overs == [0] * 4


def test_panel_entries_past_their_buffer_stay_on_card(g, monkeypatch,
                                                      capsys, no_waves):
    """Through align_genomes (the paneled route alone, the genome past a
    lowered single-shot cap), self panels from a plane built in blocks of
    1,000 positions:
    no panel's entries pass its table, which takes their bucket, and the
    run seeds on the card with the JAX package's seeds, tubes and
    seed-length average."""
    monkeypatch.setattr(tp, "PANEL_BLOCK", 1000)
    sizes = []
    table = tp._plane_table

    def table_w(*a):
        T = table(*a)
        sizes.append((a[3], len(T[0])))
        return T
    monkeypatch.setattr(tp, "_plane_table", table_w)
    calls = _routes(monkeypatch)
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", 1000)
    _, stats = tal.align_genomes(g.tg1, g.tg1, device="cpu")
    assert calls == ["device_tubes_paneled"]
    assert sizes and all(r == tp._pad_bucket(n) for n, r in sizes)
    _device_stats(stats, g.jself, capsys)


def _device_stats(stats, want, capsys):
    """align_genomes seeded on the card with ``want``'s (tubes, seeds,
    seed-length sum), and no decline printed."""
    assert stats["seed_pipeline"] == "device"
    assert "seed_decline" not in stats
    assert (stats["nseeds"], stats["nhits"]) == (want[1], want[0].n)
    assert stats["seed_len_avg"] == pytest.approx(want[2] / want[1],
                                                  rel=1e-12)
    assert "declined" not in capsys.readouterr().err


def test_self_seeds_rerun_at_their_bucket(g):
    """Self seeds past the slots asked for take their own bucket (the 24
    Mbp repeat-rich self run needs 2.82 seeds an entry, past the JAX
    package's 2 * E1), with every seed of a run at ample slots."""
    T = tp._full_table(g.tg1, g.tg1.contig_lengths(), CPU)
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


def test_paneled_seeds_past_the_jax_chain_caps_stay_on_card(g, monkeypatch,
                                                            capsys):
    """A global buffer that grows, and more seeds than the JAX package's
    paneled chain takes (a bucket past 6 x CHAIN_DEV_CAP, here 1,500),
    with every contig past a chain panel: the chain sweeps on the device,
    a window a contig, with the JAX package's self tubes and nothing
    printed."""
    sizes = _short_buffer(monkeypatch)
    monkeypatch.setattr(tp, "CHAIN_DEV_CAP", 1500)
    windows = []
    panel = tp._chain_panel
    monkeypatch.setattr(tp, "_chain_panel", lambda *a: windows.append(
        (a[4], a[5])) or panel(*a))
    got = tp.device_tubes_paneled(g.tg1, None, g.alens, panels=4,
                                  device=CPU)
    _same(g.jpself, got)
    assert sizes[0] == 3000 and max(sizes) > 3000
    assert tp._pad_bucket(got[1]) > 6 * 1500
    assert len(windows) == g.tg1.ncontig and all(
        n > 750 and w == tp._pad_bucket(n) for n, w in windows)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("case", ["pair", "self", "-S", "paneled pair",
                                  "paneled self"])
def test_entries_past_the_jax_cap_stay_on_card(g, monkeypatch, capsys,
                                               no_waves, case):
    """A poly-A contig (two entries a base) takes each genome's GIX
    entries past its padded bases N, the JAX package's entry cap, where it
    declines to the host: the port's single-shot route keeps every entry
    and align_genomes seeds on the card, with the JAX host path's seeds,
    tubes and seed-length average.  Through the paneled route at four
    panels the poly-A entries crowd the first kmer panel (A...) and their
    reverse complements the last (T...): each genome's table of each
    panel is gathered once, at the bucket of its entries, the first and
    last the largest."""
    selfish, sym = case.endswith("self"), case == "-S"
    paneled = case.startswith("paneled")

    def with_poly_a(seqs):
        # up to the bucket past a quarter more bases: entries above N
        n = sum(map(len, seqs))
        return seqs + [np.zeros(dp._pad_bucket(n + n // 4) - n, np.uint8)]
    A, B = with_poly_a(list(g.A)), with_poly_a(list(g.B))
    g1 = synth.to_gdb("a", A)[0]
    g2 = g1 if selfish else synth.to_gdb("b", B)[0]
    for gd in (g1, g2):
        lens = gd.contig_lengths()
        N = tp._pad_bucket(int(lens.sum()))
        assert N == int(lens.sum()) and int(
            tp._full_table(gd, lens, CPU)[7]) > N
    calls = _routes(monkeypatch)
    scans = []
    table = tp._plane_table
    monkeypatch.setattr(tp, "_plane_table", lambda *a: scans.append(
        (a[4], a[3])) or table(*a))
    if paneled:
        got = tp.device_tubes_paneled(g1, None if selfish else g2,
                                      _alens(g1.contig_lengths()),
                                      panels=4, device=CPU)
        # each genome's table of each panel once; g1's poly-A entries
        # crowd its first and last panels
        k = 1 if selfish else 2
        assert [p for p, _ in scans] == [p for p in range(4)
                                         for _ in range(k)]
        n1 = [n for _, n in scans[::k]]
        assert min(n1[0], n1[3]) > max(n1[1], n1[2])
    else:
        _, stats = tal.align_genomes(g1, g2, device="cpu", symmetric=sym)
        assert calls == ["device_tubes_self" if selfish else "device_tubes"]
    jg1 = _gdb(A)
    jt1 = jgix.build_gix(jg1)
    alens = _alens(jg1.contig_lengths())
    if selfish:
        seeds = jmerge.self_adaptamer_seeds(jt1, freq=10)
        bmax = int(jg1.contig_lengths().max())
    else:
        jg2 = _gdb(B)
        jt2 = jgix.build_gix(jg2)
        seeds = jmerge.adaptamer_seeds(jt1, jt2, freq=10)
        if sym:
            extra = jmerge.adaptamer_seeds_flip(jt1, jt2, freq=10)
            seeds = jmerge.SeedBatch(*[
                np.concatenate([getattr(seeds, f), getattr(extra, f)])
                for f in ("plen", "acont", "apost", "bcont", "bpost",
                          "bcomp")])
        bmax = int(jg2.contig_lengths().max())
    want = (jchain.chain_tubes(seeds, int(jg1.contig_lengths().max()), bmax,
                               alens),
            seeds.n, int(seeds.plen.astype(np.int64).sum()))
    assert want[0].n > 0
    if paneled:
        _same(want, got)
    else:
        _device_stats(stats, want, capsys)


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
    """With _MAX_DEV_BASES below the genome's size align_genomes calls the
    paneled route alone, on the device, with the default route's records
    (on the shortest contig of each genome)."""
    i = int(np.argmin([len(a) for a in g.A]))
    g1 = convert.gdb_from_arrays([g.A[i]], ["a"])
    g2 = g1 if what == "self" else convert.gdb_from_arrays([g.B[i]], ["b"])
    want, wstats = tal.align_genomes(g1, g2, device="cpu", cfg=CFG)
    calls = _routes(monkeypatch)
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", len(g.A[i]) // 2)
    got, stats = tal.align_genomes(g1, g2, device="cpu", cfg=CFG)
    assert calls == ["device_tubes_paneled"]
    assert stats["seed_pipeline"] == wstats["seed_pipeline"] == "device"
    assert "seed_decline" not in stats
    assert (stats["nseeds"], stats["nhits"]) == (wstats["nseeds"],
                                                 wstats["nhits"])
    assert len(want) > 0
    assert [_key(o) for o in got] == [_key(o) for o in want]


@pytest.mark.parametrize("what", ["pair", "self"])
def test_freq_past_device_cap_declines_to_host(g, monkeypatch, capsys,
                                               no_waves, what):
    """-f 11: the single-shot route, the one called, declines with the
    JAX package's reason, and the host seeds the run with a line on
    stderr."""
    dp.DECLINE = None
    if what == "self":
        assert dp.device_tubes_self(g.jg1, g.alens, freq=11) is None
    else:
        assert dp.device_tubes(g.jg1, g.jg2, g.alens, freq=11) is None
    calls = _routes(monkeypatch)
    g2 = g.tg1 if what == "self" else g.tg2
    _, stats = tal.align_genomes(g.tg1, g2, device="cpu",
                                 params=tal.FastGAParams(freq=11))
    assert calls == ["device_tubes_self" if what == "self"
                     else "device_tubes"]
    assert stats["seed_pipeline"] == "host"
    assert stats["seed_decline"] == dp.DECLINE \
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


# -- declines: one check of the caps, a reason raised, the host seeding ------

DECLINE_CASES = [(route, cap) for route, caps in (
    ("pair", ("contigs", "width", "freq", "-S bases")),
    ("self", ("contigs", "width", "freq")),
    ("tables", ("rows", "contigs", "width", "freq")),
    ("paneled", ("contigs", "width", "freq")),
    ("sharded", ("contigs", "width", "freq"))) for cap in caps]


@pytest.mark.parametrize("route,cap", DECLINE_CASES)
def test_declines_match_jax_before_upload(route, cap, monkeypatch, capsys,
                                          no_waves):
    """align_genomes on each route past each single cap that applies to
    it: the route called declines before anything goes up (the genome
    preparation and the table upload fail here if reached), and the host
    seeds the run, with the JAX package's reason for the same input in
    ``stats["seed_decline"]`` and on stderr.  Genome 1 of 4,096 contigs
    of 60 bases, else three of 3 kb;
    the field width past a lowered MAX_POST (both packages'); the table
    rows past a lowered MAX_ROWS (the JAX check is fixed at 2^26: a table
    of 2^26 rows stands in there); the paneled route past a lowered
    _MAX_DEV_BASES; the sharded route on a 2-rank gloo mesh without a
    process group, so any collective would fail."""
    from fastga_tpu_torch.parallel import sharded as tsharded
    rng = np.random.default_rng(19)
    A = [rng.integers(0, 4, 3000).astype(np.uint8) for _ in range(3)]
    B = [_mutate(a, 0.04, rng) for a in A]
    if cap == "contigs":
        A = [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(4096)]
    jg1, jg2 = _gdb(A), _gdb(B)
    g1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(len(A))])
    g2 = g1 if route == "self" else convert.gdb_from_arrays(
        B, [f"b{i}" for i in range(len(B))])
    alens = _alens(jg1.contig_lengths())
    freq = 11 if cap == "freq" else 10
    if cap == "width":
        monkeypatch.setattr(tp, "MAX_POST", 3000)
        monkeypatch.setattr(dp, "MAX_POST", 3000)
    if cap == "-S bases" or route == "paneled":
        monkeypatch.setattr(tp, "_MAX_DEV_BASES", 8999)
        monkeypatch.setattr(dp, "_MAX_DEV_BASES", 8999)
    kw = dict(params=tal.FastGAParams(freq=freq, soft_mask=route == "tables"),
              symmetric=cap == "-S bases")
    dp.DECLINE = None
    if route == "tables":
        t1, t2 = tgix.build_gix(g1), tgix.build_gix(g2)
        jt1, jt2 = jgix.build_gix(jg1), jgix.build_gix(jg2)
        if cap == "rows":
            monkeypatch.setattr(tp, "MAX_ROWS", min(t1.n, t2.n))
            jt1 = SimpleNamespace(n=1 << 26, perm=jt1.perm)
        amax, bmax = (int(x.contig_lengths().max()) for x in (jg1, jg2))
        assert dp.device_tubes_tables(jt1, jt2, alens, amax, bmax, freq=freq,
                                      soft_mask=True) is None
        kw.update(t1=t1, t2=t2)
    elif route == "self":
        assert dp.device_tubes_self(jg1, alens, freq=freq) is None
    elif route == "paneled":
        assert dp.device_tubes_paneled(jg1, jg2, alens, freq=freq) is None
    else:
        # the JAX sharded route declines with no reason: its device_tubes'
        assert dp.device_tubes(jg1, jg2, alens, freq=freq,
                               symmetric=cap == "-S bases") is None
    if route == "sharded":
        kw["mesh"] = tsharded.Mesh(2, 0, CPU, "gloo")

    def upload(*a, **k):
        raise AssertionError("a declined route reached the device")
    for fn in ("_prep_genome", "_upload_table"):
        monkeypatch.setattr(tp, fn, upload)
    calls = _routes(monkeypatch)
    _, stats = tal.align_genomes(g1, g2, device="cpu", **kw)
    assert calls == {"pair": ["device_tubes"], "self": ["device_tubes_self"],
                     "tables": ["device_tubes_tables"],
                     "paneled": ["device_tubes_paneled"],
                     "sharded": []}[route]
    assert stats["seed_pipeline"] == "host" and "sharded" not in stats
    assert stats["seed_decline"] == dp.DECLINE is not None
    assert (f"fastga_tpu: device seed pipeline declined ({dp.DECLINE}); "
            f"using host seed pipeline") in capsys.readouterr().err


@pytest.mark.parametrize("case", ["pair", "-S", "self"])
def test_routes_leave_no_attribute_on_the_gdbs(g, no_waves, case):
    """The single-shot, -S and self routes build their tables anew each
    run and keep nothing on the GDB objects."""
    g2 = g.tg1 if case == "self" else g.tg2
    before = [set(vars(x)) for x in (g.tg1, g2)]
    _, stats = tal.align_genomes(g.tg1, g2, device="cpu",
                                 symmetric=case == "-S")
    assert stats["seed_pipeline"] == "device"
    assert [set(vars(x)) for x in (g.tg1, g2)] == before
