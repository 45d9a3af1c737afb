"""The port's masked-table and -S seed routes against the JAX package,
exactly: device_tubes_tables (a masked pair, hard and soft; -S with and
without masks; a self comparison on a masked table) and
device_tubes(symmetric=True) against the JAX functions of the same names
and the host seed path, the seed columns of the masked and flip passes
against the JAX merges row for row, the slots of the masked and flip
passes sized from the expansion's total before their seeds are dropped,
then align_genomes' routing on the CPU.  Every quantity is an integer; the
tolerance is zero."""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io import gix as jgix
from fastga_tpu.ops import device_pipeline as dp
from fastga_tpu_torch import convert
from fastga_tpu_torch.io import gdb as tgdb
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import chain as tchain
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import merge as tmerge
from fastga_tpu_torch.utils import synth
from tests.test_device_pipeline import _gdb, _mutate
from tests.test_torch_seedpipe import _alens, _assert_tubes, _eq

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(A, B, m1=(), m2=()):
    """Both packages' GDBs and GIX tables of a genome pair, the tables
    masked by (contig, begin, end) intervals."""
    jg1, jg2 = _gdb(A), _gdb(B)
    g1, g2 = synth.to_gdb("a", A)[0], synth.to_gdb("b", B)[0]
    lens1, lens2 = g1.contig_lengths(), g2.contig_lengths()
    return SimpleNamespace(
        jg1=jg1, jg2=jg2, g1=g1, g2=g2,
        jt1=jgix.build_gix(jg1, masks=[jgdb.MaskIval(*m) for m in m1]),
        jt2=jgix.build_gix(jg2, masks=[jgdb.MaskIval(*m) for m in m2]),
        t1=tgix.build_gix(g1, masks=[tgdb.MaskIval(*m) for m in m1]),
        t2=tgix.build_gix(g2, masks=[tgdb.MaskIval(*m) for m in m2]),
        alens=_alens(lens1), amax=int(lens1.max()), bmax=int(lens2.max()))


def _host(p, soft=False, symmetric=False, selfish=False):
    """The host seed path on the port's tables: (TubeBatch, seeds, length
    sum)."""
    if selfish:
        seeds = tmerge.self_adaptamer_seeds(p.t1, freq=10, soft_mask=soft)
    else:
        seeds = tmerge.adaptamer_seeds(p.t1, p.t2, freq=10, soft_mask=soft)
        if symmetric:
            extra = tmerge.adaptamer_seeds_flip(p.t1, p.t2, freq=10,
                                                soft_mask=soft)
            seeds = tmerge.SeedBatch(*[
                np.concatenate([getattr(seeds, f), getattr(extra, f)])
                for f in ("plen", "acont", "apost", "bcont", "bpost",
                          "bcomp")])
    tubes = tchain.chain_tubes(seeds, p.amax, p.amax if selfish else p.bmax,
                               p.alens)
    return tubes, seeds.n, int(seeds.plen.astype(np.int64).sum())


@pytest.fixture(scope="module")
def g():
    """The inputs of tests/test_device_pipeline.py's masked (hard, soft),
    symmetric and symmetric masked tests, and tests/test_torch_seedroutes.py's
    self genome (three contigs with a mutated copy of their first third)
    with two masked intervals; the JAX package's results on each and the
    port's host seed path."""
    rng = np.random.default_rng(47)
    masked = {}
    for soft in (False, True):
        A = [rng.integers(0, 4, int(rng.integers(3000, 9000)))
             .astype(np.uint8) for _ in range(3)]
        B = [_mutate(a, 0.04, rng) for a in A]
        masked[soft] = _pair(A, B, [(0, 100, 1200), (2, 0, len(A[2]) // 2)],
                             [(1, 500, 2500)])

    rng = np.random.default_rng(67)
    A = [rng.integers(0, 4, int(rng.integers(3000, 9000)))
         .astype(np.uint8) for _ in range(4)]
    B = [_mutate(a, 0.04, rng) for a in A]
    A[1] = np.concatenate([A[1], _mutate(A[1][:2000], 0.02, rng),
                           _mutate(A[1][:2000], 0.02, rng)])
    sym = _pair(A, B)

    rng = np.random.default_rng(71)
    A = [rng.integers(0, 4, 6000).astype(np.uint8) for _ in range(3)]
    B = [_mutate(a, 0.04, rng) for a in A]
    symm = _pair(A, B, [(0, 100, 1500)], [(1, 500, 2500)])

    rng = np.random.default_rng(59)
    A = []
    for _ in range(3):
        base = rng.integers(0, 4, int(rng.integers(4000, 9000))
                            ).astype(np.uint8)
        A.append(np.concatenate([base, _mutate(base[:len(base) // 3], 0.03,
                                               rng)]))
    selfm = _pair(A, A, [(0, 200, 1400), (1, 0, len(A[1]) // 4)])

    def tables(p, **k):
        return dp.device_tubes_tables(p.jt1, p.jt2, p.alens, p.amax, p.bmax,
                                      **k)
    jax_out = {
        ("masked", s): tables(masked[s], soft_mask=s) for s in (False, True)}
    jax_out["sym"] = dp.device_tubes(sym.jg1, sym.jg2, sym.alens,
                                     symmetric=True)
    jax_out["sym", "tables"] = tables(sym, symmetric=True)
    for s in (False, True):
        jax_out["symm", s] = tables(symm, soft_mask=s, symmetric=True)
        jax_out["self", s] = dp.device_tubes_tables(
            selfm.jt1, selfm.jt1, selfm.alens, selfm.amax, selfm.amax,
            soft_mask=s)
    for r in jax_out.values():
        assert r is not None and r[0].n > 0
    host = {("masked", s): _host(masked[s], soft=s) for s in (False, True)}
    host["sym"] = _host(sym, symmetric=True)
    for s in (False, True):
        host["symm", s] = _host(symm, soft=s, symmetric=True)
        host["self", s] = _host(selfm, soft=s, selfish=True)
    return SimpleNamespace(masked=masked, sym=sym, symm=symm, selfm=selfm,
                           jax=jax_out, host=host)


def _same(want, got):
    assert (got[1], got[2]) == (want[1], want[2])   # seeds, length sum
    _assert_tubes(want[0], got[0])


def _tables(p, **k):
    t2 = p.t1 if k.pop("selfish", False) else p.t2
    return tp.device_tubes_tables(p.t1, t2, p.alens, p.amax, p.bmax,
                                  device=CPU, **k)


@pytest.mark.parametrize("soft", [False, True])
def test_masked_pair_matches_jax_and_host(g, soft):
    """tests/test_device_pipeline.py::test_device_tubes_masked_match_host:
    hard masks, then -M."""
    got = _tables(g.masked[soft], soft_mask=soft)
    _same(g.jax["masked", soft], got)
    _same(g.host["masked", soft], got)


@pytest.mark.parametrize("route", ["genomes", "tables"])
def test_symmetric_matches_jax_and_host(g, route):
    """tests/test_device_pipeline.py::test_device_tubes_symmetric_match_host:
    device_tubes(symmetric=True) (genome 1's full table built on the
    device) and device_tubes_tables(symmetric=True)."""
    p = g.sym
    if route == "genomes":
        got = tp.device_tubes(p.g1, p.g2, p.alens, symmetric=True,
                              device=CPU)
        _same(g.jax["sym"], got)
    else:
        got = _tables(p, symmetric=True)
        _same(g.jax["sym", "tables"], got)
    _same(g.host["sym"], got)


@pytest.mark.parametrize("soft", [False, True])
def test_symmetric_masked_matches_jax_and_host(g, soft):
    got = _tables(g.symm, soft_mask=soft, symmetric=True)
    _same(g.jax["symm", soft], got)
    _same(g.host["symm", soft], got)


@pytest.mark.parametrize("soft", [False, True])
def test_masked_self_matches_jax_and_host(g, soft):
    got = _tables(g.selfm, soft_mask=soft, selfish=True)
    _same(g.jax["self", soft], got)
    _same(g.host["self", soft], got)


def _jax_tables(*ts):
    with jax.enable_x64():
        return [dp._upload_table(t) for t in ts]


def test_masked_flip_and_self_columns_match_jax(g):
    """The seed columns row for row: the masked -S merge (the normal pass's
    kept seeds, then the flip pass's, compacted in slot order) and the
    masked self merge, each against the JAX package's jit function at the
    JAX slots."""
    p = g.symm
    (J1, jm1, E1), (J2, jm2, E2) = _jax_tables(p.jt1, p.jt2)
    c1, c2 = max(2 * E1, 1 << 13), max(2 * E2, 1 << 13)
    with jax.enable_x64():
        want = [np.asarray(x) for x in dp._sym_jit(
            E1, E2, c1, c2, E1, E2, 10, True, True, presorted=True)(
                J1, J2, jm1, jm2)]
    (T1, mb1), (T2, mb2) = (tp._upload_table(t, CPU)
                            for t in (p.t1, p.t2))
    got = convert.outputs_to_numpy(tp._sym_seeds_sum(
        T1, T2, c1, c2, 10, soft_mask=True, has_masks=True, maskb1=mb1,
        maskb2=mb2))
    ns = int(want[6])
    assert int(want[7]) == 0 and len(got[0]) == c1 + c2
    assert (got[6], got[8]) == (ns, int(want[8]))
    for i in range(6):
        assert _eq(want[i][:ns], got[i][:ns]), f"column {i}"

    p = g.selfm
    ((J, jm, E),) = _jax_tables(p.jt1)
    c = max(2 * E, 1 << 13)
    with jax.enable_x64():
        want = [np.asarray(x) for x in dp._self_jit(E, c, E, 10, True, True)(
            J, jm)]
    T, mb = tp._upload_table(p.t1, CPU)
    got = convert.outputs_to_numpy(tp._self_seeds_sum(
        T, c, 10, soft_mask=True, has_masks=True, maskb1=mb))
    ns = int(want[6])
    assert len(got[0]) == c and got[6:] == (ns, int(want[7]), int(want[8]))
    for i in range(6):
        assert _eq(want[i][:ns], got[i][:ns]), f"column {i}"


def _expansion_totals(monkeypatch):
    """Record (total, slots asked for, slots taken) of every seed
    expansion."""
    slots = tp._expansion_slots
    seen = []

    def rec(total, ns_cap):
        out = slots(total, ns_cap)
        seen.append((int(total), ns_cap, out))
        return out
    monkeypatch.setattr(tp, "_expansion_slots", rec)
    return seen


@pytest.mark.parametrize("what", ["masked", "symmetric", "self"])
def test_expansion_total_is_tested_before_compaction(g, monkeypatch, what):
    """The -M pass, the -S flip pass and the masked self pass, asked for
    slots between their kept seeds and their expansion's total (as the JAX
    package's static slots can be): each takes its total's bucket and
    keeps every seed, with the host path's count and length sum and a run
    at ample slots' seeds row for row (slots from the kept count, or the
    slots asked for, would lose the seeds past them)."""
    mk = dict(soft_mask=True, has_masks=True)
    if what == "masked":
        p = g.masked[True]
        (T1, mb1), (T2, mb2) = (tp._upload_table(t, CPU)
                                for t in (p.t1, p.t2))

        def run(c):
            return tp._merge_seeds_sum(T1, T2, c, 10, maskb1=mb1,
                                       maskb2=mb2, **mk)
        host = tmerge.adaptamer_seeds(p.t1, p.t2, freq=10, soft_mask=True)
    elif what == "symmetric":
        p = g.sym
        (T1, _), (T2, _) = (tp._upload_table(t, CPU)
                            for t in (p.t1, p.t2))

        def run(c):
            return tp._merge_seeds_sum(T2, T1, c, 10, flip=True)
        host = tmerge.adaptamer_seeds_flip(p.t1, p.t2, freq=10)
    else:
        p = g.selfm
        T, mb = tp._upload_table(p.t1, CPU)

        def run(c):
            return tp._self_seeds_sum(T, c, 10, maskb1=mb, **mk)
        host = tmerge.self_adaptamer_seeds(p.t1, freq=10, soft_mask=True)
    seen = _expansion_totals(monkeypatch)
    want = convert.outputs_to_numpy(run(0))
    total, kept = seen[-1][0], want[6]
    assert kept < total     # the pass drops seeds after the expansion
    cap = (kept + total) // 2
    got = convert.outputs_to_numpy(run(cap))
    assert (got[6], got[8]) == (host.n, int(host.plen.astype(np.int64)
                                            .sum()))
    assert got[6:] == want[6:]
    assert seen[-1] == (total, cap, tp._pad_bucket(max(total, 1 << 13)))
    for i in range(6):
        assert _eq(want[i][:kept], got[i][:kept]), f"column {i}"


# -- align_genomes' routing ---------------------------------------------------

@pytest.fixture
def no_waves(monkeypatch):
    """align_genomes without its wave phase (the routing tests read the
    seed stats only)."""
    monkeypatch.setattr(tal, "_device_align", lambda *a: [])


def _routes(monkeypatch):
    """Record the device seed functions align_genomes calls."""
    calls = []
    for name in ("device_tubes", "device_tubes_self", "device_tubes_paneled",
                 "device_tubes_tables"):
        fn = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("case", ["M", "mask", "S", "self_table"])
def test_routes_seed_on_device(g, monkeypatch, no_waves, case):
    """-M (host tables built without masks), a pair of masked tables (hard
    masks, as a .gix built with #mask), -S, and a self comparison with its
    table each seed on the device with the host path's seeds and tubes."""
    calls = _routes(monkeypatch)
    params = tal.FastGAParams(soft_mask=case == "M")
    if case == "M":
        p = g.masked[True]
        want = _host(SimpleNamespace(**{**vars(p), "t1": tgix.build_gix(
            p.g1), "t2": tgix.build_gix(p.g2)}), soft=True)
        args = (p.g1, p.g2)
    elif case == "mask":
        p, want = g.masked[False], g.host["masked", False]
        args = (p.g1, p.g2, p.t1, p.t2)
    elif case == "S":
        p, want = g.sym, g.host["sym"]
        args = (p.g1, p.g2)
    else:
        p = g.selfm
        t = tgix.build_gix(p.g1)
        want = _host(SimpleNamespace(**{**vars(p), "t1": t}), selfish=True)
        args = (p.g1, p.g1, t, t)
    _, stats = tal.align_genomes(*args, params=params, device="cpu",
                                 symmetric=case == "S")
    assert calls == ["device_tubes" if case == "S" else "device_tubes_tables"]
    assert stats["seed_pipeline"] == "device"
    assert (stats["nseeds"], stats["nhits"]) == (want[1], want[0].n)


def test_symmetric_past_single_shot_bases_declines_to_host(g, monkeypatch,
                                                           capsys, no_waves):
    """-S has no paneled route (nor has the JAX package): past
    _MAX_DEV_BASES the host seeds the pair."""
    p = g.sym
    calls = _routes(monkeypatch)
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", 1000)
    _, stats = tal.align_genomes(p.g1, p.g2, device="cpu", symmetric=True)
    reason = "genome exceeds single-shot device bases"
    assert calls == ["device_tubes"]
    assert stats["seed_pipeline"] == "host" and stats["seed_decline"] == reason
    assert (stats["nseeds"], stats["nhits"]) == (g.host["sym"][1],
                                                 g.host["sym"][0].n)
    assert f"device seed pipeline declined ({reason})" in \
        capsys.readouterr().err


def test_freq_past_device_cap_with_masks_declines(g, monkeypatch, capsys,
                                                  no_waves):
    """-f 11 with masked tables: device_tubes_tables declines with the JAX
    package's reason and the host seeds the run."""
    p = g.masked[True]
    dp.DECLINE = None
    assert dp.device_tubes_tables(p.jt1, p.jt2, p.alens, p.amax, p.bmax,
                                  freq=11, soft_mask=True) is None
    calls = _routes(monkeypatch)
    _, stats = tal.align_genomes(
        p.g1, p.g2, p.t1, p.t2, device="cpu",
        params=tal.FastGAParams(freq=11, soft_mask=True))
    assert calls == ["device_tubes_tables"]
    assert stats["seed_pipeline"] == "host"
    assert stats["seed_decline"] == dp.DECLINE \
        == "-f 11 > device merge cap 10"
    assert ("device seed pipeline declined (-f 11 > device merge cap 10)"
            in capsys.readouterr().err)


def test_tables_route_error_propagates(g, monkeypatch, no_waves):
    """An error on the device in the tables route reaches the caller: no
    other route, no host seeds."""
    calls = _routes(monkeypatch)

    def boom(*a, **k):
        calls.append("device_tubes_tables")
        raise RuntimeError("out of memory on the device")

    def host(*a, **k):
        raise AssertionError("host seeds after a device error")
    monkeypatch.setattr(tp, "device_tubes_tables", boom)
    for fn in ("self_adaptamer_seeds", "adaptamer_seeds"):
        monkeypatch.setattr(tmerge, fn, host)
    p = g.masked[True]
    with pytest.raises(RuntimeError, match="out of memory on the device"):
        tal.align_genomes(p.g1, p.g2, p.t1, p.t2, device="cpu",
                          params=tal.FastGAParams(soft_mask=True))
    assert calls == ["device_tubes_tables"]
