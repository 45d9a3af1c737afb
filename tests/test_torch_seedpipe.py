"""The port's device seed pipeline against the JAX package, exactly: the
plain versions of its two kernels (fused_scan against
scan_pallas.fused_scan_ref, merge_sorted_streams against lax.sort and the
bitonic merge), then the GIX tables, the adaptamer merge, the chain sweep,
device_tubes and align_genomes on the CPU.  Every quantity is an integer;
the tolerance is zero."""

from types import SimpleNamespace

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io.gix import _length_perm
from fastga_tpu.models import aligner as jal
from fastga_tpu.ops import device_pipeline as dp
from fastga_tpu.ops.scan_pallas import fused_scan_ref
from fastga_tpu.utils import dna
from fastga_tpu_torch import convert
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import chain as tchain
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import merge as tmerge
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.ops.cuda_build import LAUNCHES
from fastga_tpu_torch.ops.merge_kernels import merge_sorted_streams
from fastga_tpu_torch.ops.scan_kernels import fused_scan
from fastga_tpu_torch.utils import synth
from tests.conftest import mutate
from tests.test_device_pipeline import _gdb, _mutate
from tests.test_gdb import write_fasta

CPU = torch.device("cpu")
I32MIN, I32MAX = -2 ** 31, 2 ** 31 - 1
I64MAX = np.int64(0x7FFFFFFFFFFFFFFF)
TUBE_FIELDS = ("acont", "bcont", "comp", "dgmin", "dgmax", "alow", "ahgh",
               "pairing", "cov")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b):
    """Equal integer values and shapes (None only equals None)."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.astype(np.int64),
                                                 b.astype(np.int64))


def _assert_tuples(jax_out, port_out):
    port = convert.outputs_to_numpy(port_out)
    assert len(jax_out) == len(port)
    for i, (a, b) in enumerate(zip(jax_out, port)):
        assert _eq(None if a is None else np.asarray(a), b), f"entry {i}"


def _assert_tubes(want, got):
    assert got.n == want.n
    for f in TUBE_FIELDS:
        assert _eq(getattr(want, f), getattr(got, f)), f


# -- the plain kernels --------------------------------------------------------

SPECS = {
    # tests/test_scan_pallas.py's six channels
    "six": (("sum", None), ("max", 0), ("min", 1), ("last", 1), ("sum", 0),
            ("max", None)),
    # the chain sweep's per-chain aggregates (device_pipeline.py:1229-1231)
    "chain13": (("max", 0),) * 13,
    # the chain sweep's int64 coverage sum (the port's fused_scan channel)
    "cov64": (("sum64", 0),),
}


def _sum64_oracle(x, flag, reverse):
    """The segmented int64 sum, one row at a time."""
    out = np.zeros(len(x), np.int64)
    run = 0
    for i in (range(len(x) - 1, -1, -1) if reverse else range(len(x))):
        run = int(x[i]) if flag[i] else run + int(x[i])
        out[i] = run
    return out


@pytest.mark.parametrize("spec_name", sorted(SPECS))
@pytest.mark.parametrize("M", [1, 1000, 4096 + 37])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_scan_plain_matches_oracle(spec_name, M, reverse):
    spec = SPECS[spec_name]
    rng = np.random.default_rng(M * 7 + reverse)
    flags = [(rng.random(M) < p).astype(np.int32) for p in (0.02, 0.3)]
    flags[0][0] = flags[0][-1] = 1
    vals = []
    for c, (op, _) in enumerate(spec):
        if op == "sum64":   # sums far past int32, of either sign
            v = rng.integers(-2 ** 40, 2 ** 40, M)
        elif op == "sum":   # full-range values: the sums overflow int32
            v = rng.integers(I32MIN, I32MAX, M, endpoint=True)
        else:
            v = rng.integers(-1000, 1000, M)
            v[rng.random(M) < 0.01] = I32MIN if c % 2 else I32MAX
        vals.append(v.astype(np.int64 if op == "sum64" else np.int32))
    wide = spec_name == "cov64"
    want = ([_sum64_oracle(vals[0], flags[0], reverse)] if wide
            else fused_scan_ref(vals, spec, flags, reverse=reverse))
    got = fused_scan([torch.as_tensor(v) for v in vals], spec,
                     [torch.as_tensor(f) for f in flags], reverse=reverse)
    assert LAUNCHES["fused_scan"] == 0
    for c in range(len(spec)):
        assert got[c].dtype == (torch.int64 if wide else torch.int32)
        np.testing.assert_array_equal(got[c].numpy(), want[c],
                                      err_msg=f"channel {c} {spec[c]}")


def _mk_stream(rng, E, nvalid, parity):
    """tests/test_merge_pallas.py's streams: sorted k1, payloads riding,
    +MAX tails."""
    k1 = np.sort(rng.integers(-2 ** 62, 2 ** 62, nvalid, dtype=np.int64))
    k2 = (rng.integers(0, 2 ** 61, nvalid, dtype=np.int64) // 2) * 2 + parity
    v1 = rng.integers(0, 2 ** 62, nvalid, dtype=np.int64)
    v2 = rng.integers(0, 2 ** 62, nvalid, dtype=np.int64)
    pad = np.full(E - nvalid, I64MAX)
    return tuple(np.concatenate([x, pad]) for x in (k1, k2, v1, v2))


@pytest.mark.parametrize("geom", [(3000, 3000, 2900, 2950),   # balanced
                                  (2500, 1800, 2400, 5),      # 5 live rows
                                  (1001, 777, 990, 700),      # not % 128
                                  (1536, 1200, 1536, 1100)])  # no A tail
def test_merge_plain_matches_lax_sort(geom):
    E1, E2, n1, n2 = geom
    rng = np.random.default_rng(E1 * 31 + E2)
    A = _mk_stream(rng, E1, n1, 0)
    B = _mk_stream(rng, E2, n2, 1)
    got = merge_sorted_streams(tuple(map(torch.as_tensor, A)),
                               tuple(map(torch.as_tensor, B)))
    assert LAUNCHES["merge_path"] == 0
    nval = n1 + n2
    with jax.enable_x64():
        cat = tuple(jnp.asarray(np.concatenate([a, b])) for a, b in zip(A, B))
        ref = jax.lax.sort(cat, num_keys=2)
        bit = dp._bitonic_merge_sorted(jax, jnp, E1, cat)
    for i in range(4):
        np.testing.assert_array_equal(got[i].numpy()[:nval],
                                      np.asarray(ref[i])[:nval])
        np.testing.assert_array_equal(got[i].numpy()[:nval],
                                      np.asarray(bit[i])[:nval])
        assert got[i].shape == (E1 + E2,)


@pytest.mark.parametrize("p", [0.0, 0.0003])
def test_sum64_matches_jax_seg_cumsum(p):
    """The int64 channel against the JAX package's coverage route
    (device_pipeline._seg_cumsum, exact below 2^36) on sums past 2^31."""
    rng = np.random.default_rng(int(p * 1e4) + 17)
    M = 20_000
    x = rng.integers(0, 2 ** 20, M, endpoint=True).astype(np.int32)
    start = rng.random(M) < p
    got = fused_scan((torch.as_tensor(x),), (("sum64", 0),),
                     (torch.as_tensor(start),))[0]
    with jax.enable_x64():
        want = np.asarray(dp._seg_cumsum(jax, jnp, jnp.asarray(x),
                                         jnp.asarray(start)))
    assert got.dtype == torch.int64 and want.max() > 2 ** 31
    np.testing.assert_array_equal(got.numpy(), want)


def test_chain_coverage_int64_route_matches_jax():
    """The chain sweep's int64 coverage route (the port's _seg_cumsum, on
    fused_scan's sum64 channel) on chain-shaped rows (novel bases <= 255, a
    break at row 0) equals the JAX package's route and the int32 route."""
    rng = np.random.default_rng(0xC0F)
    M = 30_000
    novel = rng.integers(0, 256, M).astype(np.int32)
    novel[rng.random(M) < 0.1] = 0
    brk = rng.random(M) < 0.01
    brk[0] = True
    got = tp._seg_cumsum(torch.as_tensor(novel), torch.as_tensor(brk))
    with jax.enable_x64():
        want = np.asarray(dp._seg_cumsum(jax, jnp, jnp.asarray(novel),
                                         jnp.asarray(brk)))
    cov32 = fused_scan((torch.as_tensor(novel),), (("sum", 0),),
                       (torch.as_tensor(brk.astype(np.int32)),))[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), cov32.numpy())


def test_fused_scan_refuses_mixed_widths():
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="goes alone"):
        fused_scan((v, v), (("sum64", 0), ("max", 0)), (v,))


def test_kernel_wrappers_check_their_arguments():
    v = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown op"):
        fused_scan((v,), (("prod", None),))
    with pytest.raises(ValueError, match="flag id"):
        fused_scan((v,), (("max", 1),), (v,))
    with pytest.raises(ValueError, match="columns"):
        merge_sorted_streams((v.long(),), (v.long(),))


# -- the pipeline -------------------------------------------------------------

def _alens(lens):
    lens_eff = np.concatenate([lens, np.full(max(0, 8 - len(lens)), 40,
                                             np.int64)])
    perm = _length_perm(lens_eff)[0]
    return np.where(perm < len(lens), lens[np.minimum(perm, len(lens) - 1)],
                    40)


@pytest.fixture(scope="module")
def genomes():
    """Five contigs of 1.5-12 kb (the first 5,003 bases: not a multiple of
    4), each mutated 2-8% with the middle third of every third inverted;
    the JAX package's device pipeline run on them, its stage outputs, and
    the port's GDBs of the same bases."""
    rng = np.random.default_rng(0x5EED)
    lens = [5003] + [int(rng.integers(1500, 12000)) for _ in range(4)]
    A = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    B = []
    for i, a in enumerate(A):
        b = _mutate(a, float(rng.uniform(0.02, 0.08)), rng)
        if i % 3 == 2:
            q = len(b) // 3
            b[q:2 * q] = (3 - b[q:2 * q])[::-1]
        B.append(b)
    jg1, jg2 = _gdb(A), _gdb(B)
    tg1, tg2 = synth.to_gdb("a", A)[0], synth.to_gdb("b", B)[0]
    lens1, lens2 = jg1.contig_lengths(), jg2.contig_lengths()
    alens = _alens(lens1)
    jres = dp.device_tubes(jg1, jg2, alens)
    assert jres is not None and jres[0].n > 0
    # the stage inputs and outputs device_tubes made (its jit cache holds
    # the programs)
    N1, N2 = dp._pad_bucket(lens1.sum()), dp._pad_bucket(lens2.sum())
    with jax.enable_x64():
        bps, coff, clen, _, invp, nc, _ = dp._prep_genome(jg1, lens1)
        C1 = dp._cand_jit(N1, len(coff))(bps, coff, clen, invp, nc)
        T1 = dp._drvtab_jit(N1, min(dp._pad_bucket(int(C1[7])), N1))(C1)
        bps, coff, clen, _, invp, nc, _ = dp._prep_genome(jg2, lens2)
        Tf = dp._gix_jit(N2, len(coff), N2)(bps, coff, clen, invp, nc)
        Et = min(dp._pad_bucket(int(Tf[7])), N2)
        T2 = tuple(x[:Et] for x in Tf[:7]) + (Tf[7], Tf[8][:Et])
        nscap, acap = N1, max(N1 // 2, 1 << 12)
        mout = dp._merge_jit(T1[0].shape[0], Et, nscap, acap, 10, False,
                             False, presorted=True)(T1, T2, None, None)
    return SimpleNamespace(
        A=A, B=B, jg1=jg1, jg2=jg2, tg1=tg1, tg2=tg2, alens=alens,
        amax=int(lens1.max()), bmax=int(lens2.max()), jres=jres,
        T1=[None if x is None else np.asarray(x) for x in T1],
        T2=[np.asarray(x) for x in T2], nscap=nscap,
        mout=[np.asarray(x) for x in mout])


def test_gix_arrays_and_driver_table_match_jax(genomes):
    """Both packages' genome prep, sorted GIX tables, driver candidates and
    driver table, on the repack branch (a contig length not a multiple of
    4) and the byte-aligned branch (every length cut to a multiple of
    4)."""
    aligned = [a[:len(a) // 4 * 4] for a in genomes.A]
    cases = ((genomes.jg1, genomes.tg1), (genomes.jg2, genomes.tg2),
             (_gdb(aligned), synth.to_gdb("c", aligned)[0]))
    for jg, tg in cases:
        lens = jg.contig_lengths()
        with jax.enable_x64():
            bps, coff, clen, _, invp, nc, N = dp._prep_genome(jg, lens)
            J = dp._gix_jit(N, len(coff), N)(bps, coff, clen, invp, nc)
            C = dp._cand_jit(N, len(coff))(bps, coff, clen, invp, nc)
            ecap = min(dp._pad_bucket(int(C[7])), N)
            JD = dp._drvtab_jit(N, ecap)(C)
        tb, tcoff, tclen, tinvp, tnc, tN = tp._prep_genome(tg, lens, CPU)
        assert tN == N and tnc == int(nc)
        for a, b in ((bps, tb), (coff, tcoff), (clen, tclen), (invp, tinvp)):
            assert _eq(np.asarray(a), b.numpy())
        # the JAX table keeps N of its 2N rows
        G = tp.gix_arrays(tb, tcoff, tclen, tinvp, tnc)
        _assert_tuples(J, tuple(x[:N] for x in G[:7]) + (G[7], G[8][:N]))
        TC = tp.driver_candidates(tb, tcoff, tclen, tinvp, tnc)
        _assert_tuples(C, TC)
        _assert_tuples(JD, tp.driver_table(TC, ecap))


def test_merge_seeds_matches_jax(genomes):
    T1 = convert.table_from_numpy(genomes.T1, CPU)
    T2 = convert.table_from_numpy(genomes.T2, CPU)
    got = convert.outputs_to_numpy(
        tp._merge_seeds_sum(T1, T2, genomes.nscap, 10))
    want = genomes.mout
    ns = int(want[6])
    assert ns > 0
    assert got[6:] == tuple(int(x) for x in want[6:])   # ns, nalive, plsum
    for i in range(6):
        assert _eq(want[i][:ns], got[i][:ns]), f"column {i}"


@pytest.mark.parametrize("chain_break", [2000, 200])
def test_chain_tubes_dev_matches_jax(genomes, chain_break):
    """The closed-form break test (chain_break >= 256) and the fixpoint
    loop below it: all ten outputs, the tube arrays one row a tube (the
    JAX package's first rows of its tube cap's)."""
    ns = int(genomes.mout[6])
    nscap = min(dp._pad_bucket(max(ns, 1 << 13)), genomes.nscap)
    seeds = [x[:nscap] for x in genomes.mout[:6]]
    alens_pad = np.zeros(8, np.int32)
    alens_pad[:len(genomes.alens)] = genomes.alens
    tcap = dp._tcap_for(genomes.nscap, 1 << 15)
    with jax.enable_x64():
        J = dp._chain_jit(nscap, tcap, chain_break, 170)(
            tuple(jnp.asarray(s) for s in seeds), jnp.int32(ns),
            np.int32(genomes.amax), np.int32(genomes.bmax),
            jnp.asarray(alens_pad))
    T = tp.chain_tubes_dev(convert.seeds_from_numpy(seeds, CPU), ns,
                           genomes.amax, genomes.bmax,
                           torch.as_tensor(alens_pad), chain_break, 170)
    n = int(np.asarray(J[9]))
    assert 0 < n < tcap
    _assert_tuples([np.asarray(x)[:n] for x in J[:9]] + [J[9]], T)


def test_device_tubes_matches_jax_and_host(genomes):
    tubes, nseeds, plsum = tp.device_tubes(genomes.tg1, genomes.tg2,
                                           genomes.alens, device=CPU)
    jt, jn, jp = genomes.jres
    assert (nseeds, plsum) == (jn, jp)
    _assert_tubes(jt, tubes)
    # the port's host path on the same genomes
    t1, t2 = tgix.build_gix(genomes.tg1), tgix.build_gix(genomes.tg2)
    seeds = tmerge.adaptamer_seeds(t1, t2, freq=10)
    assert (seeds.n, int(seeds.plen.astype(np.int64).sum())) == (nseeds,
                                                                  plsum)
    _assert_tubes(tchain.chain_tubes(seeds, genomes.amax, genomes.bmax,
                                     genomes.alens), tubes)
    assert LAUNCHES["merge_path"] == LAUNCHES["fused_scan"] == 0


@pytest.mark.parametrize("branch", ["monolithic", "paneled",
                                    "contig overflow",
                                    "some contigs overflow",
                                    "a contig at the panel's size"])
def test_device_tubes_chain_branches(genomes, monkeypatch, capsys, branch):
    """Up to CHAIN_DEV_CAP seeds one sweep; past it the sweep panels by
    A-contig ranges of CHAIN_DEV_CAP // 2 seeds, and a contig with more
    seeds than that takes a window of its own seeds' bucket.  With a
    contig past a panel, and past 6 x CHAIN_DEV_CAP seeds (both at once in
    "contig overflow"), where the JAX package chains on the host, the
    sweep stays on the device.  The tubes, seeds and seed-length sum are the JAX package's on
    every branch, and nothing is printed."""
    ns = genomes.jres[1]
    bucket = dp._pad_bucket(max(ns, 1 << 13))
    perc = np.bincount(genomes.mout[1][:ns])     # seeds of each A contig
    cap = {"monolithic": tp.CHAIN_DEV_CAP,
           # just below the seeds' bucket: every contig fits a panel
           "paneled": bucket - 1,
           "contig overflow": 1 << 8,
           # a panel between the fewest and the most seeds of a contig
           "some contigs overflow": 2 * int(np.median(perc)),
           # the largest contig's seeds fill a panel exactly
           "a contig at the panel's size": 2 * int(perc.max())}[branch]
    monkeypatch.setattr(tp, "CHAIN_DEV_CAP", cap)
    if branch == "contig overflow":
        assert bucket > 6 * cap
    windows, sweeps = [], []
    panel, sweep = tp._chain_panel, tp.chain_tubes_dev
    monkeypatch.setattr(tp, "_chain_panel", lambda *a: windows.append(
        (a[4], a[5])) or panel(*a))
    monkeypatch.setattr(tp, "chain_tubes_dev", lambda *a: sweeps.append(
        a[0][0].shape[0]) or sweep(*a))
    tubes, nseeds, plsum = tp.device_tubes(genomes.tg1, genomes.tg2,
                                           genomes.alens, device=CPU)
    assert (nseeds, plsum) == genomes.jres[1:]
    _assert_tubes(genomes.jres[0], tubes)
    assert capsys.readouterr().err == ""
    if branch == "monolithic":
        assert windows == [] and sweeps == [bucket]
        return
    PANEL = cap // 2
    assert sum(n for n, _ in windows) == ns and len(sweeps) == len(windows)
    for (n, w), rows in zip(windows, sweeps):
        assert w == max(PANEL, tp._pad_bucket(n)) and rows <= w
    big = int((perc > PANEL).sum())
    assert sum(n > PANEL for n, _ in windows) == big
    if branch == "some contigs overflow":
        assert 0 < big < len(perc)
    else:
        assert big == {"contig overflow": len(perc)}.get(branch, 0)
    if branch == "a contig at the panel's size":
        assert max(n for n, _ in windows) >= PANEL == perc.max()


def test_device_tubes_decline_matches_jax(genomes):
    dp.DECLINE = None
    assert dp.device_tubes(genomes.jg1, genomes.jg2, genomes.alens,
                           freq=11) is None
    with pytest.raises(tp.Declined) as e:
        tp.device_tubes(genomes.tg1, genomes.tg2, genomes.alens, freq=11,
                        device=CPU)
    assert e.value.reason == dp.DECLINE == "-f 11 > device merge cap 10"


def _key(o):
    return (o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos, o.bcomp,
            o.diffs, [tuple(t) for t in o.trace])


def test_align_genomes_device_seeds(tmp_path, capsys):
    """tests/test_torch_aligner.py's pair (14 kb with an inversion): the
    device seed path on the CPU gives the JAX device pipeline's seed count,
    the tubes of the port's host seed functions and the records of
    fastga_tpu's engine="ref"; a decline is loud and falls back to the host
    seeds."""
    rng = np.random.default_rng(0xFA57A)
    a = rng.integers(0, 4, 14000).astype(np.uint8)
    b = mutate(rng, a, sub=0.03, ins=0.006, dele=0.006)
    b = np.concatenate([b[:4000], (3 - b[4000:8000])[::-1], b[8000:]])
    write_fasta(tmp_path / "a.fa", [("a", dna.to_ascii(a, True).decode())])
    write_fasta(tmp_path / "b.fa", [("b", dna.to_ascii(b, True).decode())])
    j1, _ = jgdb.create_gdb(tmp_path / "a.fa", tmp_path / "a")
    j2, _ = jgdb.create_gdb(tmp_path / "b.fa", tmp_path / "b")
    ref, _ = jal.align_genomes(j1, j2, engine="ref")
    jdev = dp.device_tubes(j1, j2, _alens(j1.contig_lengths()))
    g1 = convert.gdb_from_arrays([j1.get_contig(0)], ["a"])
    g2 = convert.gdb_from_arrays([j2.get_contig(0)], ["b"])
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    got, stats = tal.align_genomes(g1, g2, device="cpu", cfg=cfg)
    t1, t2 = tgix.build_gix(g1), tgix.build_gix(g2)
    seeds = tmerge.adaptamer_seeds(t1, t2, freq=10)
    lens1, lens2 = g1.contig_lengths(), g2.contig_lengths()
    host = tchain.chain_tubes(seeds, int(lens1.max()), int(lens2.max()),
                              _alens(lens1))
    assert stats["seed_pipeline"] == "device"
    assert stats["nseeds"] == seeds.n == jdev[1]
    assert stats["nhits"] == host.n == jdev[0].n
    _assert_tubes(host, jdev[0])
    assert len(ref) > 0
    assert [_key(o) for o in got] == [_key(o) for o in ref]
    _, dstats = tal.align_genomes(
        g1, g2, params=tal.FastGAParams(freq=11), device="cpu", cfg=cfg)
    assert dstats["seed_pipeline"] == "host"
    assert dstats["seed_decline"] == "-f 11 > device merge cap 10"
    assert "device seed pipeline declined" in capsys.readouterr().err
