"""The port's sharded seed pipeline (fastga_tpu_torch/parallel) on gloo ranks
on the CPU, against the JAX package, exactly (every quantity an integer;
tolerance zero).

One module fixture spawns a 2-rank and a 4-rank group once, each rank a
process of its own (``distributed.init`` on a free port, ``device="cpu"``,
one thread), and each rank writes its results to a file.  The tests here
hold them against the JAX package's ``sharded_tubes`` on ``make_mesh(2)``
(two of the conftest's eight virtual CPU devices), the port's single-device
routes and the host seed path: a pair with inversions (tests/test_sharded.py's
rng 77) and a self comparison (rng 101) at 2 and 4 ranks;
``align_genomes(mesh=)`` at 2 ranks; an input past the JAX route's caps (a
1 kb unit 40 times in A and 9 times in B: one prefix owner's seeds pass the
JAX per-shard seed slots, so the JAX route returns None); the declines;
``mesh.py``'s three steps at __graft_entry__.py's shapes and
``syncmer_mask``.  One test needs the card (world size 1 on NCCL) and skips
without one.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastga_tpu.models import aligner as jal
from fastga_tpu.ops import chain as jchain
from fastga_tpu.ops import device_pipeline as jdp
from fastga_tpu.ops import merge as jmerge
from fastga_tpu.ops import syncmer as jsyncmer
from fastga_tpu.ops import wave as jwave
from fastga_tpu.io import gix as jgix
from fastga_tpu.ops.wave_ref import AlignSpec as JAlignSpec
from fastga_tpu.parallel import mesh as jmesh
from fastga_tpu.parallel import sharded as jsharded
from fastga_tpu_torch import convert
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import syncmer as tsyncmer
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.parallel import distributed as tdistm
from fastga_tpu_torch.parallel import sharded as tsharded
from tests.test_device_pipeline import _gdb, _mutate
from tests.test_torch_seedpipe import _alens, _assert_tubes, _key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(n=16, w=256, chunk=64, max_chunks=64)
MESH_CFG = dict(n=4, w=64, chunk=8, max_chunks=2)   # __graft_entry__.py's
RANK_TIMEOUT = 600

WORKER = r"""
import pickle, sys
import numpy as np
import torch

D, rank, port, inp, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
from fastga_tpu_torch import convert
from fastga_tpu_torch.models import aligner
from fastga_tpu_torch.ops import wave, wave_ref
from fastga_tpu_torch.parallel import distributed as dist, mesh as pmesh
from fastga_tpu_torch.parallel import sharded

assert dist.init(f"127.0.0.1:{port}", D, rank, device="cpu", timeout=300)
mesh = dist.global_mesh()
assert (mesh.size, mesh.rank, mesh.backend) == (D, rank, "gloo"), mesh
with open(inp, "rb") as f:
    inputs = pickle.load(f)
res = {}

def gdbs(name):
    A, B = inputs[name]
    g1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(len(A))])
    g2 = None if B is None else convert.gdb_from_arrays(
        B, [f"b{i}" for i in range(len(B))])
    return g1, g2

for name in ("pair", "self") + (("past",) if D == 2 else ()):
    g1, g2 = gdbs(name)
    res[name] = sharded.sharded_tubes(g1, g2, inputs["alens"][name], mesh)
if D == 2:
    cfg = wave.WaveConfig(**inputs["cfg"])
    g1, g2 = gdbs("e2e")
    res["e2e"] = aligner.align_genomes(g1, g2, device="cpu", cfg=cfg,
                                       mesh=mesh)
    g1, g2 = gdbs("past")
    aligner._device_align = lambda *a: []     # the seed stats only
    res["past_stats"] = aligner.align_genomes(g1, g2, device="cpu",
                                              mesh=mesh)[1]
    m = inputs["mesh"]
    step = pmesh.sharded_wave_step(pmesh.make_mesh(D, device="cpu"),
                                   wave_ref.AlignSpec(0.7),
                                   wave.WaveConfig(**m["cfg"]))
    res["wave_step"] = step(*(torch.as_tensor(x) for x in m["wave"]))
    res["histogram"] = pmesh.sharded_seed_histogram(mesh)(
        torch.as_tensor(m["bases"]), torch.as_tensor(m["lens"]))
    res["exchange"] = pmesh.sharded_seed_exchange(mesh, D)(
        torch.as_tensor(m["seeds"]))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _pair77():
    rng = np.random.default_rng(77)
    A = [rng.integers(0, 4, int(rng.integers(3000, 14000)))
         .astype(np.uint8) for _ in range(6)]
    B = []
    for i, a in enumerate(A):
        b = _mutate(a, float(rng.uniform(0.02, 0.06)), rng)
        if i % 3 == 1:
            q = len(b) // 3
            b[q:2 * q] = (3 - b[q:2 * q])[::-1]
        B.append(b)
    return A, B


def _self101():
    rng = np.random.default_rng(101)
    A = []
    for _ in range(4):
        base = rng.integers(0, 4, int(rng.integers(4000, 10000))
                            ).astype(np.uint8)
        rep_seg = base[:len(base) // 3]
        A.append(np.concatenate([base, _mutate(rep_seg, 0.03, rng)]))
    return A, None


def _e2e99():
    rng = np.random.default_rng(99)
    A = [rng.integers(0, 4, 9000).astype(np.uint8) for _ in range(3)]
    return A, [_mutate(a, 0.03, rng) for a in A]


def _past():
    """A 1 kb unit 40 times over four A contigs and 9 times over three B
    contigs, between random 300-base spacers: every A entry of the unit
    has 9 B members (below freq 10), so the unit's 40 x 9 copies give
    most of the pair's 135,467 seeds: more than the JAX route's 2 x
    65,536 per-shard seed slots on a 2-device mesh."""
    rng = np.random.default_rng(4321)
    unit = rng.integers(0, 4, 1000).astype(np.uint8)

    def genome(ncopy, nctg):
        out = []
        for _ in range(nctg):
            parts = []
            for _ in range(ncopy // nctg):
                parts += [rng.integers(0, 4, 300).astype(np.uint8), unit]
            parts.append(rng.integers(0, 4, 300).astype(np.uint8))
            out.append(np.concatenate(parts))
        return out
    return genome(40, 4), genome(9, 3)


def _mesh_inputs():
    """__graft_entry__.py's dryrun_multichip inputs at 2 devices: 8 tubes
    of 2 kb (4 a shard), 2 x 4,096 random bases, 2 x 2 x 8 x 4 seeds."""
    from __graft_entry__ import _synthetic
    pool, aw, bw, ln = _synthetic(8, 2048)
    nt = len(aw)
    bases = np.random.default_rng(3).integers(0, 4, (2, 1, 4096)) \
        .astype(np.int32)
    return dict(
        cfg=MESH_CFG, words=pool.words,
        wave=(convert.pool_from_numpy(pool.words, "cpu").numpy(), aw, ln,
              bw, ln, np.full(nt, -2, np.int32), np.full(nt, 2, np.int32),
              np.full(nt, 2048, np.int32)),
        bases=bases, lens=np.full((2, 1), 4096, np.int32),
        seeds=np.arange(2 * 2 * 8 * 4, dtype=np.int32).reshape(2, 2, 8, 4))


def _inputs():
    cases = dict(pair=_pair77(), self=_self101(), e2e=_e2e99(),
                 past=_past())
    alens = {}
    for name, (A, _) in cases.items():
        alens[name] = _alens(np.array([len(a) for a in A], np.int64))
    return dict(cases, alens=alens, cfg=CFG, mesh=_mesh_inputs())


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both groups' results: {D: [rank 0's, rank 1's, ...]}, the two groups
    run at once, every rank with a timeout."""
    d = tmp_path_factory.mktemp("sharded")
    inp = d / "inputs.pkl"
    with open(inp, "wb") as f:
        pickle.dump(_inputs(), f)
    w = d / "worker.py"
    w.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    procs = {}
    for D in (2, 4):
        port = _free_port()
        procs[D] = [subprocess.Popen(
            [sys.executable, str(w), str(D), str(r), str(port), str(inp),
             str(d / f"out{D}_{r}.pkl")], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(D)]
    logs = {}
    try:
        for D, ps in procs.items():
            for r, p in enumerate(ps):
                logs[D, r] = p.communicate(timeout=RANK_TIMEOUT)[0].decode(
                    errors="replace")
    finally:
        for ps in procs.values():
            for p in ps:
                p.kill()
    bad = [f"D={D} rank {r} failed:\n{logs[D, r][-2000:]}"
           for D, ps in procs.items() for r, p in enumerate(ps)
           if p.returncode != 0]
    assert not bad, "\n".join(bad)
    out = {}
    for D in procs:
        out[D] = []
        for r in range(D):
            with open(d / f"out{D}_{r}.pkl", "rb") as f:
                out[D].append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _jax_gdbs(inputs, name):
    A, B = inputs[name]
    g1 = _gdb(A)
    return g1, (None if B is None else _gdb(B))


def _host(inputs, name):
    """The host seed path's (TubeBatch, seeds, seed-length sum)."""
    g1, g2 = _jax_gdbs(inputs, name)
    t1 = jgix.build_gix(g1)
    amax = int(g1.contig_lengths().max())
    if g2 is None:
        seeds = jmerge.self_adaptamer_seeds(t1, freq=10)
        bmax = amax
    else:
        seeds = jmerge.adaptamer_seeds(t1, jgix.build_gix(g2), freq=10)
        bmax = int(g2.contig_lengths().max())
    tubes = jchain.chain_tubes(seeds, amax, bmax, inputs["alens"][name])
    return tubes, seeds.n, int(seeds.plen.astype(np.int64).sum())


def _same(want, got):
    assert tuple(got[1:]) == tuple(want[1:])   # seeds, length sum
    _assert_tubes(want[0], got[0])


def _single(inputs, name):
    """The port's single-device route on the CPU."""
    A, B = inputs[name]
    g1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(len(A))])
    if B is None:
        return tp.device_tubes_self(g1, inputs["alens"][name], device="cpu")
    g2 = convert.gdb_from_arrays(B, [f"b{i}" for i in range(len(B))])
    return tp.device_tubes(g1, g2, inputs["alens"][name], device="cpu")


@pytest.mark.parametrize("name", ["pair", "self"])
def test_sharded_tubes_match_jax_single_and_host(ranks, inputs, name):
    """At 2 and 4 ranks, every rank's result equals the JAX sharded route
    on two devices, the port's single-device route and the host path."""
    g1, g2 = _jax_gdbs(inputs, name)
    want = jsharded.sharded_tubes(g1, g2, inputs["alens"][name],
                                  jsharded.make_mesh(2))
    assert want is not None and want[0].n > 0
    _same(want, _host(inputs, name))
    _same(want, _single(inputs, name))
    for D in (2, 4):
        for r, res in enumerate(ranks[D]):
            _same(want, res[name])


def test_align_genomes_mesh_matches_single_and_jax(ranks, inputs):
    """align_genomes(mesh=) at 2 ranks: each rank returns the records of
    the port's single-device run and of the JAX align_genomes on a 2-device
    mesh, with stats["sharded"] == 2."""
    g1, g2 = _jax_gdbs(inputs, "e2e")
    jovls, jstats = jal.align_genomes(g1, g2, engine="jax",
                                      mesh=jsharded.make_mesh(2))
    assert jstats["sharded"] == 2
    A, B = inputs["e2e"]
    t1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(len(A))])
    t2 = convert.gdb_from_arrays(B, [f"b{i}" for i in range(len(B))])
    single, sstats = tal.align_genomes(t1, t2, device="cpu",
                                       cfg=tw.WaveConfig(**CFG))
    assert "sharded" not in sstats
    assert len(single) > 0
    want = [_key(o) for o in single]
    assert [_key(o) for o in jovls] == want
    for ovls, stats in (r["e2e"] for r in ranks[2]):
        assert stats["sharded"] == 2
        assert stats["seed_pipeline"] == "device"
        assert (stats["nseeds"], stats["nhits"]) == (sstats["nseeds"],
                                                     sstats["nhits"])
        assert [_key(o) for o in ovls] == want


def test_past_the_jax_caps_stays_on_device(ranks, inputs):
    """The JAX sharded route returns None on this input (its seed slots
    overflow); the port's sharded route sizes its exchanges to the counts
    and gives the host path's TubeBatch, and align_genomes seeds on the
    device."""
    g1, g2 = _jax_gdbs(inputs, "past")
    alens = inputs["alens"]["past"]
    assert jsharded.sharded_tubes(g1, g2, alens,
                                  jsharded.make_mesh(2)) is None
    want = _host(inputs, "past")
    for res in ranks[2]:
        _same(want, res["past"])
        stats = res["past_stats"]
        assert (stats["seed_pipeline"], stats["sharded"]) == ("device", 2)
        assert (stats["nseeds"], stats["nhits"]) == (want[1], want[0].n)


@pytest.mark.parametrize("what", ["contigs", "freq"])
def test_declines_before_upload_with_jax_reasons(what, capsys):
    """4,096 contigs, or -f 11: the JAX sharded route returns None, the
    port's raises Declined with the JAX package's reason (its
    device_tubes'), before any collective (the mesh here has no group),
    and align_genomes seeds on the host with the reason on stderr."""
    rng = np.random.default_rng(5)
    n = 4096 if what == "contigs" else 3
    A = [rng.integers(0, 4, 60 if what == "contigs" else 3000)
         .astype(np.uint8) for _ in range(n)]
    freq = 11 if what == "freq" else 10
    j1 = _gdb(A)
    alens = _alens(j1.contig_lengths())
    jdp.DECLINE = None
    assert jdp.device_tubes(j1, j1, alens, freq=freq) is None
    assert jsharded.sharded_tubes(j1, j1, alens, jsharded.make_mesh(2),
                                  freq=freq) is None
    t1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(n)])
    t2 = convert.gdb_from_arrays(A, [f"b{i}" for i in range(n)])
    mesh = tsharded.Mesh(2, 0, torch.device("cpu"), "gloo")
    with pytest.raises(tp.Declined) as e:
        tsharded.sharded_tubes(t1, t2, alens, mesh, freq=freq)
    assert e.value.reason == jdp.DECLINE
    if what == "freq":
        tal_params = tal.FastGAParams(freq=freq)
        _, stats = tal.align_genomes(t1, t2, params=tal_params,
                                     device="cpu", mesh=mesh,
                                     cfg=tw.WaveConfig(**CFG))
        assert stats["seed_pipeline"] == "host"
        assert "sharded" not in stats
        assert stats["seed_decline"] == jdp.DECLINE
        assert jdp.DECLINE in capsys.readouterr().err


def test_mesh_steps_match_jax(ranks, inputs):
    """mesh.py at 2 ranks: each rank's wave step (its 4 tubes' trim anti
    and the summed live count), histogram row and exchange block equal the
    JAX steps on a 2-device mesh at __graft_entry__.py's shapes."""
    m = inputs["mesh"]
    mesh = jmesh.make_mesh(2)
    cfg = jwave.WaveConfig(**MESH_CFG)
    step = jmesh.sharded_wave_step(mesh, JAlignSpec(0.7), cfg)
    _, aw, ln, bw, _, dgmin, dgmax, anti = m["wave"]
    with mesh:
        trima, alive = step(jnp.asarray(m["words"]), *(
            jnp.asarray(x) for x in (aw, ln, bw, ln, dgmin, dgmax, anti)))
        hist = jmesh.sharded_seed_histogram(mesh)(
            jnp.asarray(m["bases"]), jnp.asarray(m["lens"]))
        ex = jmesh.sharded_seed_exchange(mesh, 2)(jnp.asarray(m["seeds"]))
    trima, hist, ex = (np.asarray(x) for x in (trima, hist, ex))
    assert int(alive) > 0
    for r, res in enumerate(ranks[2]):
        t, a = res["wave_step"]
        assert np.array_equal(t.numpy(), trima[4 * r:4 * (r + 1)])
        assert int(a) == int(alive)
        assert np.array_equal(res["histogram"].numpy(), hist[r:r + 1])
        assert np.array_equal(res["exchange"].numpy(), ex[r:r + 1])


def test_syncmer_mask_matches_jax_and_positions():
    """syncmer_mask equals syncmer_mask_jnp on the same bases and length,
    and its positions are syncmer_positions'."""
    rng = np.random.default_rng(21)
    b = rng.integers(0, 4, 5000).astype(np.int32)
    for length in (5000, 3111):
        got = tsyncmer.syncmer_mask(torch.as_tensor(b), length).numpy()
        want = np.asarray(jsyncmer.syncmer_mask_jnp(jnp.asarray(b), length))
        assert np.array_equal(got, want)
    got = tsyncmer.syncmer_mask(torch.as_tensor(b), len(b)).numpy()
    assert np.array_equal(np.flatnonzero(got),
                          tsyncmer.syncmer_positions(b.astype(np.uint8)))


def test_init_without_configuration(monkeypatch):
    """distributed.init is a no-op returning False without a launcher's
    configuration (or with one process)."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdistm.init() is False
    assert tdistm.init("127.0.0.1:1", 1, 0) is False
    assert not tdistm.is_multiprocess()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_world_size_one_on_nccl(card, inputs):
    """A one-rank NCCL group on the card: the pair's sharded TubeBatch
    equals the port's single-device route on the card."""
    import torch.distributed as td
    td.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                          f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = tsharded.make_mesh(1, device=card)
        A, B = inputs["pair"]
        g1 = convert.gdb_from_arrays(A, [f"a{i}" for i in range(len(A))])
        g2 = convert.gdb_from_arrays(B, [f"b{i}" for i in range(len(B))])
        alens = inputs["alens"]["pair"]
        _same(tp.device_tubes(g1, g2, alens, device=card),
              tsharded.sharded_tubes(g1, g2, alens, mesh))
    finally:
        td.destroy_process_group()
