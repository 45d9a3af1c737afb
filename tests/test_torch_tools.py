"""The port's genome, index and annotation tools (fastga_tpu_torch.cli:
fatogdb, gdbtofa, gdbshow, gdbstat, gixshow, gixrm, gixcp, gixmv, fastks,
anoshow, anostat, anotobed, bedtoano) against the C goldens under
tests/golden/gdbtools and tests/golden/ano and against the JAX package's
tools, byte for byte, on the inputs of tests/test_gdbtools.py,
tests/test_anotools.py and tests/test_fastks.py; the KmerStream and
old-format GIX cases of tests/test_gix.py against the JAX io.gix.  fastks
runs with ``device="cpu"`` (its index from the device GIX build's plain
version).  Every output is text or integers; the tolerance is zero."""

import contextlib
import gzip
import io
import shutil
import types

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.cli import (anoshow as janoshow, anostat as janostat,
                            anotobed as janotobed, bedtoano as jbedtoano,
                            fastks as jfastks, fatogdb as jfatogdb,
                            gdbshow as jgdbshow, gdbstat as jgdbstat,
                            gdbtofa as jgdbtofa, gixshow as jgixshow)
from fastga_tpu.io import ano as jano
from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io import gix as jgix
from fastga_tpu.io import onecode as jonecode
from fastga_tpu.ops import merge as jmerge
from fastga_tpu.utils import select as jsel
from fastga_tpu_torch.cli import (anoshow, anostat, anotobed, bedtoano,
                                  fastks, fatogdb, gdbshow, gdbstat, gdbtofa,
                                  gixcp, gixmv, gixrm, gixshow)
from fastga_tpu_torch.io import ano as tano
from fastga_tpu_torch.io import gdb as tgdb
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.io import onecode as tonecode
from fastga_tpu_torch.ops import merge as tmerge
from fastga_tpu_torch.utils import dna
from fastga_tpu_torch.utils import select as tsel
from tests.test_anotools import GOLD as ANO_GOLD
from tests.test_gdb import write_fasta
from tests.test_gdbtools import GOLD, SHOW_CASES, _make_fasta
from tests.test_fastks import _gdb as _jgdb_of


@pytest.fixture(scope="module", autouse=True)
def _one_thread_same_date():
    """One torch thread; the provenance line's date equal in both
    packages' writers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    fixed = types.SimpleNamespace(strftime=lambda fmt: "2026-01-01_00:00:00")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jonecode, "time", fixed)
        mp.setattr(tonecode, "time", fixed)
        yield
    torch.set_num_threads(n)


def run(main, args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args, **kw)
    assert rc == 0
    return buf.getvalue()


def both(jmain, tmain, args):
    """The JAX tool's and the port tool's stdout on the same arguments,
    which must be equal."""
    want = run(jmain, args)
    got = run(tmain, args)
    assert got == want
    return got


def files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())
            if p.is_file()}


def same_files(d, jrun, trun):
    """The files the JAX tool (``jrun()``) and then the port's
    (``trun()``) leave in ``d``, at the same paths (a file names the
    files it refers to); the port's stay.  Returns the stderr of both."""
    keep = files(d)
    err = []
    for fn in (jrun, trun):
        for p in d.iterdir():
            if p.name not in keep:
                p.unlink()
        with contextlib.redirect_stderr(io.StringIO()) as e:
            assert fn() == 0
        err.append(e.getvalue())
        out = files(d)
        if fn is jrun:
            want = out
    assert out == want
    assert err[0] == err[1]
    return err[1]


@pytest.fixture(scope="module")
def pg(tmp_path_factory):
    """tests/test_gdbtools.py's genome (gaps, soft-mask blocks, three
    scaffolds) through fatogdb: the port's writes the JAX one's bytes.
    Returns the GDB's root."""
    tmp = tmp_path_factory.mktemp("tools")
    _make_fasta(tmp / "G.fasta")
    args = [str(tmp / "G.fasta"), str(tmp / "PG")]
    same_files(tmp, lambda: jfatogdb.main(args), lambda: fatogdb.main(args))
    assert {"PG.1gdb", ".PG.bps", "PG.1ano", "G.fasta"} == set(files(tmp))
    return tmp / "PG"


def test_fatogdb_verbose_and_log(pg, tmp_path):
    """-v, -L and -n: the JAX tool's stderr line, log and files."""
    shutil.copy(pg.parent / "G.fasta", tmp_path / "G.fasta")
    args = ["-v", f"-L:{tmp_path / 'log'}", "-n50", str(tmp_path / "G.fasta"),
            str(tmp_path / "X")]
    err = same_files(tmp_path, lambda: jfatogdb.main(args),
                     lambda: fatogdb.main(args))
    assert "3 scaffolds" in err


@pytest.mark.parametrize("golden,flags,sel", SHOW_CASES)
def test_gdbshow_matches_reference(pg, golden, flags, sel):
    got = both(jgdbshow.main, gdbshow.main, flags + [str(pg)] + sel)
    assert got == (GOLD / golden).read_text()


def test_gdbshow_masked(pg):
    got = both(jgdbshow.main, gdbshow.main, ["#", str(pg), "@1"])
    assert got == (GOLD / "show_masked.txt").read_text()


@pytest.mark.parametrize("golden,flags", [
    ("stat.txt", []),
    ("stat_h.txt", ["-h"]),
    ("stat_hlog.txt", ["-hlog"]),
    ("stat_hbuck.txt", ["-h500,2000"]),
])
def test_gdbstat_matches_reference(pg, golden, flags):
    got = both(jgdbstat.main, gdbstat.main, flags + [str(pg)])
    assert got == (GOLD / golden).read_text()


@pytest.mark.parametrize("golden,mask", [("tofa.txt", False),
                                         ("tofa_masked.txt", True)])
def test_gdbtofa_matches_reference(pg, golden, mask):
    args = ([f"#{pg}.1ano"] if mask else []) + [str(pg)]
    got = both(jgdbtofa.main, gdbtofa.main, args)
    assert got == (GOLD / golden).read_text()


def test_gdbtofa_masked_roundtrip(pg, tmp_path):
    """Masked gdbtofa gives back the FASTA's sequence and case, scaffold
    for scaffold (modulo line wrapping), also into a file with -w."""
    out = tmp_path / "back.fa"
    assert gdbtofa.main(["-w60", f"#{pg}.1ano", str(pg), str(out)]) == 0

    def seqs(t):
        out, cur = {}, None
        for line in t.splitlines():
            if line.startswith(">"):
                cur = line[1:]
                out[cur] = []
            else:
                out[cur].append(line)
        return {k: "".join(v) for k, v in out.items()}

    text = out.read_text()
    assert max(len(ln) for ln in text.splitlines()) == 60
    assert seqs(text) == seqs((pg.parent / "G.fasta").read_text())


def test_gdb_to_fasta_matches_jax(pg, tmp_path):
    """io.gdb.gdb_to_fasta, with and without masks, gzipped: the JAX
    function's bytes."""
    for mask in (False, True):
        outs = []
        for m, am in ((jgdb, jano), (tgdb, tano)):
            g = m.read_gdb(pg)
            masks = am.read_ano(f"{pg}.1ano", g) if mask else None
            p = tmp_path / f"{m.__name__.split('.')[0]}{mask}.fa.gz"
            m.gdb_to_fasta(g, p, width=70, masks=masks)
            outs.append(gzip.open(p).read())
        assert outs[0] == outs[1] and outs[0].startswith(b">scaf1")


@pytest.mark.parametrize("bad", ["@0", "@9", ".99", "@1:999M", "@nosuch",
                                 "@1:5-bogus"])
def test_selection_errors(pg, bad):
    gdb = tgdb.read_gdb(pg)
    names = tsel.scaffold_names(gdb)
    with pytest.raises(tsel.SelectError) as e:
        tsel.interpret_range(bad, gdb, names)
    jg = jgdb.read_gdb(pg)
    with pytest.raises(jsel.SelectError) as je:
        jsel.interpret_range(bad, jg, jsel.scaffold_names(jg))
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("sel", ["@1.2:100-@1.3:50", "@1-@2,.4", ".2-",
                                 "5k-12k", "@#", ".#:50-#"])
def test_selection_contigs(pg, sel):
    gdb = tgdb.read_gdb(pg)
    got = tsel.get_selection_contigs(sel, gdb)
    want = jsel.get_selection_contigs(sel, jgdb.read_gdb(pg))
    assert [vars(c) for c in got] == [vars(c) for c in want]
    if sel == "@1.2:100-@1.3:50":
        assert [c.order for c in got] == [0, 1, 1, 0, 0]
        assert got[1].beg == 100 and got[1].end == gdb.contigs[1].clen
        assert got[2].beg == 0 and got[2].end == 50


# -- annotations (tests/test_anotools.py) -----------------------------------

def _rich_records(m):
    """tests/test_anotools.py's annotation set, in module ``m``'s
    records."""
    R = m.AnoRecord
    by_ctg = [[] for _ in range(5)]
    by_ctg[0] = [R(0, 100, 900, 0, "alpha", 7, [100, 300, 900]),
                 R(0, 1500, 2500, 1, "beta", 0, None),
                 R(0, 2300, 4000, 0, None, 3, None)]
    by_ctg[1] = [R(1, 0, 1200, 0, "gamma", 0, None)]
    by_ctg[3] = [R(3, 4000, 6500, 0, None, 0, [4000, 5000, 6500])]
    return by_ctg


@pytest.fixture(scope="module")
def rich(pg):
    """RICH.1ano beside the genome: the port's write_ano_records writes
    the JAX one's bytes."""

    def write(gm, am):
        g = gm.read_gdb(pg)
        assert g.ncontig == 5
        am.write_ano_records(pg.parent / "RICH.1ano", g, _rich_records(am),
                             command="make rich")
        return 0
    same_files(pg.parent, lambda: write(jgdb, jano),
               lambda: write(tgdb, tano))
    return pg.parent / "RICH.1ano"


@pytest.mark.parametrize("sel,golden", [
    ([], "show_all.txt"),
    (["@1"], "show__1.txt"),
    (["@1-"], "show__1_.txt"),
    ([".1:200-600"], "show__1_200_600.txt"),
    (["@2"], "show__2.txt"),
])
def test_anoshow_matches_reference(rich, sel, golden):
    got = both(janoshow.main, anoshow.main, [str(rich)] + sel)
    assert got == (ANO_GOLD / golden).read_text()


@pytest.mark.parametrize("flags,golden", [
    ([], "stat.txt"),
    (["-h"], "stat_h.txt"),
    (["-hlog"], "stat_hlog.txt"),
    (["-h100,500"], "stat_hb.txt"),
])
def test_anostat_matches_reference(rich, flags, golden):
    got = both(janostat.main, anostat.main, flags + [str(rich)])
    assert got == (ANO_GOLD / golden).read_text()


@pytest.mark.parametrize("to_file", [False, True])
def test_anotobed_matches_reference(rich, tmp_path, monkeypatch, to_file):
    """anotobed to stdout, or into a file (its provenance block still on
    stdout): the JAX tool's bytes on the same arguments (the time stamp
    of its own provenance line patched equal), the C golden's records."""
    monkeypatch.setattr("time.strftime", lambda *a: "2026-01-01_00:00:00")
    args = [str(rich)] + ([str(tmp_path / "x.bed")] if to_file else [])
    outs = []
    for main in (janotobed.main, anotobed.main):
        out = run(main, args)
        if to_file:
            assert out.startswith("# Provenance:")
            out += (tmp_path / "x.bed").read_text()
            (tmp_path / "x.bed").unlink()
        outs.append(out)
    assert outs[0] == outs[1]
    body = [ln for ln in outs[1].splitlines() if not ln.startswith("#")]
    assert body == (ANO_GOLD / "tobed.txt").read_text().splitlines()


def test_bedtoano_roundtrip(pg, tmp_path):
    """BED -> .1ano -> records: the JAX tool's file and tests/
    test_anotools.py's intervals; then anotobed gives the BED back."""
    (tmp_path / "S3.bed").write_text("scaf3\t50\t220\tlabl\t9\t+\n"
                                      "scaf2\t100\t6400\t\t0\t-\n")
    args = [str(tmp_path / "S3.bed"), str(pg)]
    same_files(tmp_path, lambda: jbedtoano.main(args),
               lambda: bedtoano.main(args))
    gdb, by_ctg, _ = tano.read_ano_records(tmp_path / "S3.1ano")
    flat = [(m.contig, m.beg, m.end, m.orient, m.label, m.score)
            for recs in by_ctg for m in recs]
    assert flat == [(3, 100, 6400, 1, None, 0),
                    (4, 50, 220, 0, "labl", 9)]
    back = both(janotobed.main, anotobed.main, [str(tmp_path / "S3.1ano")])
    assert [ln for ln in back.splitlines() if not ln.startswith("#")] == [
        "scaf2\t100\t6400\t\t0\t+", "scaf3\t50\t220\tlabl\t9\t+"]


# -- GIX files and tools ----------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tests/test_gix.py's genome (5 kb and 9 kb, upper case), one port
    GDB, its host table and the same genome's JAX table."""
    tmp = tmp_path_factory.mktemp("gix")
    rng = np.random.default_rng(0)
    seqs = [dna.to_ascii(rng.integers(0, 4, n).astype(np.uint8),
                         upper=True).decode() for n in (5000, 9000)]
    write_fasta(tmp / "g.fasta", [("c1", seqs[0]), ("c2", seqs[1])])
    g, _ = tgdb.create_gdb(tmp / "g.fasta", tmp / "g")
    jg, _ = jgdb.create_gdb(tmp / "g.fasta", None)
    return types.SimpleNamespace(tmp=tmp, g=g, t=tgix.build_gix(g),
                                 jt=jgix.build_gix(jg))


def _same_table(a, b):
    for f in ("kbytes", "post", "cont", "comp", "prefix_index", "perm"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              np.asarray(getattr(b, f))), f
    assert np.array_equal(np.minimum(a.lcp, 40), np.minimum(b.lcp, 40))


def test_old_format_roundtrip(small, tmp_path):
    """write_gix_old writes the JAX function's files; read_gix reads the
    pre-v1.3 stub back as the JAX read_gix does (the 255 cutoff, no mask
    bytes); remove_gix removes the .post and .ktab parts."""
    tgix.write_gix_old(small.t, tmp_path / "old")
    (tmp_path / "j").mkdir()
    jgix.write_gix_old(small.jt, tmp_path / "j" / "old")
    assert files(tmp_path) == files(tmp_path / "j")
    assert (tmp_path / ".old.post.1").exists()
    t2 = tgix.read_gix(tmp_path / "old")
    j2 = jgix.read_gix(tmp_path / "j" / "old")
    assert t2.freq == j2.freq == 255 and t2.kmer == small.t.kmer
    _same_table(small.t, t2)
    _same_table(j2, t2)
    assert (t2.maskb == 0).all()
    tgix.remove_gix(tmp_path / "old")
    assert not (tmp_path / ".old.post.1").exists()
    assert not (tmp_path / ".old.ktab.1").exists()
    assert not (tmp_path / "old.gix").exists()


def test_kmer_stream(small):
    """KmerStream reproduces read_gix column for column through a tiny
    read buffer, with goto_kmer equal to searchsorted, clones and
    batched entries(); an old-format index is refused."""
    t, tmp = small.t, small.tmp
    tgix.write_gix(t, tmp / "s", nthreads=4)   # several part files
    s = tgix.KmerStream(tmp / "s", bufents=64)
    assert (s.nels, s.kmer) == (t.n, t.kmer)
    assert np.array_equal(np.asarray(s.perm), np.asarray(t.perm))
    s.first()
    i = 0
    while not s.eof:
        assert np.array_equal(s.kmer_codes(), t.kmer_codes(i)), i
        assert (s.post, s.cont, s.comp, s.lcp, s.maskb) == (
            int(t.post[i]), int(t.cont[i]), bool(t.comp[i]), int(t.lcp[i]),
            int(t.maskb[i]))
        i += 1
        s.next()
    assert i == t.n
    rng = np.random.default_rng(11)
    for i in rng.integers(0, t.n, 16):
        s.goto_index(int(i))
        assert np.array_equal(s.kmer_codes(), t.kmer_codes(int(i)))
        c = s.clone()
        assert c.idx == s.idx and c.post == s.post
        c.close()
    js = jgix.KmerStream(tmp / "s", bufents=64)
    for i in rng.integers(0, t.n, 8):
        codes = t.kmer_codes(int(i))
        assert s.goto_kmer(codes) == t.searchsorted(codes) \
            == js.goto_kmer(codes)
    for _ in range(8):
        codes = rng.integers(0, 4, t.kmer).astype(np.uint8)
        assert s.goto_kmer(codes) == t.searchsorted(codes) \
            == js.goto_kmer(codes)
    js.close()
    got = 0
    for (i0, suf, maskb, lcp, post, cont, comp) in s.entries(chunk=100):
        n = len(post)
        assert i0 == got
        assert np.array_equal(post, t.post[i0:i0 + n].astype(np.int64))
        assert np.array_equal(cont, t.cont[i0:i0 + n])
        assert np.array_equal(comp, t.comp[i0:i0 + n])
        assert np.array_equal(lcp, t.lcp[i0:i0 + n])
        assert np.array_equal(suf, t.kbytes[i0:i0 + n, 3:])
        got += n
    assert got == t.n
    s.close()
    tgix.write_gix_old(t, tmp / "o")
    with pytest.raises(ValueError):
        tgix.KmerStream(tmp / "o")


@pytest.mark.parametrize("addr", [["0-3"], ["acg"], ["17"], ["ac-ag"],
                                  ["100-120"]])
def test_gixshow_addresses(pg, tmp_path, addr):
    """gixshow at entry and DNA-prefix addresses prints the JAX tool's
    lines, and each k-mer it prints starts with the prefix asked for."""
    t = tgix.build_gix(tgdb.read_gdb(pg), nthreads=1)
    tgix.write_gix(t, tmp_path / "SHOWIX", nthreads=1)
    out = both(jgixshow.main, gixshow.main, [str(tmp_path / "SHOWIX")]
               + addr)
    lines = out.splitlines()
    assert lines[0].startswith("  Index: K-mer")
    if addr == ["0-3"]:
        assert len(lines) == 5   # header + entries 0..3 (GIXshow.c)
    if addr == ["acg"]:
        assert lines[1:] and all(ln.split(": ")[1].startswith("acg")
                                 for ln in lines[1:])


def test_gix_ensemble_ops(pg, tmp_path):
    """gixcp, gixmv and gixrm leave byte-equal files where each should
    be, and none behind (-f, and -g for the GDB too)."""
    shutil.copytree(pg.parent, tmp_path / "w")
    root = tmp_path / "w" / "PG"
    t = tgix.build_gix(tgdb.read_gdb(root), nthreads=1)
    tgix.write_gix(t, tmp_path / "w" / "PGIX", nthreads=1)
    before = files(tmp_path / "w")
    gixset = {k for k in before if "PGIX" in k}
    assert gixcp.main([str(tmp_path / "w" / "PGIX"),
                       str(tmp_path / "w" / "C1")]) == 0
    now = files(tmp_path / "w")
    for k in gixset:
        assert now[k.replace("PGIX", "C1")] == before[k]
    assert gixmv.main([str(tmp_path / "w" / "C1"),
                       str(tmp_path / "w" / "C2")]) == 0
    moved = files(tmp_path / "w")
    assert not [k for k in moved if "C1" in k]
    for k in gixset:
        assert moved[k.replace("PGIX", "C2")] == before[k]
    assert tgix.read_gix(tmp_path / "w" / "C2").n == t.n
    assert gixrm.main(["-f", str(tmp_path / "w" / "C2")]) == 0
    assert files(tmp_path / "w") == before
    assert gixcp.main([str(root), str(tmp_path / "w" / "G2")]) == 0
    assert gixrm.main(["-fg", str(tmp_path / "w" / "G2")]) == 0
    assert files(tmp_path / "w") == before


# -- fastks (tests/test_fastks.py) ------------------------------------------

def _pair_tables(seed, n, rate):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 4, n).astype(np.uint8)
    b = a.copy()
    mut = rng.random(len(b)) < rate
    b[mut] = (b[mut] + rng.integers(1, 4, mut.sum())) % 4
    jt = [jgix.build_gix(_jgdb_of([x])) for x in (a, b)]
    return a, b, jt


@pytest.mark.parametrize("case", ["self", "pair"])
def test_adaptamer_kstats_matches_jax(case):
    """The port's adaptamer_kstats on the JAX package's tables: the JAX
    histograms and length bytes (a random 20 kb against itself: every
    entry unique at full length; an 8%-mutated 4 kb pair)."""
    if case == "self":
        _, _, (t1, _) = _pair_tables(3, 20000, 0.0)
        t2 = t1
    else:
        _, _, (t1, t2) = _pair_tables(4, 4000, 0.08)
    want = jmerge.adaptamer_kstats(t1, t2, want_bytes=True)
    got = tmerge.adaptamer_kstats(t1, t2, want_bytes=True)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1],
                                                              got[1])
    assert bytes(want[2]) == bytes(got[2])
    histu, histl, pb = got
    k = t1.kmer
    if case == "self":
        assert histl[k] == histu[k] == t1.n and histl[:k].sum() == 0
        assert len(pb) == t1.n and set(pb) == {k}
    else:
        assert 0 < histl[k] < t1.n and histl.sum() == len(pb)


@pytest.fixture(scope="module")
def ks_pair(tmp_path_factory):
    """A 12 kb genome and a 5%-mutated copy as FASTA (two contigs each),
    and each as .gix files from the host build_gix."""
    tmp = tmp_path_factory.mktemp("fastks")
    rng = np.random.default_rng(21)
    for name, rate in (("A", 0.0), ("B", 0.05)):
        if name == "A":
            a = [rng.integers(0, 4, n).astype(np.uint8) for n in (7000, 5000)]
            cs = a
        else:
            cs = []
            for c in a:
                c = c.copy()
                mut = rng.random(len(c)) < rate
                c[mut] = (c[mut] + rng.integers(1, 4, mut.sum())) % 4
                cs.append(c)
        write_fasta(tmp / f"{name}.fa",
                    [(f"{name}{i}", dna.to_ascii(c, upper=True).decode())
                     for i, c in enumerate(cs)])
        (tmp / "h").mkdir(exist_ok=True)
        shutil.copy(tmp / f"{name}.fa", tmp / "h" / f"{name}.fa")
        g, _ = tgdb.create_gdb(tmp / "h" / f"{name}.fa", tmp / "h" / name)
        tgix.write_gix(tgix.build_gix(g), tmp / "h" / name)
    return tmp


def test_fastks_matches_jax(ks_pair, tmp_path):
    """fastks A B on the FASTAs (the index from the device GIX build, on
    the CPU) prints the JAX tool's histogram and writes its -b bytes;
    on .gix files from the host build it prints the same histogram."""
    a, b = (str(ks_pair / f"{n}.fa") for n in "AB")
    want = run(jfastks.main, [f"-b:{tmp_path / 'j.bin'}", a, b])
    got = run(fastks.main, [f"-b:{tmp_path / 't.bin'}", a, b],
              device="cpu")
    assert got == want
    assert (tmp_path / "t.bin").read_bytes() == \
        (tmp_path / "j.bin").read_bytes()
    assert got.splitlines()[0] == "   K:  unique-mers   adapt-mers"
    assert len(got.splitlines()) == 41
    gixs = [str(ks_pair / "h" / f"{n}.gix") for n in "AB"]
    assert run(fastks.main, gixs, device="cpu") == got
    assert sorted(p.name for p in ks_pair.iterdir()) == ["A.fa", "B.fa",
                                                         "h"]
