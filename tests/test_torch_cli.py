"""The port's command line (fastga_tpu_torch.cli: fastga, gixmake,
alntopaf) on the CPU, against the JAX package's command line and the C
goldens: PAF, PSL and .1aln output byte for byte, the flags that seed on
the host, the GIX files and the device GIX build, the `-k` artifacts, the
`python -m` entries, and the refusal to run without a card unless the
caller asks for the CPU.

The port runs its torch engine with ``device="cpu"`` (the kernels' plain
versions); the JAX CLI runs ``-Eref``, the exact host engine, except for
the .1aln, whose provenance line records the command: there both run the
same command, the JAX CLI on its default engine."""

import contextlib
import copy
import dataclasses
import io
import os
import pkgutil
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.cli import fastga as jcli
from fastga_tpu.io import ano as jano
from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io import gix as jgix
from fastga_tpu.io import onecode as jonecode
from fastga_tpu.io.gdb import MaskIval
from fastga_tpu.utils import dna
from fastga_tpu_torch.cli import alntopaf as talntopaf
from fastga_tpu_torch.cli import fastga as tcli
from fastga_tpu_torch.cli import fastks as tfastks
from fastga_tpu_torch.cli import gixmake as tgixmake
from fastga_tpu_torch.io import alncode as taln
from fastga_tpu_torch.io import gdb as tgdb
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.io import onecode as tonecode
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import device_pipeline as tdp
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.utils import prof
from tests.test_fastga_cli import _write_fa
from tests.test_gdb import write_fasta
from tests.test_wave_ref import diverged_pair

ROOT = Path(__file__).resolve().parent.parent
GOLD = Path(__file__).parent / "golden"
AL = "acgt"
GIX_FIELDS = ("kmer", "kbytes", "post", "cont", "comp", "lcp", "maskb",
              "prefix_index", "perm", "post_bytes", "cont_bytes", "freq",
              "seqtot")


@pytest.fixture(scope="module", autouse=True)
def stats_seen():
    """One torch thread, and a 16-lane wave engine under the port's CLI
    (the plain stepper's time on the CPU grows with the lanes; the records
    do not depend on them, tests/test_torch_aligner.py).  A call with the
    inputs of an earlier call (the same sequences, tables, parameters and
    options; e.g. the PAF, PSL and `-1:` runs of one pair) is aligned once
    and its records are reused.  Yields the stats of every port
    align_genomes call, newest last."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    real = tal.align_genomes
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    seen, memo = [], {}

    def genome(g):
        return tuple(g.get_contig(i).tobytes() for i in range(g.ncontig))

    def table(t):
        return None if t is None else (t.perm.tobytes(), t.maskb.tobytes(),
                                       t.kbytes.tobytes())

    def small_engine(gdb1, gdb2, t1=None, t2=None,
                     params=tal.FastGAParams(), **kw):
        key = (genome(gdb1), None if gdb2 is gdb1 else genome(gdb2),
               table(t1), None if t2 is t1 else table(t2),
               dataclasses.astuple(params),
               tuple(sorted((k, repr(v)) for k, v in kw.items())))
        if key not in memo:
            memo[key] = real(gdb1, gdb2, t1, t2, params, cfg=cfg, **kw)
        seen.append(memo[key][1])
        return copy.deepcopy(memo[key])

    mp = pytest.MonkeyPatch()
    mp.setattr(tal, "align_genomes", small_engine)
    yield seen
    mp.undo()
    torch.set_num_threads(n)


@pytest.fixture
def same_date(monkeypatch):
    """The provenance line's date, equal in both packages' writers."""
    fixed = types.SimpleNamespace(strftime=lambda fmt: "2026-01-01_00:00:00")
    monkeypatch.setattr(jonecode, "time", fixed)
    monkeypatch.setattr(tonecode, "time", fixed)


def _run(main, args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args, **kw) == 0
    return buf.getvalue()


def port(args):
    return _run(tcli.main, args, device="cpu")


def jax_ref(args):
    return _run(jcli.main, ["-Eref"] + args)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """2 x 24 kb per side, ~1.2% substitutions, a lower-case block in A
    (tests/test_fastga_cli.py's pair), and a .1ano of another interval."""
    d = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(61)
    A, B = [], []
    for i in range(2):
        a = rng.integers(0, 4, 24000).astype(np.uint8)
        b = a.copy()
        mut = rng.random(len(b)) < 0.012
        b[mut] = (b[mut] + rng.integers(1, 4, mut.sum())) % 4
        A.append((f"sA{i}", a))
        B.append((f"sB{i}", b))
    _write_fa(d / "A.fa", A, mask_ranges={0: [(2000, 9000)]})
    _write_fa(d / "B.fa", B)
    g, _ = jgdb.create_gdb(d / "A.fa")
    jano.write_ano(d / "Am.1ano", g, [MaskIval(1, 5000, 12000)])
    return d


def _fa(d):
    return str(d / "A.fa"), str(d / "B.fa")


@pytest.mark.parametrize("fmt", [[], ["-pafx"], ["-pafm"], ["-pafs"],
                                 ["-pafS"], ["-psl"]],
                         ids=["paf", "pafx", "pafm", "pafs", "pafS", "psl"])
def test_output_formats_match_jax_cli(pair, fmt, stats_seen):
    A, B = _fa(pair)
    got = port(fmt + [A, B])
    assert stats_seen[-1]["seed_pipeline"] == "device"
    want = jax_ref(fmt + [A, B])
    assert got.count("\n") >= 2
    assert got == want


def test_aln_file_matches_jax_cli(pair, same_date, monkeypatch):
    """`-1:` writes a binary .1aln byte-identical to the JAX CLI's for the
    same command (the date made equal); its records read back."""
    monkeypatch.chdir(pair)
    args = ["-1:out", "A.fa", "B.fa"]
    _run(jcli.main, args)
    want = Path("out.1aln").read_bytes()
    os.remove("out.1aln")
    _run(tcli.main, args, device="cpu")
    assert Path("out.1aln").read_bytes() == want
    af = taln.read_aln("out.1aln")
    assert len(af.skeletons) == 2 and len(af.overlaps) >= 2
    paf = _run(talntopaf.main, ["out.1aln"])
    assert paf == jax_ref(["A.fa", "B.fa"])


@pytest.mark.parametrize("case", ["M", "mask", "S", "T1", "self", "f20",
                                  "lics"])
def test_flags_match_jax_cli(pair, self_genome, case, stats_seen, capsys):
    """The flags that seed on the device (-M and #mask through the host
    tables uploaded, -S, -T1, -l/-i/-c/-s, one source) and -f past the
    device cap, which seeds on the host."""
    A, B = _fa(pair)
    args = {"M": ["-M", A, B], "mask": [A, f"#{pair}/Am.1ano", B],
            "S": ["-S", A, B], "T1": ["-T1", A, B],
            "self": [str(self_genome / "S.fasta")], "f20": ["-f20", A, B],
            "lics": ["-l200", "-i.8", "-c50", "-s500", A, B]}[case]
    got = port(args)
    seeds = stats_seen[-1]["seed_pipeline"]
    err = capsys.readouterr().err
    assert got == jax_ref(args)
    assert got.count("\n") >= 2
    assert seeds == ("host" if case == "f20" else "device")
    if case == "f20":
        assert "device seed pipeline declined (-f 20" in err
        assert stats_seen[-1]["seed_decline"].startswith("-f 20")


def _soft_masked(src, dst, lo, hi):
    """A copy of the FASTA file ``src`` in upper case but for bases
    [lo, hi) of its first record, in lower case."""
    out, rec, at = [], -1, 0
    for line in Path(src).read_text().splitlines():
        if line.startswith(">"):
            rec += 1
            out.append(line)
            continue
        row = line.upper()
        if rec == 0:
            row = "".join(b.lower() if lo <= at + i < hi else b
                          for i, b in enumerate(row))
            at += len(row)
        out.append(row)
    Path(dst).write_text("\n".join(out) + "\n")
    return str(dst)


@pytest.mark.parametrize("case", ["M", "self", "S"])
def test_masked_routes_build_tables_on_the_card(pair, self_genome, case,
                                                stats_seen, monkeypatch,
                                                tmp_path, capsys):
    """-M on a pair, on one soft-masked genome and with -S: the masked
    tables built on the card (``gix.card_tables`` one a table) give the
    bytes of the tables built on the host past a lowered single-shot cap
    (``gix.host_tables`` one a table, each decline on stderr)."""
    A, _ = _fa(pair)
    B = _soft_masked(pair / "B.fa", tmp_path / "Bm.fa", 3000, 4500)
    S = _soft_masked(self_genome / "S.fasta", tmp_path / "Sm.fa", 2500, 3500)
    args = {"M": ["-M", A, B], "self": ["-M", S],
            "S": ["-M", "-S", A, B]}[case]
    ntab = 1 if case == "self" else 2
    monkeypatch.setattr(prof, "ENABLED", True)
    out = {}
    try:
        for where in ("card", "host"):
            if where == "host":
                monkeypatch.setattr(tdp, "_MAX_DEV_BASES", 1000)
            prof.reset()
            out[where] = port(args)
            c = prof.counters()
            assert (c.get("gix.card_tables", 0),
                    c.get("gix.host_tables", 0)) == \
                {"card": (ntab, 0), "host": (0, ntab)}[where]
            err = capsys.readouterr().err
            assert err.count("device GIX build declined") == \
                (ntab if where == "host" else 0)
            assert stats_seen[-1]["seed_pipeline"] == "device"
    finally:
        prof.reset()
    assert out["card"] == out["host"]
    assert out["card"].count("\n") >= 2


@pytest.fixture(scope="module")
def self_genome(tmp_path_factory):
    """tests/test_self.py's S.fasta (seed 777), whose C-reference PAF is
    tests/golden/ref_self.paf."""
    tmp = tmp_path_factory.mktemp("torch_self")
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
    txt = "".join(AL[x] for x in g)
    (tmp / "S.fasta").write_text(
        ">s1\n" + "\n".join(txt[i:i + 70] for i in range(0, len(txt), 70))
        + "\n")
    return tmp


@pytest.mark.parametrize("route", ["fastga", "alntopaf"])
def test_self_matches_c_golden(self_genome, route):
    S = str(self_genome / "S.fasta")
    if route == "fastga":
        got = port(["-T1", S])
    else:
        out = self_genome / "self.1aln"
        port(["-T1", f"-1:{out}", S])
        got = _run(talntopaf.main, [str(out)])
        assert taln.read_aln(out).db2_name == ""
    assert got == (GOLD / "ref_self.paf").read_text()


def test_ef_matches_c_golden(tmp_path):
    """The E/F pair through `fastga -1:`: the records of the C reference
    (tests/test_e2e.py), each trace summing to its spans."""
    a, b = diverged_pair()
    write_fasta(tmp_path / "E.fasta", [("e1", dna.to_ascii(a, True).decode())])
    write_fasta(tmp_path / "F.fasta", [("f1", dna.to_ascii(b, True).decode())])
    port([f"-1:{tmp_path}/EvF", str(tmp_path / "E.fasta"),
          str(tmp_path / "F.fasta")])
    ovls = taln.read_aln(tmp_path / "EvF.1aln").overlaps
    assert [(o.aread, o.abpos, o.aepos, o.bread, o.bbpos, o.bepos, o.bcomp,
             o.diffs) for o in ovls] == [
        (0, 0, 10025, 0, 0, 10000, False, 504),
        (0, 10025, 20008, 0, 9988, 19988, True, 488),
        (0, 20008, 30000, 0, 20000, 29988, False, 491),
    ]
    for o in ovls:
        assert sum(b for _, b in o.trace) == o.bepos - o.bbpos
        assert sum(d for d, _ in o.trace) == o.diffs


def _gix_files(root):
    stub, parts = tgix.gix_paths(root)
    files = [stub] + sorted(parts.parent.glob(parts.name + "*"))
    return {f.name: f.read_bytes() for f in files}


def test_write_gix_bytes_match_jax(pair, tmp_path):
    """The port's host build and writer give the JAX package's .gix stub
    and part files; read_gix gives the table back."""
    A = pair / "A.fa"
    jt = jgix.build_gix(jgdb.create_gdb(A)[0])
    tt = tgix.build_gix(tgdb.create_gdb(A)[0])
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jgix.write_gix(jt, tmp_path / "j" / "A")
    tgix.write_gix(tt, tmp_path / "t" / "A")
    want = _gix_files(tmp_path / "j" / "A")
    assert len(want) == 9
    assert _gix_files(tmp_path / "t" / "A") == want
    back = tgix.read_gix(tmp_path / "t" / "A.gix")
    for f in GIX_FIELDS:
        if f != "seqtot":   # not in the file
            assert np.array_equal(np.asarray(getattr(back, f)),
                                  np.asarray(getattr(tt, f))), f


@pytest.mark.parametrize("lens", [(24000, 24000), (30001, 5003, 39, 41, 801),
                                  tuple(range(900, 1900, 100))])
def test_build_gix_device_matches_host(lens):
    """build_gix_device on the CPU (the plain kernels) equals the host
    build_gix field by field: contigs shorter than k, contig lengths not
    a multiple of 4, and more contigs than the 8 of the padding."""
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(sum(lens))
    g, _ = synth.to_gdb("g", [rng.integers(0, 4, n).astype(np.uint8)
                              for n in lens])
    host = tgix.build_gix(g)
    dev = tdp.build_gix_device(g, "cpu")
    assert host.n > 0
    for f in GIX_FIELDS:
        a, b = np.asarray(getattr(host, f)), np.asarray(getattr(dev, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_build_gix_device_past_the_jax_entry_cap(capsys):
    """A genome whose GIX entries pass its padded bases N, the JAX
    package's entry cap, past which it builds on the host (a poly-A
    contig gives two entries a base): the device build keeps every entry,
    prints nothing and equals build_gix field by field."""
    from fastga_tpu_torch.utils import synth
    rng = np.random.default_rng(5)
    g, _ = synth.to_gdb("g", [rng.integers(0, 4, n).astype(np.uint8)
                              for n in (9000, 7001)]
                        + [np.zeros(8575, np.uint8)])
    dev = tdp.build_gix_device(g, "cpu")
    assert capsys.readouterr().err == ""
    host = tgix.build_gix(g)
    N = tdp._pad_bucket(int(g.contig_lengths().sum()))
    assert N == 24576 and host.n > N
    for f in GIX_FIELDS:
        a, b = np.asarray(getattr(host, f)), np.asarray(getattr(dev, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_gixmake_and_gix_inputs(pair, tmp_path, capsys):
    """gixmake (device build) writes the host build's files, and `fastga
    A.gix B.gix` gives `fastga A.fa B.fa`'s PAF."""
    for n in ("A.fa", "B.fa"):
        shutil.copy(pair / n, tmp_path / n)
    for n in "AB":
        assert tgixmake.main([str(tmp_path / f"{n}.fa")], device="cpu") == 0
    g = tgdb.read_gdb(tmp_path / "A")
    (tmp_path / "h").mkdir()
    tgix.write_gix(tgix.build_gix(g), tmp_path / "h" / "A")
    assert _gix_files(tmp_path / "A") == _gix_files(tmp_path / "h" / "A")
    got = port([str(tmp_path / "A.gix"), str(tmp_path / "B.gix")])
    assert got == port(list(_fa(pair)))
    assert "declined" not in capsys.readouterr().err


def test_keep_artifacts_match_jax_cli(pair, tmp_path, same_date,
                                      monkeypatch):
    """`-k` persists .1gdb, .bps, .gix (+ parts) and the case-mask .1ano,
    byte-equal to the JAX CLI's."""
    for n in ("A.fa", "B.fa"):
        shutil.copy(pair / n, tmp_path / n)
    monkeypatch.chdir(tmp_path)

    def artifacts():
        out = {f.name: f.read_bytes() for f in sorted(tmp_path.iterdir())
               if not f.name.endswith(".fa")}
        for f in out:
            os.remove(tmp_path / f)
        return out

    want_paf = jax_ref(["-k", "A.fa", "B.fa"])
    want = artifacts()
    assert {"A.1gdb", ".A.bps", "A.gix", "A.1ano", "B.1gdb"} <= set(want)
    assert port(["-k", "A.fa", "B.fa"]) == want_paf
    assert artifacts() == want


def _python_m(tool, args=(), hide_cards=False):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if hide_cards:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "-m", f"fastga_tpu_torch.cli.{tool}", *args],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)


TOOLS = ["fastga", "gixmake", "alntopaf", "fatogdb", "gdbshow", "gdbstat",
         "gdbtofa", "gixshow", "gixrm", "gixcp", "gixmv", "gixxfer", "fastks",
         "anoshow", "anostat", "anotobed", "bedtoano", "alnshow", "alnplot",
         "alnchain", "alnreset", "alntopsl", "paftoaln", "paftopsl",
         "oneview"]


def test_entries_match_jax_cli():
    """The port has an entry for every `python -m fastga_tpu.cli.<tool>`,
    and TOOLS runs each of them."""
    import fastga_tpu.cli as jpkg
    import fastga_tpu_torch.cli as tpkg

    def entries(pkg):
        return sorted(m.name for m in pkgutil.iter_modules(pkg.__path__)
                      if not m.name.startswith("_"))

    assert entries(tpkg) == entries(jpkg) == sorted(TOOLS)


@pytest.mark.parametrize("tool", TOOLS)
def test_python_m_no_args(tool, _results={}):
    """Every entry, run as `python -m` with no arguments, exits 0 or 1
    with a usage line and no traceback (the subprocesses run at once in a
    thread pool, on the first case)."""
    if not _results:
        with ThreadPoolExecutor(max_workers=8) as ex:
            _results.update(zip(TOOLS, ex.map(_python_m, TOOLS)))
    p = _results[tool]
    assert p.returncode in (0, 1), (tool, p.returncode, p.stderr[-500:])
    assert "Usage:" in p.stderr
    assert "Traceback" not in p.stderr + p.stdout


def test_python_m_without_a_card_exits_1(pair):
    p = _python_m("fastga", _fa(pair), hide_cards=True)
    assert p.returncode == 1
    assert "no CUDA device" in p.stderr
    assert "Traceback" not in p.stderr and p.stdout == ""


@pytest.mark.parametrize("tool", ["fastga", "gixmake", "fastks"])
def test_main_needs_the_card_unless_cpu(pair, tool, tmp_path, monkeypatch,
                                        capsys):
    """device=None is the card: without one, main fails with
    resolve_device's message before any work, instead of running on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    shutil.copy(pair / "A.fa", tmp_path / "A.fa")
    args = [str(tmp_path / "A.fa")] + ([str(pair / "B.fa")]
                                       if tool != "gixmake" else [])
    main = {"fastga": tcli.main, "gixmake": tgixmake.main,
            "fastks": tfastks.main}[tool]
    with pytest.raises(SystemExit) as e:
        main(args)
    assert e.value.code == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert sorted(p.name for p in tmp_path.iterdir()) == ["A.fa"]
