"""FASTA to GDB: the port's native pass (native/fagdb.c), its numpy body
(taken when the library cannot be loaded) and the JAX package's
create_gdb, on inputs that reach every rule of the parse: line widths,
CR-LF and blank lines, headers with spaces, N runs leading, inside and
trailing at ncut 0 and 10, lower-case n in a kept run, IUPAC bytes,
contigs of 1-7 bases, all-lower-case input, masks at contig ends and of
one base, gzip, a soft-masked synthetic pair, and short files of random
bytes.  Scaffolds, contigs, base frequencies, packed bases, masks and the
written .1gdb and .bps (or the error raised) must be equal; the
tolerance is zero."""

import dataclasses
import gzip
import types

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.io import gdb as jgdb
from fastga_tpu.io import onecode as jonecode
from fastga_tpu_torch import native
from fastga_tpu_torch.io import gdb as tgdb
from fastga_tpu_torch.io import onecode as tonecode
from fastga_tpu_torch.utils import prof, synth


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_date(monkeypatch):
    """The provenance line's date, equal in both packages' writers."""
    fixed = types.SimpleNamespace(strftime=lambda fmt: "2026-01-01_00:00:00")
    monkeypatch.setattr(jonecode, "time", fixed)
    monkeypatch.setattr(tonecode, "time", fixed)


def _acgt(rng, n, alphabet=b"ACGT"):
    return bytes(np.frombuffer(alphabet, np.uint8)[rng.integers(0, 4, n)])


def _fasta(entries, width=60, eol=b"\n"):
    out = []
    for h, s in entries:
        out.append(b">" + h + eol)
        out += [s[i:i + width] + eol for i in range(0, len(s), width)]
    return b"".join(out)


def _runs_of_n(rng):
    """Leading, inner (shorter and longer than 10) and trailing N runs."""
    return _fasta([
        (b"lead", b"N" * 12 + _acgt(rng, 90) + b"n" * 3 + _acgt(rng, 40)),
        (b"short lead", b"NN" + _acgt(rng, 30) + b"N" * 10 + _acgt(rng, 9)),
        (b"inner", _acgt(rng, 70) + b"N" * 9 + _acgt(rng, 61) + b"N" * 25
         + _acgt(rng, 5) + b"N"),
        (b"trail", _acgt(rng, 33) + b"N" * 40),
    ], width=50)


def _lower_n(rng):
    """Lower-case n inside a short kept run between masked stretches."""
    return _fasta([(b"s1", _acgt(rng, 20) + _acgt(rng, 7, b"acgt") + b"nnn"
                    + _acgt(rng, 6, b"acgt") + b"nNn" + _acgt(rng, 30)
                    + b"n" * 14 + _acgt(rng, 8, b"acgt"))])


def _iupac(rng):
    seq = bytearray(_acgt(rng, 400))
    for i, b in zip(rng.integers(0, 400, 40), b"RYKMSWBDHVNrykmswbdhvn -*.>"
                    * 2):
        seq[i] = b
    return _fasta([(b"iupac", bytes(seq)), (b"two", _acgt(rng, 50))], 70)


def _short_contigs(rng):
    seq = b"N".join(_acgt(rng, n) for n in (1, 2, 3, 4, 5, 6, 7, 1))
    return _fasta([(b"tiny", seq), (b"one", b"a"), (b"seven", b"ACGTacg")])


def _mask_edges(rng):
    """Masks at a contig's first and last base, of one base, across a
    line break and around an N run."""
    return _fasta([
        (b"m1", b"a" + _acgt(rng, 10) + b"c" + _acgt(rng, 5) + b"gt"),
        (b"m2", _acgt(rng, 9, b"acgt") + b"NN" + _acgt(rng, 4)
         + _acgt(rng, 3, b"acgt") + b"N" + b"t" + b"A"),
        (b"m3", _acgt(rng, 61, b"acgt") + _acgt(rng, 60) + b"g"),
    ], width=60)


def _crlf(rng):
    """CR-LF ends, blank lines, a lone CR inside a line, no last EOL."""
    body = _fasta([(b"chr1  with spaces\t", _acgt(rng, 333)),
                   (b"chr2", _acgt(rng, 81, b"aCgT"))], width=80,
                  eol=b"\r\n")
    body = body.replace(b"\r\n>chr2", b"\r\n\r\n\n>chr2")
    return body[:100] + b"\r" + body[100:] + _acgt(rng, 17)


def _random_bytes(rng, d):
    """Short files of bytes drawn with random weights from bases of both
    cases, N, n, IUPAC, spaces, CR, LF and '>'."""
    alpha = np.frombuffer(b"acgtACGTNnRy \r\n>", np.uint8)
    paths = []
    for k in range(40):
        w = rng.dirichlet(np.full(len(alpha), 0.5))
        body = alpha[rng.choice(len(alpha), int(rng.integers(1, 300)), p=w)]
        paths.append(d / f"r{k}.fa")
        paths[-1].write_bytes(b">" + bytes(body))
    return paths


def _write(case, rng, d):
    """The case's FASTA files under ``d`` and its ncut."""
    if case == "random_bytes":
        return _random_bytes(rng, d), 3
    if case == "synth_pair":
        gen, masks = synth.repeat_rich_pair(rng, 200_000, ncontig=4,
                                            copies_per_subfam=4)
        for k in ("A", "B"):
            synth.write_fasta(str(d / f"{k}.fa"), gen[k], k, masks[k])
        return [d / "A.fa", d / "B.fa"], 0
    ncut = 0
    if case == "cols60":
        data = _fasta([(b"chr1 A. thaliana 1", _acgt(rng, 1000)),
                       (b"chr2", _acgt(rng, 599, b"acgt") + _acgt(rng, 3))])
    elif case == "cols80":
        data = _fasta([(b"x", _acgt(rng, 1601)), (b"y", _acgt(rng, 80))], 80)
    elif case == "crlf_blank":
        data = _crlf(rng)
    elif case in ("nruns_ncut0", "nruns_ncut10"):
        data, ncut = _runs_of_n(rng), int(case[len("nruns_ncut"):])
    elif case == "lower_n_kept":
        data, ncut = _lower_n(rng), 10
    elif case in ("iupac", "iupac_ncut5"):
        data, ncut = _iupac(rng), (5 if case == "iupac_ncut5" else 0)
    elif case == "contigs_1_7":
        data = _short_contigs(rng)
    elif case == "all_lower":
        data = _fasta([(b"l1", _acgt(rng, 300, b"acgt") + b"NNN"
                        + _acgt(rng, 20, b"acgt"))])
    elif case == "mask_edges":
        data = _mask_edges(rng)
    elif case == "gzip":
        data = _fasta([(b"z1", _acgt(rng, 2000, b"ACgt")),
                       (b"z2", b"N" * 5 + _acgt(rng, 77))])
        fa = d / "g.fa.gz"
        with gzip.open(fa, "wb") as f:
            f.write(data)
        return [fa], 0
    else:
        raise KeyError(case)
    fa = d / "g.fa"
    fa.write_bytes(data)
    return [fa], ncut


CASES = ["cols60", "cols80", "crlf_blank", "nruns_ncut0", "nruns_ncut10",
         "lower_n_kept", "iupac", "iupac_ncut5", "contigs_1_7", "all_lower",
         "mask_edges", "gzip", "synth_pair", "random_bytes"]


def _outcome(path, mod, target, ncut, monkeypatch, fallback):
    """The parse's state and written files, or the error it raised."""
    try:
        g, masks = _create(path, mod, target, ncut, monkeypatch, fallback)
    except ValueError as e:
        return ("ValueError", str(e))
    skel, bps = tgdb.GDB.paths(target)
    return _state(g, masks) + (skel.read_bytes(), bps.read_bytes())


def _create(path, mod, target, ncut, monkeypatch, fallback=False):
    with monkeypatch.context() as m:
        if fallback:
            m.setattr(native, "get_fagdb", lambda: None)
        return mod.create_gdb(path, target, ncut=ncut)


def _state(g, masks):
    return ([dataclasses.astuple(s) for s in g.scaffolds],
            [dataclasses.astuple(c) for c in g.contigs],
            g.freq.tolist(), g.seqtot, g.maxctg, g._bps.tobytes(),
            [dataclasses.astuple(m) for m in masks])


@pytest.mark.parametrize("case", CASES)
def test_native_parse_matches(case, tmp_path, monkeypatch, same_date):
    assert native.get_fagdb() is not None
    paths, ncut = _write(case, np.random.default_rng(CASES.index(case)),
                         tmp_path)
    for i, fa in enumerate(paths):
        got = {}
        for side, mod, fb in (("c", tgdb, False), ("numpy", tgdb, True),
                              ("jax", jgdb, False)):
            got[side] = _outcome(fa, mod, tmp_path / f"{side}{i}", ncut,
                                 monkeypatch, fb)
        assert got["c"] == got["jax"]
        assert got["numpy"] == got["jax"]
    if case == "all_lower":
        assert got["c"][6] == []
    if case == "nruns_ncut0":
        assert got["c"][1][0] == (0, 0, 0, 0)  # the leading gap's contig
    if case == "synth_pair":
        assert len(got["c"][6]) > 10


@pytest.mark.parametrize("data,message", [
    (b"acgt\n>s1\nacgt\n", "first FASTA header missing"),
    (b">s1\nacgt\n>s2 gap only \r\nNNnn\n>s3\nacgt\n",
     "scaffold 's2 gap only' has no sequence"),
    (b">s1\nacgt\n>last", "scaffold 'last' has no sequence"),
])
def test_parse_errors_match(data, message, tmp_path, monkeypatch):
    fa = tmp_path / "bad.fa"
    fa.write_bytes(data)
    for mod, fb in ((tgdb, False), (tgdb, True), (jgdb, False)):
        with pytest.raises(ValueError) as e:
            _create(fa, mod, None, 0, monkeypatch, fb)
        assert str(e.value) == f"{fa}: {message}"


def test_native_parses_counted(tmp_path, monkeypatch):
    monkeypatch.setattr(prof, "ENABLED", True)
    prof.reset()
    fa = tmp_path / "g.fa"
    fa.write_bytes(_fasta([(b"s", b"ACGT" * 10)]))
    tgdb.create_gdb(fa)
    tgdb.create_gdb(fa, ncut=3)
    assert prof.counters().get("gdb.native_parses") == 2
    prof.reset()
    _create(fa, tgdb, None, 0, monkeypatch, fallback=True)
    assert prof.counters().get("gdb.native_parses", 0) == 0
    prof.reset()
