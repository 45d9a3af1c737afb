"""The single-shot pair seed route through the port's command line, and its
span record: ``fastga A B`` on a small uniform pair takes ``device_tubes``
(no ``devpipe.panel`` span), counts ``devpipe.merge_rows`` once, as the
driver table's rows plus genome 2's table rows, runs ``devpipe.prep``
once inside ``devpipe.gix1`` and once inside ``devpipe.gix2``, and writes
the JAX command line's PAF byte for byte; with ``_MAX_DEV_BASES`` lowered
in both packages a genome of exactly the cap still takes the single-shot
route and one base more the paneled route, with the same PAF."""

import contextlib
import io

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.cli import fastga as jcli
from fastga_tpu.ops import device_pipeline as jdp
from fastga_tpu_torch.cli import fastga as tcli
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.utils import prof, synth

CFG = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
NCONTIG, CLEN = 4, 3000
BASES = NCONTIG * CLEN


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """synth.uniform_pair at 4 x 3 kb a side (the fourth B contig with its
    middle third inverted) as two FASTA files."""
    gen = synth.uniform_pair(np.random.default_rng(2121), NCONTIG, CLEN)
    assert sum(map(len, gen["A"])) == sum(map(len, gen["B"])) == BASES
    d = tmp_path_factory.mktemp("singleshot")
    A, B = str(d / "A.fa"), str(d / "B.fa")
    synth.write_fasta(A, gen["A"], "a")
    synth.write_fasta(B, gen["B"], "b")
    return A, B


def _run(main, args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args, **kw) == 0
    return buf.getvalue()


def _events(name):
    return [e for e in prof.events() if e[3] == name]


@pytest.mark.parametrize("cap,route", [
    (None, "device_tubes"),
    (BASES, "device_tubes"),
    (BASES - 1, "device_tubes_paneled")],
    ids=["default cap", "genome at the cap", "genome one base past"])
def test_fastga_paf_route_spans_and_merge_rows(fasta, monkeypatch, capsys,
                                               cap, route):
    """One ``fastga A B`` (PAF on stdout) on the port's CPU engine with the
    span record on: the route its size selects, the single-shot route's
    spans and counter, and the JAX command line's (``-Eref``) bytes under
    the same cap, with no decline printed."""
    A, B = fasta
    if cap is not None:
        monkeypatch.setattr(tp, "_MAX_DEV_BASES", cap)
        monkeypatch.setattr(jdp, "_MAX_DEV_BASES", cap)
    real = tal.align_genomes
    monkeypatch.setattr(tal, "align_genomes",
                        lambda *a, **k: real(*a, cfg=CFG, **k))
    taken, rows = [], []
    for name in ("device_tubes", "device_tubes_paneled"):
        fn = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                            taken.append(_n) or _f(*a, **k))
    for name in ("driver_table", "_full_table"):
        fn = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                            rows.append((_n, (t := _f(*a, **k))[0].shape[0]))
                            or t)
    prof.reset()
    monkeypatch.setattr(prof, "ENABLED", True)
    try:
        got = _run(tcli.main, [A, B], device="cpu")
        c = prof.counters()
        panels = len(_events("devpipe.panel"))
        preps = _events("devpipe.prep")
        by_id = {e[0]: e for e in prof.events()}
    finally:
        prof.reset()
    assert taken == [route]
    assert "declined" not in capsys.readouterr().err
    if route == "device_tubes":
        assert panels == 0
        assert [n for n, _ in rows] == ["driver_table", "_full_table"]
        assert c["devpipe.merge_rows"] == sum(r for _, r in rows)
        assert [by_id[e[1]][3] for e in preps] == ["devpipe.gix1",
                                                   "devpipe.gix2"]
    else:
        assert panels == 2 and rows == []
        assert "devpipe.merge_rows" not in c
        assert len(preps) == 1
        assert by_id[preps[0][1]][3] not in ("devpipe.gix1", "devpipe.gix2")
    # every contig pair aligned, the inverted middle third on its own
    assert got.count("\n") >= 6 and "\t-\t" in got
    assert got == _run(jcli.main, ["-Eref", A, B])
