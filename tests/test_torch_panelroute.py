"""The kmer-panel seed route through the port's command line, and its spans
and counters on the port's span record: ``fastga A B`` forced onto the
paneled route (``_MAX_DEV_BASES`` below the pair) writes the PAF of the
single-shot route and of the JAX package's command line byte for byte;
the panel plane runs once under ``devpipe.panel_plane`` and each panel
runs one span ``devpipe.panel`` holding one ``devpipe.panel_scan`` and one
``devpipe.panel_merge``; and the paneled routes return the single-shot
routes' seeds and tubes."""

import contextlib
import dataclasses
import io

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from fastga_tpu.cli import fastga as jcli
from fastga_tpu_torch.cli import fastga as tcli
from fastga_tpu_torch.io import gix as tgix
from fastga_tpu_torch.models import aligner as tal
from fastga_tpu_torch.ops import device_pipeline as tp
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.utils import prof, synth
from tests.test_torch_seedpipe import _alens

CPU = torch.device("cpu")
CFG = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def up():
    """synth.uniform_pair at 4 x 3 kb a side (the fourth B contig with its
    middle third inverted): the contigs and both genomes' GDBs."""
    gen = synth.uniform_pair(np.random.default_rng(1717), 4, 3000)
    g1 = synth.to_gdb("a", gen["A"])[0]
    g2 = synth.to_gdb("b", gen["B"])[0]
    return gen, g1, g2, _alens(g1.contig_lengths())


@pytest.fixture
def on(monkeypatch):
    """The span record on and empty; left off and empty after."""
    prof.reset()
    monkeypatch.setattr(prof, "ENABLED", True)
    yield
    prof.reset()


def _names(name):
    return [e for e in prof.events() if e[3] == name]


def _calls(name):
    """The calls of span ``name`` in the record (0 where none ran)."""
    return prof.report().get(name, (0.0, 0))[1]


def _run(main, args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(args, **kw) == 0
    return buf.getvalue()


def test_fastga_paf_through_panels_matches_single_shot_and_jax(
        up, tmp_path, monkeypatch, capsys, on):
    """``fastga A B`` (PAF on stdout) on the port's CPU engine, once on the
    single-shot route and once with ``_MAX_DEV_BASES`` below either
    genome (the paneled route alone): the same bytes, which are the JAX
    command line's (``-Eref``), with no decline printed."""
    gen = up[0]
    A, B = str(tmp_path / "A.fa"), str(tmp_path / "B.fa")
    synth.write_fasta(A, gen["A"], "a")
    synth.write_fasta(B, gen["B"], "b")
    real = tal.align_genomes
    routes = []
    monkeypatch.setattr(tal, "align_genomes",
                        lambda *a, **k: real(*a, cfg=CFG, **k))
    for name in ("device_tubes", "device_tubes_paneled"):
        fn = getattr(tp, name)
        monkeypatch.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                            routes.append(_n) or _f(*a, **k))
    single = _run(tcli.main, [A, B], device="cpu")
    assert routes == ["device_tubes"]
    monkeypatch.setattr(tp, "_MAX_DEV_BASES", 3 * 3000 // 2)
    paneled = _run(tcli.main, [A, B], device="cpu")
    assert routes[1:] == ["device_tubes_paneled"]
    assert _calls("devpipe.panel") == 2
    assert "declined" not in capsys.readouterr().err
    # every contig pair aligned, the inverted middle third on its own
    assert single.count("\n") >= 6 and "\t-\t" in single
    assert paneled == single
    assert paneled == _run(jcli.main, ["-Eref", A, B])


@pytest.mark.parametrize("panels", [2, 4, 16],
                         ids=["2 panels", "4 panels", "16 panels"])
def test_panel_spans_and_counters(up, on, panels):
    """Span ``devpipe.panel_plane`` runs once, ahead of the first
    ``devpipe.panel``, and counter ``devpipe.candidate_blocks`` counts
    each genome's candidate blocks once (one a genome here) whatever the
    panel count; span ``devpipe.panel`` runs once a panel and holds one
    ``devpipe.panel_scan`` and then one ``devpipe.panel_merge``."""
    _, g1, g2, alens = up
    got = tp.device_tubes_paneled(g1, g2, alens, panels=panels, device=CPU)
    want = tp.device_tubes(g1, g2, alens, device=CPU)
    assert got[1:] == want[1:]
    c = prof.counters()
    assert c["devpipe.candidate_blocks"] == 2
    assert "devpipe.panel_rescans" not in c
    assert _calls("devpipe.panel") == panels
    (plane,) = _names("devpipe.panel_plane")
    outer = {e[0]: e for e in _names("devpipe.panel")}
    assert len(outer) == panels
    assert plane[5] <= min(e[4] for e in outer.values())
    for inner in ("devpipe.panel_scan", "devpipe.panel_merge"):
        ev = _names(inner)
        assert len(ev) == panels
        assert sorted(e[1] for e in ev) == sorted(outer)
    for s, m in zip(_names("devpipe.panel_scan"),
                    _names("devpipe.panel_merge")):
        assert s[1] == m[1] and s[5] <= m[4]


ROUTES = ["pair", "self", "tables", "tables self", "paneled pair",
          "paneled self"]


@pytest.mark.parametrize("route", ROUTES)
def test_device_routes_chain_once_and_panel_only_when_paneled(up, on, route):
    """Every device route runs its chain sweep once; the paneled routes
    alone run ``devpipe.panel`` spans, one a panel, and return the seeds,
    plsum and tubes of the single-shot route of the same comparison."""
    _, g1, g2, alens = up
    lens1, lens2 = g1.contig_lengths(), g2.contig_lengths()
    amax, bmax = int(lens1.max()), int(lens2.max())
    want = None
    if route == "paneled pair":
        want = tp.device_tubes(g1, g2, alens, device=CPU)
    elif route == "paneled self":
        want = tp.device_tubes_self(g1, alens, device=CPU)
    prof.reset()
    if route == "pair":
        got = tp.device_tubes(g1, g2, alens, device=CPU)
    elif route == "self":
        got = tp.device_tubes_self(g1, alens, device=CPU)
    elif route.startswith("tables"):
        t1 = tgix.build_gix(g1)
        t2 = t1 if route == "tables self" else tgix.build_gix(g2)
        got = tp.device_tubes_tables(t1, t2, alens, amax,
                                     amax if t2 is t1 else bmax, device=CPU)
    else:
        got = tp.device_tubes_paneled(
            g1, None if route == "paneled self" else g2, alens, panels=2,
            device=CPU)
    assert got is not None and got[1] > 0
    assert _calls("devpipe.chain") == 1
    assert _calls("devpipe.panel") == (2 if want is not None else 0)
    if want is not None:
        assert got[1:] == want[1:]
        for f in dataclasses.fields(got[0]):
            assert np.array_equal(getattr(got[0], f.name),
                                  getattr(want[0], f.name)), f.name
