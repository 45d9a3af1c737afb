"""The port's span record (fastga_tpu_torch/utils/prof.py): ids, parents
and job ids of nested spans, ``seconds`` over nested spans of one name,
nothing recorded while off, the record_function ranges inside ``trace``,
and the spans and counters of one ``fastga -M -1:`` job on the CPU, its
masked tables built on the card and on the host."""

import ast
import inspect
import itertools
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fastga_tpu_torch.api import AlnReader
from fastga_tpu_torch.cli import fastga
from fastga_tpu_torch.io import gix
from fastga_tpu_torch.models import aligner
from fastga_tpu_torch.ops import device_pipeline as dp
from fastga_tpu_torch.ops import wave as tw
from fastga_tpu_torch.utils import prof

PORT = Path(__file__).resolve().parent.parent / "fastga_tpu_torch"


@pytest.fixture
def on(monkeypatch):
    """The spans on, over an empty record; left off and empty after."""
    prof.reset()
    monkeypatch.setattr(prof, "ENABLED", True)
    yield
    prof.reset()


@pytest.fixture
def clock(monkeypatch):
    """prof's perf_counter as 0, 1, 2, ... a call."""
    ticks = itertools.count()
    monkeypatch.setattr(prof, "time", types.SimpleNamespace(
        perf_counter=lambda: next(ticks)))


def by_name(events):
    return {e[3]: e for e in events}


def test_nested_spans_record_ids_parents_and_jobs(on):
    with prof.span("outside"):
        pass
    with prof.job():
        with prof.span("a"):
            with prof.span("b"):
                pass
        with prof.span("c"):
            pass
    with prof.job():
        with prof.span("a"):
            pass
    ev = prof.events()
    assert [e[3] for e in ev] == ["outside", "b", "a", "c", "fastga.job",
                                  "a", "fastga.job"]
    assert len({e[0] for e in ev}) == len(ev)
    ids = {e[0]: e for e in ev}
    first = ev[:5]
    names = by_name(first)
    assert names["outside"][1] is None and names["outside"][2] is None
    assert ids[names["b"][1]][3] == "a"
    assert ids[names["a"][1]][3] == "fastga.job"
    assert ids[names["c"][1]][3] == "fastga.job"
    assert names["fastga.job"][1] is None
    jobs = {e[2] for e in ev[1:5]}
    assert len(jobs) == 1 and None not in jobs
    assert ev[5][2] == ev[6][2] != ev[1][2]
    assert all(e[4] <= e[5] for e in ev)


def test_off_records_and_counts_nothing():
    prof.reset()
    assert prof.ENABLED is False
    with prof.job():
        with prof.span("a", device="cpu"):
            prof.count("n", 3)
    assert prof.events() == [] and prof.report() == {}
    assert prof.counters() == {}


def test_reset_clears_the_record(on):
    with prof.span("a"):
        prof.count("n", 2)
    assert prof.events() and prof.report() and prof.counters() == {"n": 2}
    prof.reset()
    assert prof.events() == [] and prof.report() == {}
    assert prof.counters() == {}


def test_seconds_counts_nested_same_name_spans_once(on, clock):
    with prof.span("a"):            # 0 .. 9
        with prof.span("b"):        # 1 .. 6
            with prof.span("a"):    # 2 .. 3
                pass
            with prof.span("c"):    # 4 .. 5
                pass
        with prof.span("a"):        # 7 .. 8
            pass
    with prof.span("b"):            # 10 .. 11
        pass
    assert prof.seconds("a") == 9
    assert prof.seconds("b") == 5 + 1
    assert prof.seconds("c") == 1
    assert prof.seconds("a", "b") == 9 + 1
    assert prof.seconds("b", "c") == 5 + 1
    assert prof.seconds("d") == 0
    # report() sums every closed span of a name, nested or not
    assert prof.report()["a"][1] == 3


def test_report_keeps_a_span_apart_from_its_counter(on, clock):
    """A name that is both a span and a counter (as ``gix.entries`` is):
    report() gives the span's seconds and calls, counters() the counter's
    total, and neither is added to the other; a counter alone reports its
    total with no seconds."""
    with prof.span("x"):            # 0 .. 1
        prof.count("x", 5)
    with prof.span("x"):            # 2 .. 3
        prof.count("x", 7)
    prof.count("y", 4)
    assert prof.report() == {"x": (2, 2), "y": (0.0, 4)}
    assert prof.counters() == {"x": 12, "y": 4}
    assert prof.seconds("x") == 2


def test_span_keeps_its_parameters():
    params = inspect.signature(prof.span).parameters
    assert list(params) == ["name", "device"]
    assert params["device"].default is None


def test_trace_puts_spans_in_the_profiler(on, tmp_path):
    with prof.trace(str(tmp_path)) as p:
        with prof.span("host.stage"):
            torch.ones(4).sum()
    assert "host.stage" in {e.name for e in p.events()}
    assert (tmp_path / "trace.json").exists()
    with prof.span("after"):
        pass
    assert prof._record_function is None


def _write_fa(path, seqs, masked):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            t = np.array(list("ACGT"))[s]
            for b, e in masked:
                t[b:e] = np.char.lower(t[b:e])
            f.write(f">c{i}\n" + "".join(t) + "\n")


@pytest.mark.parametrize("build", ["card", "host"])
def test_fastga_job_spans_and_counts(on, tmp_path, monkeypatch, build):
    """A tiny ``fastga -M -1:`` pair: one job id, the host stages nested
    under their callers, the GIX entries and the records written.  The
    masked tables are built on the card (``gix.build`` > ``gix.sort``),
    or past a lowered single-shot cap on the host, whose stages nest under
    ``gix.build`` too; ``gix.card_tables`` / ``gix.host_tables`` count
    them."""
    rng = np.random.default_rng(14)
    A = [rng.integers(0, 4, 4000) for _ in range(2)]
    B = []
    for a in A:
        b = a.copy()
        m = rng.random(len(b)) < 0.01
        b[m] = (b[m] + 1) % 4
        B.append(b)
    _write_fa(tmp_path / "A.fa", A, [(800, 1900)])
    _write_fa(tmp_path / "B.fa", B, [(800, 1900)])

    real, tables = aligner.align_genomes, []
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    monkeypatch.setattr(aligner, "align_genomes",
                        lambda *a, **k: real(*a, cfg=cfg, **k))
    if build == "host":
        monkeypatch.setattr(dp, "_MAX_DEV_BASES", 1000)
    where = {"card": (dp, "build_gix_device"), "host": (gix, "build_gix")}
    built = getattr(*where[build])

    def kept(*a, **k):
        tables.append(built(*a, **k))
        return tables[-1]
    monkeypatch.setattr(*where[build], kept)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path / "o.1aln"
        assert fastga.main(["-M", f"-1:{out}", str(tmp_path / "A.fa"),
                            str(tmp_path / "B.fa")], device="cpu") == 0
    finally:
        torch.set_num_threads(threads)

    ev = prof.events()
    assert len({e[2] for e in ev}) == 1 and ev[0][2] is not None
    ids = {e[0]: e for e in ev}

    def parent(e):
        return ids[e[1]][3] if e[1] is not None else None
    roots = [e for e in ev if e[1] is None]
    assert [e[3] for e in roots] == ["fastga.job"]
    want = {"cli.resolve_genome": {"fastga.job"},
            "gdb.create": {"cli.resolve_genome"},
            "gix.build": {"cli.resolve_genome"},
            "gix.entries": {"gix.build"}, "gix.maskb": {"gix.entries"},
            "gix.sort": {"gix.build"}, "gix.lcp": {"gix.build"},
            "aligner.align_genomes": {"fastga.job"},
            "io.write": {"fastga.job"},
            "devpipe.upload": {"devpipe.gix1", "devpipe.gix2"}}
    for e in ev:
        if e[3] in want:
            assert parent(e) in want[e[3]], e
    n = {k: sum(1 for e in ev if e[3] == k) for k in want}
    assert n["cli.resolve_genome"] == n["gdb.create"] == 2
    assert n["gix.build"] == n["gix.sort"] == 2
    assert n["gix.lcp"] == n["gix.entries"] == (2 if build == "host" else 0)
    assert n["aligner.align_genomes"] == n["io.write"] == 1
    assert n["devpipe.upload"] == 2
    t = by_name(ev)
    last_resolve = max(e[5] for e in ev if e[3] == "cli.resolve_genome")
    assert last_resolve <= t["aligner.align_genomes"][4]
    assert t["aligner.align_genomes"][5] <= t["io.write"][4]

    counts = prof.counters()
    assert len(tables) == 2
    assert counts["gix.entries"] == sum(tb.n for tb in tables) > 0
    other = {"card": "host", "host": "card"}[build]
    assert counts.get(f"gix.{build}_tables") == 2
    assert f"gix.{other}_tables" not in counts
    assert counts["io.records"] == AlnReader(out, see_seq=False).count > 0
    assert prof.seconds("gix.build") <= prof.seconds("cli.resolve_genome")


def test_no_module_binds_span_by_name():
    """Every span is called as ``prof.span``, looked up on the module, so
    a wrapper put in its place sees it."""
    bound = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and \
                    (node.module or "").split(".")[-1] == "prof":
                bound.append((path.name, node.lineno))
            if isinstance(node, ast.Assign) and \
                    isinstance(node.value, ast.Attribute) and \
                    node.value.attr in ("span", "job"):
                bound.append((path.name, node.lineno))
    assert bound == []
