"""The per-layer metrics that read the program's own span record
(``core/record.py``): a traced run of the tiny masked cell reads every
one, and ``cli.resolve_s`` reads the same whether or not the program's
span of that name sits inside the benchmark's wrapper."""

import pytest

import tiny
from core import harness, trace

SEED = 2 ** 34 + 5
PROGRAM = ("gdb.create_s", "gix.build_s", "gix.sort_s", "gix.entries_per_s",
           "devpipe.upload_s", "io.writer_s", "io.records_per_s")


@pytest.fixture(scope="module")
def traced(tmp_path_factory, cpu_engine):
    """One traced run of tiny_m.masked: (its result, its Recorder)."""
    from fastga_tpu_torch.utils import prof
    root = tiny.make(str(tmp_path_factory.mktemp("bench")))
    kept = []

    class Kept(trace.Recorder):
        def __init__(self):
            super().__init__()
            kept.append(self)
    prof.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace, "Recorder", Kept)
        r = harness.run(root, "tiny_m.masked", SEED, 0.5, True,
                        device="cpu")
    prof.reset()
    return r, kept[0]


def test_traced_masked_run_reads_the_program_metrics(traced):
    r, _ = traced
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for m in PROGRAM:
        assert got[m]["value"] >= 0, m
    for m in ("gdb.create_s", "gix.build_s", "gix.sort_s",
              "gix.entries_per_s", "io.writer_s"):
        assert got[m]["value"] > 0, m
    assert got["gix.build_s"]["value"] <= got["cli.resolve_s"]["value"]
    assert got["gix.sort_s"]["value"] < got["gix.build_s"]["value"]


def test_resolve_s_counts_the_programs_same_name_span_once(traced):
    r, rec = traced
    name = trace.RESOLVE
    inner = [s for s in rec.spans if s[0] == name and name in s[3]]
    outer = [s for s in rec.spans if s[0] == name and name not in s[3]]
    assert outer and len(inner) == len(outer)
    alone = trace.Recorder()
    alone.spans = [s for s in rec.spans if s not in inner]
    assert rec.total([name]) == alone.total([name]) > 0
    jobs = sum(1 for s in rec.spans if s[0] == trace.JOB)
    assert r["metrics"]["cli.resolve_s"]["value"] == pytest.approx(
        alone.total([name]) / jobs)
