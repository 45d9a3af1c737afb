"""The single-shot pair route's cell on the CPU: a tiny copy of
``cel_pair.paf`` (``cel_pair.json`` with a ``uniform_pair`` of four 3-kb
blocks) reads ``correct`` true with every job on ``device_tubes``; a traced
run reads ``devpipe.prep_s``, ``devpipe.tables_s``, ``devpipe.merge_s``,
``devpipe.merge_rows_per_s`` and ``devpipe.chain_s`` as numbers (and
``merge_path_roofline``, a device number, on a card only); and a program
without the span and counter the route's metrics read (an earlier version)
leaves ``devpipe.prep_s`` and ``devpipe.merge_rows_per_s`` out of the
result line."""

import json
import os
from contextlib import nullcontext

import pytest

import tiny
from conftest import BENCH
from core import harness

SEED = 2 ** 34 + 29
CELL = "tiny_cel.paf"
SPANS = ("devpipe.prep_s", "devpipe.tables_s", "devpipe.merge_s",
         "devpipe.chain_s")
RATE = "devpipe.merge_rows_per_s"
ROOFLINE = "merge_path_roofline"
ADDED_SPANS = ("devpipe.prep",)
ADDED_COUNTERS = ("devpipe.merge_rows",)


def make(dst):
    """tiny.make's copy with the configuration ``tiny_cel`` (cel_pair's
    file, its generator at four 3-kb blocks) and the cell ``tiny_cel.paf``
    added."""
    root = tiny.make(dst)
    with open(os.path.join(BENCH, "configs", "cel_pair.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_cel"
    cfg["generator"] = dict(kind="uniform_pair",
                            params=dict(ncontig=4, clen=3000, div=0.01))
    cfg["warmup"] = dict(kind="uniform_pair",
                         params=dict(ncontig=1, clen=3000))
    path = "benchmark/configs/tiny_cel.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny_cel", source="a CPU test",
                                 file=path, reduced=[], why="a test"))
    bench["workloads"].append(dict(name=CELL, config="tiny_cel",
                                   traffic="paf", chips=1, why="a test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def routes():
    """A 16-lane wave engine on one torch thread (no records reused: every
    job seeds), and the seed routes each job takes, by name."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.ops import device_pipeline as tp
    from fastga_tpu_torch.ops import wave as tw
    from fastga_tpu_torch.utils import prof
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    real = aligner.align_genomes
    taken = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aligner, "align_genomes",
                   lambda *a, **k: real(*a, cfg=cfg, **k))
        for name in ("device_tubes", "device_tubes_paneled"):
            fn = getattr(tp, name)
            mp.setattr(tp, name, lambda *a, _f=fn, _n=name, **k:
                       taken.append(_n) or _f(*a, **k))
        prof.reset()
        yield taken
        prof.reset()
    torch.set_num_threads(n)


def run_cell(root, traced):
    return harness.run(root, CELL, SEED, 0.5, traced, device="cpu")


def test_tiny_cel_cell_is_correct_on_the_single_shot_route(root, routes):
    del routes[:]
    r = run_cell(root, False)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # the warm-up job and each job of the window
    assert routes == ["device_tubes"] * (r["attempted"] + 1)
    assert set(r["metrics"]) == {"job_s", "peak_dev_gib", "setup_s"}


def test_traced_run_reads_the_single_shot_metrics(root, routes):
    r = run_cell(root, True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for m in SPANS + (RATE,):
        assert got[m]["value"] > 0, m
    prep, tables, merge, chain = (got[m]["value"] for m in SPANS)
    assert prep < tables
    assert tables + merge + chain < got["seeds.devpipe_s"]["value"]
    # the device numbers come from a card's trace only
    assert ROOFLINE not in got
    assert "devpipe.panel_merge_s" not in got


def test_a_program_without_the_route_span_and_counter_leaves_them_out(
        root, routes, monkeypatch):
    """An earlier program: the same route without the span and the counter
    this change adds."""
    from fastga_tpu_torch.utils import prof
    span, count = prof.span, prof.count
    monkeypatch.setattr(prof, "span", lambda name, device=None: (
        nullcontext() if name in ADDED_SPANS else span(name, device)))
    monkeypatch.setattr(prof, "count", lambda name, n=1: (
        None if name in ADDED_COUNTERS else count(name, n)))
    prof.reset()
    r = run_cell(root, True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for m in ("devpipe.tables_s", "devpipe.merge_s", "devpipe.chain_s"):
        assert got[m]["value"] > 0, m
    assert "devpipe.prep_s" not in got
    assert RATE not in got


@pytest.mark.cuda
def test_merge_path_roofline_on_the_card(card, root):
    """On the card, a traced run of the tiny cell reads merge_path's share
    of its roofline, at most 100 percent."""
    from fastga_tpu_torch.utils import prof
    prof.reset()
    r = harness.run(root, CELL, SEED, 0.5, True)
    prof.reset()
    assert r["correct"], r["checks"]
    assert 0 < r["metrics"][ROOFLINE]["value"] <= 100
    assert r["metrics"][RATE]["value"] > 0
