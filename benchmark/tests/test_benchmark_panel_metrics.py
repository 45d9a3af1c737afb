"""The kmer-panel route's cell on the CPU: a tiny copy of ``ath_pair.paf``
(``ath_pair.json`` with a ``uniform_pair`` of four 3-kb blocks, the
single-shot route's bases lowered below the pair so that the jobs take
the paneled route) reads ``correct`` true; a traced run reads
``devpipe.panel_scan_s`` and ``devpipe.panel_merge_s`` as numbers, and a
program without the spans they read (an earlier version) leaves them out of
the result line."""

import json
import os
from contextlib import nullcontext

import pytest

import tiny
from conftest import BENCH
from core import harness

SEED = 2 ** 34 + 17
CELL = "tiny_ath.paf"
NEW = ("devpipe.panel_scan_s", "devpipe.panel_merge_s")
ADDED_SPANS = ("devpipe.panel_scan", "devpipe.panel_merge")
ADDED_COUNTERS = ("devpipe.panel_rescans",)


def make(dst):
    """tiny.make's copy with the configuration ``tiny_ath`` (ath_pair's
    file, its generator at four 3-kb blocks) and the cell ``tiny_ath.paf``
    added."""
    root = tiny.make(dst)
    with open(os.path.join(BENCH, "configs", "ath_pair.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_ath"
    cfg["generator"] = dict(kind="uniform_pair",
                            params=dict(ncontig=4, clen=3000, div=0.01))
    cfg["warmup"] = dict(kind="uniform_pair",
                         params=dict(ncontig=1, clen=3000))
    path = "benchmark/configs/tiny_ath.json"
    with open(os.path.join(root, path), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="tiny_ath", source="a CPU test",
                                 file=path, reduced=[], why="a test"))
    bench["workloads"].append(dict(name=CELL, config="tiny_ath",
                                   traffic="paf", chips=1, why="a test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="module")
def paneled():
    """A 16-lane wave engine on one torch thread (no records reused: every
    job seeds), and the single-shot route's bases below the tiny pair's
    12 kb a side, above the warm-up's 3 kb."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.ops import device_pipeline as tp
    from fastga_tpu_torch.ops import wave as tw
    from fastga_tpu_torch.utils import prof
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    real = aligner.align_genomes
    panels = []
    paneled_route = tp.device_tubes_paneled
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(aligner, "align_genomes",
                   lambda *a, **k: real(*a, cfg=cfg, **k))
        mp.setattr(tp, "device_tubes_paneled", lambda *a, **k: panels.append(
            1) or paneled_route(*a, **k))
        mp.setattr(tp, "_MAX_DEV_BASES", 6000)
        prof.reset()
        yield panels
        prof.reset()
    torch.set_num_threads(n)


def run_cell(root, traced):
    return harness.run(root, CELL, SEED, 0.5, traced, device="cpu")


def test_tiny_ath_cell_is_correct_on_the_paneled_route(root, paneled):
    del paneled[:]
    r = run_cell(root, False)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert len(paneled) == r["attempted"]
    assert set(r["metrics"]) == {"job_s", "peak_dev_gib", "setup_s"}


def test_traced_run_reads_the_panel_metrics(root, paneled):
    r = run_cell(root, True)
    assert r["correct"], r["checks"]
    got = r["metrics"]
    for m in NEW:
        assert got[m]["value"] > 0, m
    scan, merge = (got[m]["value"] for m in NEW)
    assert scan + merge < got["seeds.devpipe_s"]["value"]


def test_a_program_without_the_panel_spans_leaves_them_out(root, paneled,
                                                          monkeypatch):
    """An earlier program: the same route without the spans and the
    counter this change adds."""
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
    assert got["seeds.devpipe_s"]["value"] > 0
    for m in NEW:
        assert m not in got, m
