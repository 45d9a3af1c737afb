"""The harness: a run of a tiny copy of each cell on the CPU, the faults
and controls that must make ``correct`` false, the data-driven layout,
and what a run may not import or do."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

import tiny
from conftest import BENCH, ROOT
from core import faults, harness

SEED = 2 ** 34 + 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("bench")))


def run_cell(root, workload, traced=False):
    return harness.run(root, workload, SEED, 0.5, traced, device="cpu")


@pytest.mark.parametrize("workload", [c[0] for c in tiny.CELLS])
def test_tiny_cell_is_correct(root, cpu_engine, workload):
    r = run_cell(root, workload)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"job_s", "peak_dev_gib", "setup_s"}
    assert list(r)[-1] == "checks"


def test_traced_run_reads_the_span_metrics(root, cpu_engine):
    r = run_cell(root, "tiny_h.aln1", traced=True)
    assert r["correct"], r["checks"]
    for m in ("cli.resolve_s", "io.write_s", "aligner.dedup_s",
              "seeds.devpipe_s", "replay_s"):
        assert r["metrics"][m]["value"] > 0, m
    # the device numbers come from a card's trace only
    assert "device.idle_share" not in r["metrics"]
    assert "wave_chunk_roofline" not in r["metrics"]


@pytest.mark.parametrize("workload,fault,number", [
    ("tiny_u.paf", "comp_off", "uncovered_max"),
    ("tiny_h.aln1", "dedup_off", "redundant"),
    ("tiny_m.masked", "masks_off", "in_mask"),
    ("tiny_u.paf", "half_left_out", "uncovered_max"),
    ("tiny_h.aln1", "half_left_out", "uncovered_max"),
    ("tiny_m.masked", "half_left_out", "uncovered_max"),
    ("tiny_u.paf", "answer_altered", "lies"),
    ("tiny_h.aln1", "answer_altered", "lies"),
    ("tiny_m.masked", "answer_altered", "lies"),
    ("tiny_u.paf", "diffs_added", "excess_share"),
    ("tiny_h.aln1", "diffs_added", "excess_share"),
    ("tiny_m.masked", "diffs_added", "excess_share"),
    ("tiny_m.masked", "ends_cut", "uncovered_max"),
    ("tiny_h.aln1", "trace_broken", "bad_trace"),
    ("tiny_h.aln1", "contig_swapped", "off_truth"),
    ("tiny_h.aln1", "file_truncated", "unreadable"),
    ("tiny_u.paf", "index_kept", "stray_files"),
])
def test_fault_makes_the_run_incorrect(root, cpu_engine, workload, fault,
                                       number):
    with faults.FAULTS[fault]():
        r = run_cell(root, workload)
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] > c["limit"], r["checks"]


def _digest(path):
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            out[os.path.relpath(p, path)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


RUNNER = """
import json, os, sys
root = sys.argv[1]
sys.path[:0] = [os.path.join(root, "benchmark"), {repo!r}]
from core import harness          # the copy's harness, not the repo's
sys.path.append({tests!r})
from conftest import small_engine
from fastga_tpu_torch.models import aligner
aligner.align_genomes = small_engine()[1]
assert harness.__file__.startswith(root), harness.__file__
r = harness.run(root, sys.argv[2], int(sys.argv[3]), 0.5,
                bool(int(sys.argv[4])), device="cpu")
print(json.dumps(r))
"""


def _add(root, rel, text):
    with open(os.path.join(root, rel), "w") as f:
        f.write(text)


KERNEL_METRIC = """
KERNEL = r"wave_chunk_kernel"
WRAPS = [("fastga_tpu_torch.ops.wave_kernels", "wave_chunk")]


def least_s(call, out):
    assert call["G"] > 0 and len(call["st"]) == len(out[0])
    return 1.0          # one a launch: the count of launches


def read(ctx):
    return ctx.least_s.get("dummy.launches")
"""


def test_a_config_mix_and_metric_are_added_as_files(root, tmp_path):
    """A new configuration, traffic mixes (one of them a self comparison,
    one genome a job) and per-layer metrics (one of them wrapping a
    kernel's entry, as a roofline does): new files and new entries in
    BENCHMARK.json, no file of the benchmark edited."""
    before = _digest(os.path.join(root, "benchmark"))
    cfg = json.load(open(os.path.join(root, "benchmark/configs/tiny_u.json")))
    cfg["name"] = "dummy"
    cfg["generator"]["params"] = {"ncontig": 3, "clen": 1500}
    _add(root, "benchmark/configs/dummy.json", json.dumps(cfg))
    _add(root, "benchmark/traffic/dummy_mix.json", json.dumps(
        {"flags": ["-paf"], "output": "paf", "genomes": 2, "pairs": 2}))
    _add(root, "benchmark/traffic/dummy_self.json", json.dumps(
        {"flags": [], "output": "1aln", "genomes": 1, "pairs": 1}))
    _add(root, "benchmark/metrics/dummy.jobs.py",
         "def read(ctx):\n    return float(ctx.jobs)\n")
    _add(root, "benchmark/metrics/dummy.launches.py", KERNEL_METRIC)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["configs"].append(dict(name="dummy", source="a test",
                                 file="benchmark/configs/dummy.json",
                                 reduced=[], why="a test"))
    bench["workloads"] += [
        dict(name="dummy.dummy_mix", config="dummy", traffic="dummy_mix",
             chips=1, why="t"),
        dict(name="tiny_h.dummy_self", config="tiny_h",
             traffic="dummy_self", chips=1, why="t")]
    for name, unit in (("dummy.jobs", "jobs"), ("dummy.launches", "s")):
        bench["per_layer"].append(dict(name=name, unit=unit,
                                       better="higher", source="host_clock",
                                       layer="command line", moves="job_s"))
    _add(root, "BENCHMARK.json", json.dumps(bench))
    drv = tmp_path / "drive.py"
    drv.write_text(RUNNER.format(repo=ROOT,
                                 tests=os.path.join(BENCH, "tests")))
    for cell in ("dummy.dummy_mix", "tiny_h.dummy_self"):
        out = subprocess.run([sys.executable, str(drv), root, cell,
                              str(SEED), "1"], capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        r = json.loads(out.stdout.strip().splitlines()[-1])
        assert r["correct"], (cell, r["checks"])
        assert r["metrics"]["dummy.jobs"]["value"] >= 1
        assert r["metrics"]["dummy.launches"]["value"] >= 1
    after = _digest(os.path.join(root, "benchmark"))
    assert {k: v for k, v in after.items() if k in before} == before


FORBIDDEN = """
import sys
sys.path[:0] = [{bench!r}, {repo!r}]
import core.harness, core.gen, core.spec, core.trace, core.roofline
import core.faults
import reference.judge, reference.onealn, reference.paf, reference.fasta
import reference.editdist
top = {{m.split(".")[0] for m in sys.modules}}
print(sorted(top & {{"jax", "jaxlib", "flax", "fastga_tpu",
                     "fastga_tpu_torch"}}))
"""


def test_benchmark_imports_no_jax_and_reference_no_program():
    code = FORBIDDEN.format(bench=BENCH, repo=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    # the reference's sources name none of them either
    for f in os.listdir(os.path.join(BENCH, "reference")):
        if f.endswith(".py"):
            src = open(os.path.join(BENCH, "reference", f)).read()
            for bad in ("import jax", "fastga_tpu", "from jax"):
                assert bad not in src, (f, bad)


def test_program_run_loads_no_jax(root, cpu_engine):
    run_cell(root, "tiny_u.paf")
    assert harness.forbidden_modules() == []


def test_without_a_card_the_run_fails_and_prints_nothing(root):
    out = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "run.py"),
         "--workload", "tiny_u.paf", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=root, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/."""
    tiny.make(str(tmp_path))
    out = subprocess.run(
        [sys.executable, os.path.join(tmp_path, "benchmark", "run.py"),
         "--workload", "tiny_u.paf", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_control_on_the_card(card, root):
    """The control of each tiny cell, on the card: the timed path with the
    reverse strand dropped, dedup skipped or -M dropped reads as not
    correct, the sound run as correct."""
    for workload, control in (("tiny_u.paf", "comp_off"),
                              ("tiny_h.aln1", "dedup_off"),
                              ("tiny_m.masked", "masks_off")):
        ok = harness.run(root, workload, SEED, 0.5, False)
        assert ok["correct"], ok["checks"]
        with faults.FAULTS[control]():
            bad = harness.run(root, workload, SEED, 0.5, False)
        assert not bad["correct"]
