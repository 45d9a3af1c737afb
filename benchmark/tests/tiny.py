"""A copy of the benchmark at a size a CPU test can hold: BENCHMARK.json
and benchmark/ copied into a directory, with tiny configurations and
cells added as new files and entries (nothing that was there edited)."""

import json
import os
import shutil

from conftest import BENCH, ROOT

TINY = {
    # name: (generator kind, its params, the warm-up pair's params)
    "tiny_u": ("uniform_pair", {"ncontig": 4, "clen": 3300},
               {"ncontig": 1, "clen": 2000}),
    "tiny_h": ("repeat_rich_pair", {"total_bp": 30000, "ncontig": 2,
                                    "repeat_frac": 0.55,
                                    "copies_per_subfam": 4,
                                    "subfam_per_fam": 2},
               {"total_bp": 10000, "ncontig": 1, "repeat_frac": 0.5,
                "copies_per_subfam": 3, "subfam_per_fam": 2}),
    "tiny_m": ("repeat_rich_pair", {"total_bp": 30000, "ncontig": 2,
                                    "repeat_frac": 0.55,
                                    "copies_per_subfam": 3,
                                    "subfam_per_fam": 1},
               {"total_bp": 10000, "ncontig": 1, "repeat_frac": 0.5,
                "copies_per_subfam": 3, "subfam_per_fam": 1}),
}
CELLS = [("tiny_u.paf", "tiny_u", "paf"), ("tiny_h.aln1", "tiny_h", "aln1"),
         ("tiny_m.masked", "tiny_m", "masked")]


def make(dst):
    """The copy under ``dst``; returns its root."""
    shutil.copytree(BENCH, os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, (kind, params, warm) in TINY.items():
        with open(os.path.join(BENCH, "configs", "hap_pair.json")) as f:
            cfg = json.load(f)
        cfg["name"] = name
        cfg["generator"] = dict(kind=kind, params=params)
        cfg["warmup"] = dict(kind=kind, params=warm)
        path = f"benchmark/configs/{name}.json"
        with open(os.path.join(dst, path), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append(dict(name=name, source="a CPU test",
                                     file=path, reduced=[], why="a test"))
    for wl, conf, mix in CELLS:
        bench["workloads"].append(dict(name=wl, config=conf, traffic=mix,
                                       chips=1, why="a test"))
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst
