"""Finding a cell's files by the names in BENCHMARK.json."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell(root: str, workload: str):
    """(the cell's BENCHMARK.json entry, its configuration, its traffic
    mix, the whole BENCHMARK.json) for ``workload``."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"benchmark: no workload '{workload}' in "
                         f"BENCHMARK.json (known: {sorted(cells)})")
    w = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, confs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    return w, config, traffic, bench


def limits() -> dict:
    """The limits of the numbers compared (``limits/default.json``)."""
    return load_json(os.path.join(HERE, "limits", "default.json"))


def metric(name: str):
    """The module ``metrics/<name>.py``: its ``read(ctx)``, and for a
    kernel's roofline its ``KERNEL``, ``WRAPS`` and ``least_s``."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
