"""Shared fixtures of the benchmark's own tests (``pytest benchmark/tests``).

Tests marked ``cuda`` need an NVIDIA card and skip without one; the card
is looked for inside the ``card`` fixture, never while a module is
imported."""

import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def small_engine():
    """``align_genomes`` with a 16-lane wave engine on one torch thread
    (the plain stepper's time on the CPU grows with the lanes; the records
    do not depend on them), each input aligned once and its records reused
    (deep copies, so a fault that edits them edits a copy)."""
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.ops import wave as tw
    torch.set_num_threads(1)
    real = aligner.align_genomes
    cfg = tw.WaveConfig(n=16, w=256, chunk=64, max_chunks=64)
    memo = {}

    def run(g1, g2, t1=None, t2=None, params=aligner.FastGAParams(), **kw):
        key = (tuple(g1.get_contig(i).tobytes() for i in range(g1.ncontig)),
               tuple(g2.get_contig(i).tobytes() for i in range(g2.ncontig)),
               repr(params), sorted(kw.items(), key=str).__repr__(),
               aligner.dedup_group.__name__,
               __import__('fastga_tpu_torch.ops.device_pipeline', fromlist=['x']).device_tubes.__qualname__)
        if key not in memo:
            memo[key] = real(g1, g2, t1, t2, params, cfg=cfg, **kw)
        return copy.deepcopy(memo[key])
    return real, run


@pytest.fixture(scope="module")
def cpu_engine():
    from fastga_tpu_torch.models import aligner
    real, run = small_engine()
    aligner.align_genomes = run
    yield
    aligner.align_genomes = real
