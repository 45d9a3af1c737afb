"""The port imports neither JAX nor the JAX package, and its entry point
runs on the card unless the caller asks for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    """Import every module of fastga_tpu_torch, and chip_smoke as a
    module, in a fresh interpreter (this one has jax loaded by the
    conftest)."""
    import fastga_tpu_torch
    mods = ["fastga_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(fastga_tpu_torch.__path__,
                                              "fastga_tpu_torch.")]
    assert "fastga_tpu_torch.ops.wave_kernels" in mods
    assert {f"fastga_tpu_torch.cli.{t}" for t in (
        "fastga", "gixmake", "alntopaf", "fatogdb", "gdbshow", "gdbstat",
        "gdbtofa", "gixshow", "gixrm", "gixcp", "gixmv", "gixxfer", "fastks",
        "anoshow", "anostat", "anotobed", "bedtoano")} <= set(mods)
    assert {"fastga_tpu_torch.utils.select",
            "fastga_tpu_torch.utils.fmt"} <= set(mods)
    assert {f"fastga_tpu_torch.parallel.{m}" for m in (
        "distributed", "sharded", "mesh")} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib') or m.startswith('jax') or m == 'fastga_tpu' "
        "or m.startswith('fastga_tpu.')]\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_align_genomes_needs_the_card_unless_cpu(monkeypatch):
    import torch

    from fastga_tpu_torch.models import aligner
    from fastga_tpu_torch.utils import synth
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, _ = synth.to_gdb("a", [synth.np.zeros(100, synth.np.uint8)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        aligner.align_genomes(g, g)
    assert aligner.resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_mix():
    """A CUDA wrapper never takes the plain path for a CUDA tensor and
    checks what it is given: a CPU tensor handed to the launch checks
    is refused."""
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        wk._check(torch.zeros(4, dtype=torch.int32), torch.int32, (4,),
                  "pool")


@pytest.mark.parametrize("W, match", [(100, "multiple of 32"),
                                      (4096, "at most 2048"),
                                      (256, "aw: expected a CUDA tensor")])
def test_wave0_wrapper_refuses_cpu_mix_and_bad_w(W, match):
    """wave0 hands its tube columns to the kernel as they are (no stack):
    with a pool off the CPU (a meta tensor stands in for the card's), CPU
    columns are refused, and so is a W the kernel does not take."""
    import torch

    from fastga_tpu_torch.ops import wave_kernels as wk
    pool = torch.zeros(64, dtype=torch.int32, device="meta")
    col = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        wk.wave0(pool, (col,) * 6, col, col, col, col, W, 1)


def test_device_seeds_neither_raise_on_caps_nor_catch():
    """Past the JAX package's caps after upload the device seed pipeline
    sizes to its counts: no helper that raises on a cap is left in the
    package, the pipeline has no host chain sweep to fall back to,
    neither the pipeline nor its sharded route catches an exception, and
    the aligner that routes them catches only ``Declined``, which a route
    raises before any upload (an error on the card reaches the
    caller)."""
    pkg = os.path.join(ROOT, "fastga_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    assert "_over_cap" not in fh.read(), f
    for rel in ("ops/device_pipeline.py", "models/aligner.py",
                "parallel/sharded.py"):
        with open(os.path.join(pkg, rel)) as fh:
            tree = ast.parse(fh.read())
        caught = [ast.unparse(h.type) if h.type else "everything"
                  for n in ast.walk(tree) if isinstance(n, ast.Try)
                  for h in n.handlers]
        assert caught == (["devp.Declined"] if rel == "models/aligner.py"
                          else []), rel
    from fastga_tpu_torch.ops import device_pipeline as tp
    assert not hasattr(tp, "chain_tubes") and not hasattr(tp, "SeedBatch")
