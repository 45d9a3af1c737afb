"""Every module of fastga_tpu has a counterpart in fastga_tpu_torch with its
top-level public names, but for the exceptions named below, each with its
reason.  Both trees are parsed with ``ast``; neither is imported.  Only the
JAX-to-port direction is held: the port may have names of its own (its
plain kernel versions, ``cuda_build``, ``convert``)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# modules without a counterpart of the same name
MODULE_EXCEPTIONS = {
    # the Pallas kernels: their counterparts are csrc/*.cu behind
    # ops/{wave,merge,scan}_kernels.py
    "ops/merge_pallas.py": "Pallas kernel (csrc/merge_path.cu)",
    "ops/scan_pallas.py": "Pallas kernel (csrc/fused_scan.cu)",
    "ops/wave_pallas.py": "Pallas kernels (csrc/wave_chunk.cu, wave0.cu, "
                          "backtrack_walk.cu)",
    "ops/wave_pallas_old.py": "dead snapshot of wave_pallas.py; nothing "
                              "imports it",
}

# public names of a ported module that the port does not have
NAME_EXCEPTIONS = {
    "ops/wave.py": {
        "build_forward_chunk": "XLA twin of the chunk kernel; its plain "
                               "version is wave_kernels.chunk_plain",
        "build_wave0": "XLA twin of wave0; plain version "
                       "wave_kernels.wave0_plain",
        "host_wave0": "host twin of wave0; plain version "
                      "wave_kernels.wave0_plain",
        "CH_DIAG": "choice codes of the XLA twin",
        "CH_HIGH": "choice codes of the XLA twin",
        "CH_LOW": "choice codes of the XLA twin",
        "CH_NONE": "choice codes of the XLA twin",
    },
    "ops/syncmer.py": {
        "syncmer_mask_jnp": "jnp version; its counterpart is syncmer_mask",
    },
    "utils/prof.py": {
        "maybe_start_jax_trace": "jax.profiler; the port's is prof.trace",
        "add": "removed from the port's copy: nothing calls it",
    },
    "ops/device_pipeline.py": {
        "CHAIN_PANEL_MAX": "the host chain sweep's panel cap; the port "
                           "chains past any cap on the card",
        "DECLINE": "a decline is raised (Declined, with its reason), not "
                   "stored in the module",
    },
    "models/aligner.py": {
        "prewarm": "XLA compile warm-up",
        "wait_engine_warmups": "XLA compile warm-up",
        "release_pool_cache": "a pool cache the port does not keep",
    },
    "parallel/sharded.py": {
        "build_sharded_tubes": "builds one jit program per shape class; "
                               "eager PyTorch has none",
    },
}


def _public_names(path):
    """Top-level names a module defines (functions, classes, assignment
    targets), public ones and __version__."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                names.update(n.id for n in ast.walk(t)
                             if isinstance(n, ast.Name))
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def _modules():
    base = os.path.join(ROOT, "fastga_tpu")
    out = []
    for d, dirs, files in os.walk(base):
        dirs[:] = sorted(x for x in dirs if not x.startswith("_"))
        for f in sorted(files):
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), base))
    return out


MODULES = _modules()


def test_every_module_has_a_counterpart():
    missing = {m for m in MODULES if not os.path.exists(
        os.path.join(ROOT, "fastga_tpu_torch", m))}
    assert missing == set(MODULE_EXCEPTIONS)
    assert "parallel/sharded.py" in MODULES


@pytest.mark.parametrize("module", [m for m in MODULES
                                    if m not in MODULE_EXCEPTIONS])
def test_public_names_ported(module):
    want = _public_names(os.path.join(ROOT, "fastga_tpu", module))
    got = _public_names(os.path.join(ROOT, "fastga_tpu_torch", module))
    assert want - got == set(NAME_EXCEPTIONS.get(module, {}))


def test_version():
    import fastga_tpu_torch
    assert fastga_tpu_torch.__version__ == "0.1.0"
