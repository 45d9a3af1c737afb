"""Build, load and launch helpers shared by the port's CUDA kernels.

Every kernel source ``csrc/<name>.cu`` exports a plain C function
``<name>_launch`` that enqueues its kernels on the stream it is given and
returns the CUDA error code (0 on success).  ``build_kernels()`` compiles all
sources with nvcc for ``sm_90a`` into ``fastga_tpu_torch/_build/`` at first
use (one nvcc per source, all started together; a library is rebuilt when it
is older than its source or a header it includes) and loads them with
ctypes.  ``LAUNCHES`` counts launches per kernel: each wrapper adds one
where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD = os.path.join(os.path.dirname(_HERE), "_build")

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# name -> (headers the source includes, argtypes of <name>_launch)
KERNELS = {
    "wave_chunk": (("wave_common.cuh",),
                   [_vp, _ci, _vp] + [_vp] * 5 + [_vp] * 5 + [_vp, _vp]
                   + [_ci] * 7 + [_vp]),
    # pool, P, eight tube columns, state, scalars, N, W, fwd, stream
    "wave0": (("wave_common.cuh",),
              [_vp, _ci] + [_vp] * 10 + [_ci] * 3 + [_vp]),
    "backtrack_walk": ((), [_vp] * 6 + [_ci] * 3 + [_vp]),
    # A columns, B columns, out columns (pointer arrays), ncols, E1, E2,
    # splits scratch and its length, stream
    "merge_path": ((), [_vp, _vp, _vp, _ci, _cll, _cll, _vp, _cll, _vp]),
    # value, out, flag pointer arrays, ops, flag ids, nch, nflags, M,
    # reverse, wide (int64 values), look-back words and their tiles, stream
    "fused_scan": ((), [_vp, _vp, _vp, _vp, _vp, _ci, _ci, _cll, _ci, _ci,
                        _vp, _ci, _vp]),
}

LAUNCHES = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_libs = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc():
    for p in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc"), "nvcc"):
        if os.path.sep not in p or os.path.exists(p):
            return p
    return "nvcc"


def build_kernels():
    """Compile every kernel source that is missing or older than its
    sources (one nvcc per source, all started together) and load them.
    Returns {name: ctypes.CDLL}."""
    with _lock:
        if len(_libs) == len(KERNELS):
            return _libs
        os.makedirs(BUILD, exist_ok=True)
        procs = {}
        for name, (headers, _) in KERNELS.items():
            src = os.path.join(CSRC, name + ".cu")
            so = os.path.join(BUILD, "lib" + name + ".so")
            newest = max(os.path.getmtime(os.path.join(CSRC, f))
                         for f in (name + ".cu",) + headers)
            if os.path.exists(so) and os.path.getmtime(so) >= newest:
                continue
            tmp = so + ".%d.tmp" % os.getpid()
            procs[name] = (subprocess.Popen(
                [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-I", CSRC, "-o", tmp, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, so)
        failed = []
        for name, (p, tmp, so) in procs.items():
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"nvcc failed for {name}.cu:\n"
                              + log.decode(errors="replace"))
                continue
            os.replace(tmp, so)
            with open(os.path.join(BUILD, name + ".ptxas.txt"), "wb") as f:
                f.write(log)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (_, argtypes) in KERNELS.items():
            lib = ctypes.CDLL(os.path.join(BUILD, "lib" + name + ".so"))
            fn = getattr(lib, name + "_launch")
            fn.restype = _ci
            fn.argtypes = argtypes
            _libs[name] = lib
        return _libs


def check(t, dtype, shape, name):
    """Refuse what a kernel does not take: device, dtype, shape,
    contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def ptr_array(ts):
    """Device pointers of ``ts`` as a C array (void**), for the kernels
    that take a runtime number of columns."""
    arr = (ctypes.c_void_p * max(len(ts), 1))(*[t.data_ptr() for t in ts])
    return ctypes.cast(arr, ctypes.c_void_p), arr


def int_array(vals):
    arr = (ctypes.c_int * max(len(vals), 1))(*vals)
    return ctypes.cast(arr, ctypes.c_void_p), arr


def stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
