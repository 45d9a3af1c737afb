# Copied from fastga_tpu/native/__init__.py; imports point at fastga_tpu_torch.
"""Native (C) hot-path helpers, built on demand with the system compiler.

The C sources live next to this file; the shared library is compiled into
``_build/`` on first use (and rebuilt when the source is newer).  Every
binding has a pure-Python fallback — callers treat a ``None`` return from
:func:`get_tracerec` or :func:`get_fagdb` as "use the Python
implementation".

- ``tracerec``: trace points, replay and dedup of the wave path.
- ``fagdb``: FASTA to GDB in one pass (``io/gdb.py::create_gdb``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_lock = threading.Lock()
_libs = {}


def _build(name: str) -> str:
    here = os.path.dirname(__file__)
    src = os.path.join(here, name + ".c")
    cache = os.path.join(here, "_build")
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, "lib" + name + ".so")
    if (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(src)):
        cc = "cc"
        tmp = so + ".%d.tmp" % os.getpid()
        subprocess.run([cc, "-O2", "-fPIC", "-shared", "-o", tmp, src],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _load(name: str, declare):
    """Build and load lib<name>.so once, ``declare`` its signatures; None
    when either fails."""
    with _lock:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(_build(name))
                declare(lib)
            except Exception:
                lib = None
            _libs[name] = lib
        return _libs[name]


def get_tracerec():
    """ctypes handle to the tracerec library, or None."""
    return _load("tracerec", _declare_tracerec)


def _declare_tracerec(lib):
    c = ctypes
    i8p = c.POINTER(c.c_int8)
    i32p = c.POINTER(c.c_int32)
    lib.trw_new.restype = c.c_void_p
    lib.trw_new.argtypes = []
    lib.trw_free.restype = None
    lib.trw_free.argtypes = [c.c_void_p]
    lib.trw_compute_trace_pts.restype = c.c_int
    lib.trw_compute_trace_pts.argtypes = [
        c.c_void_p, i8p, c.c_int64, i8p, c.c_int64,
        c.c_int64, c.c_int64, c.c_int64, c.c_int64,
        i32p, c.c_int, c.c_int, c.c_int, c.c_int]
    lib.trw_trace.restype = i32p
    lib.trw_trace.argtypes = [c.c_void_p]
    lib.trw_trace_len.restype = c.c_int
    lib.trw_trace_len.argtypes = [c.c_void_p]
    lib.trw_gap_improver.restype = c.c_int
    lib.trw_gap_improver.argtypes = [
        c.c_void_p, i8p, c.c_int64, i8p, c.c_int64,
        c.c_int64, c.c_int64, c.c_int64, i32p, c.c_int]
    lib.trw_path_reach.restype = c.c_int
    lib.trw_path_reach.argtypes = [
        i8p, c.c_int64, i8p, c.c_int64, c.c_int64, i32p,
        c.c_int, c.c_int64, c.c_int,
        c.POINTER(c.c_int64)]
    lib.trw_replay_fwd.restype = c.c_int
    lib.trw_replay_fwd.argtypes = [
        i8p, c.c_int64, i8p, c.c_int64, c.c_int64, i32p,
        c.c_int, c.c_int64, c.c_int64, c.c_int64,
        c.c_int64, c.c_int64, i32p, c.c_int, i32p]
    i64p = c.POINTER(c.c_int64)
    u8p = c.POINTER(c.c_uint8)
    lib.trw_dedup_group.restype = c.c_int
    lib.trw_dedup_group.argtypes = [
        c.c_int, i64p, i64p, i64p, i64p, i64p,
        i32p, i64p, c.c_int64, u8p,
        i32p, i64p, c.c_int64]
    lib.trw_replay_rev.restype = c.c_int
    lib.trw_replay_rev.argtypes = [
        i8p, c.c_int64, i8p, c.c_int64, c.c_int64, i32p,
        c.c_int, c.c_int64, c.c_int64, c.c_int64,
        c.c_int64, c.c_int64, c.c_int, i32p, c.c_int, i32p,
        i32p, i32p, c.POINTER(c.c_int)]
    pp = c.POINTER(c.c_void_p)
    lib.trw_replay_pair_batch.restype = c.c_int
    lib.trw_replay_pair_batch.argtypes = [
        pp, i64p, pp, i64p,           # As/alens, Bs/blens
        i64p, i64p, c.c_int64,        # antis, aoffs, tspace
        i32p, c.c_int64, i32p, i64p, i64p, i64p,   # fwd
        i32p, c.c_int64, i32p, i64p, i64p, i64p,   # rev
        u8p, c.c_int,                 # skip, nitems
        i32p, c.c_int64, i64p, i64p,  # tr, cap, troff, stats
        i32p]                         # rcs


class FagResult(ctypes.Structure):
    """fagdb.c's ``fag_t``: the parse's outputs (see that file)."""
    _fields_ = [
        ("scaf", ctypes.POINTER(ctypes.c_int64)), ("nscaf", ctypes.c_int64),
        ("ctg", ctypes.POINTER(ctypes.c_int64)), ("nctg", ctypes.c_int64),
        ("mask", ctypes.POINTER(ctypes.c_int64)), ("nmask", ctypes.c_int64),
        ("bps", ctypes.POINTER(ctypes.c_uint8)), ("nbps", ctypes.c_int64),
        ("counts", ctypes.c_int64 * 4),
        ("maxctg", ctypes.c_int64),
        ("saw_upper", ctypes.c_int64),
        ("cap_scaf", ctypes.c_int64), ("cap_ctg", ctypes.c_int64),
        ("cap_mask", ctypes.c_int64), ("cap_bps", ctypes.c_int64),
    ]


def get_fagdb():
    """ctypes handle to the fagdb library (FASTA to GDB), or None."""
    return _load("fagdb", _declare_fagdb)


def _declare_fagdb(lib):
    c = ctypes
    res = c.POINTER(FagResult)
    lib.fag_new.restype = res
    lib.fag_new.argtypes = []
    lib.fag_free.restype = None
    lib.fag_free.argtypes = [res]
    lib.fag_parse.restype = c.c_int
    lib.fag_parse.argtypes = [res, c.c_char_p, c.c_int64, c.c_int64]
