"""Fused multi-channel scans: the CUDA kernel (csrc/fused_scan.cu) beside
its plain PyTorch version.

Port of fastga_tpu/ops/scan_pallas.py (fused_scan, semantics of its oracle
fused_scan_ref).  ``fused_scan(values, spec, flags, reverse)`` runs K
inclusive scans over int32 [M] streams: spec[c] = (op, flag_id | None) with
op in {sum, max, min, last}; a channel with a flag id restarts at every row
where that flag stream is non-zero (inclusive of the row); ``last``
transports the value at the most recent flagged row (0 before the first);
``reverse=True`` is the suffix scan.  Sums wrap in int32.  Any M >= 0.
One more op, ``sum64``, is an int64 sum (values and result int64 [M], no
wrap: the chain sweep's coverage sum past 2^31); it goes alone in its call.

The wrapper runs the plain version for CPU tensors and launches the kernel
for CUDA tensors, at every size; ``LAUNCHES["fused_scan"]`` counts launches.
"""

from __future__ import annotations

import torch

from .cuda_build import (LAUNCHES, build_kernels, check, int_array, ptr,
                         ptr_array, raise_on, stream)
from .wave_kernels import _i32

M32 = 0xFFFFFFFF

OPS = {"sum": 0, "max": 1, "min": 2, "last": 3, "sum64": 0}

MAX_CHANNELS = 16
MAX_FLAGS = 4


def _check_spec(spec, nch, nflags):
    if len(spec) != nch or not 1 <= nch <= MAX_CHANNELS:
        raise ValueError(f"fused_scan: {nch} channels with {len(spec)} "
                         f"specs (1 to {MAX_CHANNELS} channels)")
    if nflags > MAX_FLAGS:
        raise ValueError(f"fused_scan: at most {MAX_FLAGS} flag streams")
    for op, fid in spec:
        if op not in OPS:
            raise ValueError(f"fused_scan: unknown op {op!r}")
        if fid is not None and not 0 <= fid < nflags:
            raise ValueError(f"fused_scan: flag id {fid} of {nflags}")
    if nch > 1 and any(op == "sum64" for op, _ in spec):
        raise ValueError("fused_scan: a sum64 channel goes alone in its call")


def fused_scan_plain(values, spec, flags=(), reverse=False):
    """The vectorised formulation (the JAX package's off-TPU scans): int64
    offset-trick cummax for max and min (min as a negated max), the
    difference of prefix sums for sum and sum64 (exact in int64), the
    tagged fill for last; reverse by flipping."""
    _check_spec(spec, len(values), len(flags))
    vals = [v.to(torch.int64) for v in values]
    fl = [f != 0 for f in flags]
    if reverse:
        vals = [v.flip(0) for v in vals]
        fl = [f.flip(0) for f in fl]
    outs = []
    for x, (op, fid) in zip(vals, spec):
        f = fl[fid] if fid is not None else None
        if op == "last":
            if f is None:
                out = torch.zeros_like(x)
            else:
                m = torch.cumsum(f.to(torch.int64), 0) << 32
                s = torch.where(f, m | (x & M32), m)
                out = torch.cummax(s, 0).values & M32
        elif op in ("sum", "sum64"):
            out = torch.cumsum(x, 0)
            if f is not None:
                idx = torch.arange(len(x), device=x.device)
                last = torch.cummax(torch.where(f, idx, -1), 0).values
                base = (out - x)[last.clamp(min=0)]
                out = out - torch.where(last >= 0, base, 0)
        else:
            y = x if op == "max" else -x
            if f is None:
                r = torch.cummax(y, 0).values
            else:
                gid = torch.cumsum(f.to(torch.int64), 0) << 33
                r = torch.cummax(y + gid, 0).values - gid
            out = r if op == "max" else -r
        outs.append(out if op == "sum64" else _i32(out))
    if reverse:
        outs = [o.flip(0) for o in outs]
    return tuple(outs)


def fused_scan(values, spec, flags=(), reverse=False):
    """K inclusive scans in one pass (see the module docstring); returns a
    tuple of [M] tensors, int32 (int64 for sum64)."""
    spec = tuple((op, fid) for op, fid in spec)
    _check_spec(spec, len(values), len(flags))
    wide = spec[0][0] == "sum64"
    dt = torch.int64 if wide else torch.int32
    values = [v.to(dt) for v in values]
    flags = [f.to(torch.int32) for f in flags]
    if values[0].device.type == "cpu":
        return fused_scan_plain(values, spec, flags, reverse)
    K, M = len(values), values[0].shape[0]
    dev = values[0].device
    for i, v in enumerate(values):
        check(v, dt, (M,), f"fused_scan value {i}")
    for i, f in enumerate(flags):
        check(f, torch.int32, (M,), f"fused_scan flag {i}")
    # rows padded to a multiple of 4, so every output row is 16-byte aligned
    out = torch.empty((K, -(-M // 4) * 4), dtype=dt, device=dev)[:, :M]
    if M == 0:
        return tuple(out)
    lib = build_kernels()["fused_scan"]
    # look-back scratch for the most tiles the kernel may cut M into: the
    # ticket counter, then a word a tile and channel (two for int64), zero
    cap = -(-M // lib.fused_scan_tile_min())
    words = torch.zeros(1 + cap * K * (2 if wide else 1), dtype=torch.int64,
                        device=dev)
    vp, _k1 = ptr_array(values)
    op_, _k2 = ptr_array(list(out))
    fp, _k3 = ptr_array(flags)
    opc, _k4 = int_array([OPS[op] for op, _ in spec])
    fic, _k5 = int_array([-1 if fid is None else fid for _, fid in spec])
    rc = lib.fused_scan_launch(vp, op_, fp, opc, fic, K, len(flags), M,
                               int(bool(reverse)), int(wide), ptr(words),
                               cap, stream())
    raise_on(rc, "fused_scan")
    LAUNCHES["fused_scan"] += 1
    return tuple(out)
