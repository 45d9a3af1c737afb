"""Tiny accumulating profiler (port of fastga_tpu/utils/prof.py).

Usage:  with prof.span("wave.pair_dispatch"): ...   /  prof.count(name, n)
``report()`` returns {name: (seconds, calls)}.  Off by default: set
``prof.ENABLED = True``; the spans then also mark NVTX ranges on the card,
so a torch.profiler trace (``trace(dir)``) shows them on the timeline.
Span names are those fastga_tpu's bench reads (bench.py PHASES).
"""

import time
from collections import defaultdict
from contextlib import contextmanager

ENABLED = False
_acc = defaultdict(float)
_cnt = defaultdict(int)


def _nvtx():
    try:
        import torch
        if torch.cuda.is_available():
            return torch.cuda.nvtx
    except ImportError:
        pass
    return None


@contextmanager
def span(name, device=None):
    """Time the enclosed block under ``name``.  With a CUDA ``device`` the
    span waits for the device's queued work before it closes, so the time
    of asynchronous kernels lands in the span that launched them."""
    if not ENABLED:
        yield
        return
    nv = _nvtx()
    if nv is not None:
        nv.range_push(name)
    t0 = time.perf_counter()
    try:
        yield
        if device is not None and _is_cuda(device):
            import torch
            torch.cuda.synchronize(device)
    finally:
        _acc[name] += time.perf_counter() - t0
        _cnt[name] += 1
        if nv is not None:
            nv.range_pop()


def _is_cuda(device):
    return getattr(device, "type", str(device).split(":")[0]) == "cuda"


def count(name, n=1):
    if ENABLED:
        _cnt[name] += n


def report():
    return {k: (round(_acc[k], 3), _cnt[k])
            for k in sorted(set(_acc) | set(_cnt))}


def reset():
    _acc.clear()
    _cnt.clear()


@contextmanager
def trace(out_dir):
    """torch.profiler trace (CPU + CUDA activities) of the enclosed work,
    written as a Chrome trace under ``out_dir``; yields the profiler."""
    import os

    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as p:
        yield p
    p.export_chrome_trace(os.path.join(out_dir, "trace.json"))


class PhaseTimer:
    """Reference-style per-phase resource reports (StartTime/TimeTo,
    gene_core.h:178-180): 'u s w %cpu MB' printed after each phase under
    -v / appended to the -L log."""

    def __init__(self, out=None):
        import resource
        self._res = resource
        self.out = out
        self._mark()

    def _mark(self):
        r = self._res.getrusage(self._res.RUSAGE_SELF)
        self._u, self._s = r.ru_utime, r.ru_stime
        self._w = time.perf_counter()

    def phase(self, label=""):
        """Emit resources consumed since the last mark and re-mark."""
        r = self._res.getrusage(self._res.RUSAGE_SELF)
        du = r.ru_utime - self._u
        ds = r.ru_stime - self._s
        dw = time.perf_counter() - self._w
        pct = 100.0 * (du + ds) / dw if dw > 0 else 0.0
        mb = r.ru_maxrss // 1024
        line = (f"\n  Resources for {label or 'phase'}:  {du:.3f}u  "
                f"{ds:.3f}s  {dw:.3f}w  {pct:.1f}%  {mb}MB\n")
        for o in (self.out if isinstance(self.out, (list, tuple))
                  else [self.out]):
            if o is not None:
                o.write(line)
        self._mark()
        return line
