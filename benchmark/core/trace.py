"""What a traced run (``--trace 1``) records, from the benchmark's side.

- ``Recorder``: every ``fastga_tpu_torch.utils.prof`` span (the program's
  own, with ``prof.ENABLED``) and the benchmark's spans around module
  attributes the command line calls (``cli._common.resolve_genome``,
  ``models.aligner.align_genomes``) and around each job, each with its
  start, end and the names of the spans open around it.
- ``KernelBounds``: wrappers, declared by the roofline metrics' own
  files, around the program's kernel entries (today
  ``ops.wave_kernels.wave_chunk`` and ``ops.device_pipeline.fused_scan``)
  that add each launch's least time from its arguments and results, on
  the card, without a read back.
- ``summarize``: from a ``torch.profiler`` run over the window (CUDA
  activity only), device time by kernel, the union of device activity,
  the device operations that took most time and the idle time by what the
  host was doing.

Nothing of the program is edited: each wrapper is put in place of a
module attribute for the window and taken out after it.
"""

from __future__ import annotations

import functools
import inspect
import re
import time
from collections import defaultdict
from contextlib import contextmanager

# host span names of the benchmark's own wrappers
JOB = "job"
RESOLVE = "cli.resolve_genome"
ALIGN = "aligner.align_genomes"


class Recorder:
    def __init__(self):
        self.spans = []          # (name, t0, t1, names open around it)
        self._stack = []
        self._undo = []

    @contextmanager
    def span(self, name):
        outer = tuple(self._stack)
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self._stack.pop()
            self.spans.append((name, t0, t1, outer))

    def _patch(self, mod, attr, new):
        self._undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, new)

    def install(self):
        """Record the program's spans and wrap the command line's calls."""
        from fastga_tpu_torch.cli import _common
        from fastga_tpu_torch.models import aligner
        from fastga_tpu_torch.utils import prof
        orig_span = prof.span
        rec = self

        @contextmanager
        def span(name, device=None):
            with rec.span(name), orig_span(name, device=device):
                yield

        def timed(name, fn):
            def w(*a, **k):
                with rec.span(name):
                    return fn(*a, **k)
            return w

        self._patch(prof, "span", span)
        self._patch(prof, "ENABLED", True)
        self._patch(_common, "resolve_genome",
                    timed(RESOLVE, _common.resolve_genome))
        self._patch(aligner, "align_genomes",
                    timed(ALIGN, aligner.align_genomes))

    def remove(self):
        while self._undo:
            mod, attr, old = self._undo.pop()
            setattr(mod, attr, old)

    def total(self, names):
        """Seconds under spans of ``names``, a span nested in another of
        them counted once."""
        names = set(names)
        return sum(t1 - t0 for n, t0, t1, outer in self.spans
                   if n in names and not names.intersection(outer))

    def count(self, name):
        return sum(1 for s in self.spans if s[0] == name)


class KernelBounds:
    """Least seconds of the launches of each kernel that a per-layer
    metric's file declares (``metrics/<name>.py`` with ``KERNEL``,
    ``WRAPS``: (module, attribute) pairs to wrap, and
    ``least_s(arguments, result)``: a launch's least seconds from its
    bound arguments by name and its result, a number or a 0-d tensor on
    the card, summed without a read back)."""

    def __init__(self, metrics):
        self.kernels = {n: m for n, m in metrics.items()
                        if hasattr(m, "WRAPS")}
        self.least = {}
        self._acc = {}
        self._undo = []

    def install(self):
        import importlib
        for name, m in self.kernels.items():
            for modname, attr in m.WRAPS:
                mod = importlib.import_module(modname)
                real = getattr(mod, attr)
                self._undo.append((mod, attr, real))
                setattr(mod, attr, self._wrap(name, real, m.least_s))

    def _wrap(self, name, real, least_s):
        sig = inspect.signature(real)
        acc = self._acc

        @functools.wraps(real)
        def w(*a, **k):
            out = real(*a, **k)
            call = sig.bind(*a, **k)
            call.apply_defaults()
            b = least_s(call.arguments, out)
            acc[name] = acc[name] + b if name in acc else b
            return out
        return w

    def remove(self):
        while self._undo:
            mod, attr, old = self._undo.pop()
            setattr(mod, attr, old)
        self.least = {k: float(v) for k, v in self._acc.items()}

    def patterns(self):
        """{metric: compiled KERNEL pattern} of the profiler's names."""
        return {n: re.compile(m.KERNEL) for n, m in self.kernels.items()}


def _dev_us(e):
    if hasattr(e, "self_device_time_total"):
        return e.self_device_time_total or 0
    return getattr(e, "self_cuda_time_total", 0) or 0


def summarize(prof, host0_s, window, rec, kernels, bin_s=1e-3):
    """Device numbers of a traced window.  ``prof``: the finished
    torch.profiler run; ``host0_s``: the host clock (perf_counter) at which
    the first device event of the run (a marker launched after a
    synchronize) started; ``window``: (start, end) on the host clock;
    ``kernels``: {metric: pattern of its kernel's names}.
    Returns a dict: busy_s, kernel_s {metric: device s}, device_ops (top
    10 [name, s]) and idle_gaps (top 10 [host activity, s])."""
    import numpy as np
    evs = [e for e in prof.events() if _dev_us(e) > 0]
    if not evs:
        return None
    starts = np.array([e.time_range.start for e in evs], np.float64)
    ends = np.array([e.time_range.end for e in evs], np.float64)
    t_marker = starts.min()
    # device intervals on the host clock
    s = (starts - t_marker) * 1e-6 + host0_s
    t = (ends - t_marker) * 1e-6 + host0_s
    w0, w1 = window
    s, t = np.clip(s, w0, w1), np.clip(t, w0, w1)
    order = np.argsort(s)
    s, t = s[order], t[order]
    reach = np.maximum.accumulate(t)
    new = np.concatenate([[True], s[1:] > reach[:-1]])
    first = np.nonzero(new)[0]
    g_s = s[first]
    g_t = np.maximum.reduceat(t, first)
    busy = float((g_t - g_s).sum())
    by_name = defaultdict(float)
    for e in evs:
        by_name[e.name] += _dev_us(e) * 1e-6
    kernel_s = {}
    for k, rx in kernels.items():
        v = sum(sec for n, sec in by_name.items() if rx.search(n))
        if v > 0:
            kernel_s[k] = v
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    # idle time a bin, by the innermost host span open in that bin
    nb = max(1, int(np.ceil((w1 - w0) / bin_s)))
    edges = np.minimum(np.arange(nb + 1) * bin_s, w1 - w0)
    cum = _busy_cum(g_s - w0, g_t - w0, edges)
    idle_bin = np.clip(np.diff(edges) - np.diff(cum), 0.0, None)
    label = np.full(nb, "outside any job", dtype=object)
    depth = np.full(nb, -1)
    for name, h0, h1, outer in rec.spans:
        i0 = int(max(0, np.floor((h0 - w0) / bin_s)))
        i1 = int(min(nb, np.ceil((h1 - w0) / bin_s)))
        if i1 <= i0:
            continue
        d = len(outer)
        sel = slice(i0, i1)
        upd = depth[sel] <= d
        label[sel] = np.where(upd, _label(name), label[sel])
        depth[sel] = np.where(upd, d, depth[sel])
    idle = defaultdict(float)
    for lab, v in zip(label, idle_bin):
        idle[lab] += v
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, kernel_s=kernel_s,
                device_ops=[[n, v] for n, v in ops],
                idle_gaps=[[n, v] for n, v in gaps])


def _busy_cum(b0, b1, edges):
    """Busy length before each edge, for sorted disjoint intervals
    [b0, b1)."""
    import numpy as np
    lens = np.concatenate([[0.0], np.cumsum(b1 - b0)])
    i = np.searchsorted(b0, edges, side="right")     # intervals started
    last0 = np.where(i > 0, b0[np.maximum(i - 1, 0)], 0.0)
    last1 = np.where(i > 0, b1[np.maximum(i - 1, 0)], 0.0)
    part = np.where(i > 0, np.minimum(edges, last1) - last0, 0.0)
    return lens[np.maximum(i - 1, 0)] * (i > 0) + part


def _label(name):
    if name == JOB:
        return "job, outside resolve_genome and align_genomes (writers)"
    return name
