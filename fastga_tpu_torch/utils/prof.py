"""Host spans and counters of the port (port of fastga_tpu/utils/prof.py).

Usage:  with prof.span("wave.pair_dispatch"): ...   /  prof.count(name, n)
Off by default: set ``prof.ENABLED = True``.  Each closed span is kept as
(id, parent_id, job_id, name, t0, t1) (``events()``), t0 and t1 on
``time.perf_counter``'s clock: the parent is the innermost span open on
the same thread, the job the one ``job()`` opened.  ``seconds(*names)``
sums that record, ``counters()`` has the totals of ``count``, and
``report()`` reads both: {name: (seconds, calls)} of each span, (0.0,
total) of each counter whose name no span has (``gix.entries`` has one).
Inside a
``trace(dir)`` window each span also opens
``torch.profiler.record_function(name)``, so the Chrome trace it writes
shows the host spans beside the kernels on the profiler's one clock.

Call spans as ``prof.span(...)``, looked up on this module, never bound
by name: a wrapper put in its place (the benchmark's traced run puts one)
then sees every span.  Span names are those fastga_tpu's bench reads
(bench.py PHASES), and the host stages' own (``cli.resolve_genome``,
``gix.*``, ``io.write``, ...).
"""

import itertools
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

ENABLED = False
_num = defaultdict(int)      # counter totals
_events = []                 # (id, parent_id, job_id, name, t0, t1)
_ids = itertools.count(1)
_job_ids = itertools.count(1)
_job = None                  # id of the job that job() has open
_open = threading.local()    # .ids: the spans open on this thread
_record_function = None      # torch.profiler.record_function in trace()


@contextmanager
def span(name, device=None):
    """Time the enclosed block under ``name``.  With a CUDA ``device`` the
    span waits for the device's queued work before it closes, so the time
    of asynchronous kernels lands in the span that launched them."""
    if not ENABLED:
        yield
        return
    sid = next(_ids)
    stack = _stack()
    parent = stack[-1] if stack else None
    stack.append(sid)
    rf = _record_function(name) if _record_function else nullcontext()
    t0 = time.perf_counter()
    try:
        with rf:
            yield
            if device is not None and _is_cuda(device):
                import torch
                torch.cuda.synchronize(device)
    finally:
        t1 = time.perf_counter()
        stack.pop()
        _events.append((sid, parent, _job, name, t0, t1))


def _stack():
    if not hasattr(_open, "ids"):
        _open.ids = []
    return _open.ids


def _is_cuda(device):
    return getattr(device, "type", str(device).split(":")[0]) == "cuda"


@contextmanager
def job():
    """The root span ``fastga.job`` of one job, under a new job id that
    every span closed inside it carries."""
    global _job
    if not ENABLED:
        yield
        return
    outer, _job = _job, next(_job_ids)
    try:
        with span("fastga.job"):
            yield
    finally:
        _job = outer


def count(name, n=1):
    if ENABLED:
        _num[name] += n


def counters():
    """{name: total} of ``count`` alone."""
    return dict(_num)


def report():
    """{name: (seconds, calls)} of the span record, and (0.0, total) of
    each counter whose name no span has."""
    spans = defaultdict(list)
    for e in _events:
        spans[e[3]].append(e[5] - e[4])
    rep = {k: (0.0, n) for k, n in _num.items()}
    rep.update((k, (round(sum(v), 3), len(v))) for k, v in spans.items())
    return dict(sorted(rep.items()))


def events():
    """The record of closed spans, oldest first: (id, parent_id, job_id,
    name, t0, t1)."""
    return list(_events)


def seconds(*names):
    """Seconds in the record under spans of ``names``, a span nested in
    another of them counted once."""
    names = set(names)
    by_id = {e[0]: e for e in _events}

    def inside(e):
        p = by_id.get(e[1])
        while p is not None:
            if p[3] in names:
                return True
            p = by_id.get(p[1])
        return False
    return sum(e[5] - e[4] for e in _events
               if e[3] in names and not inside(e))


def reset():
    _num.clear()
    _events.clear()


@contextmanager
def trace(out_dir):
    """torch.profiler trace (CPU + CUDA activities) of the enclosed work,
    written as a Chrome trace under ``out_dir``; yields the profiler.
    With ``ENABLED`` on, each span inside appears as a record_function
    range."""
    import os

    import torch
    global _record_function
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as p:
        _record_function = torch.profiler.record_function
        try:
            yield p
        finally:
            _record_function = None
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
