"""Per-layer numbers from the program's own span record
(``fastga_tpu_torch.utils.prof``: ``seconds``, ``counters``, ``events``),
which the program keeps while ``prof.ENABLED`` is on: in a traced run,
the measured window and nothing before it.

A program without that record, or whose span never ran in the window,
reads None, so a metric built on it is left out of the result line.
"""

from __future__ import annotations


def _prof():
    from fastga_tpu_torch.utils import prof
    if all(hasattr(prof, f) for f in ("seconds", "counters", "events")):
        return prof
    return None


def _ran(prof, name):
    return any(e[3] == name for e in prof.events())


def span_s(ctx, name):
    """Seconds a job under the program's span ``name``, a span nested in
    another of that name counted once."""
    prof = _prof()
    if prof is None or not ctx.jobs or not _ran(prof, name):
        return None
    return prof.seconds(name) / ctx.jobs


def rate(ctx, counter, name, scale=1.0):
    """The program's ``counter`` over the seconds under its span ``name``,
    divided by ``scale``."""
    prof = _prof()
    if prof is None or not _ran(prof, name):
        return None
    n = prof.counters().get(counter)
    s = prof.seconds(name)
    if n is None or s <= 0:
        return None
    return n / s / scale
