"""Seconds a job sorting the host GIX table's entries (the program's span
``gix.sort``: the tie-key pack, the stable argsorts or the lexsort, and
the reorder gathers)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "gix.sort")
