"""Seconds a job in the whole-table seed merge and expansion (the
program's span ``devpipe.merge``: ``merge_seeds`` over the two tables of
the single-shot or tables route; it waits for the card)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.merge")
