"""Seconds a job in the kmer-panel route's merges (the program's span
``devpipe.panel_merge``: one panel's seed merge and its append to the
global seed buffer; it waits for the card)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.panel_merge")
