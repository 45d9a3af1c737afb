"""Millions of table rows the single-shot route's whole-table merge takes a
second: the program's counter ``devpipe.merge_rows`` (the rows of the
driver table and genome 2's table, padding included, once a job) over its
span ``devpipe.merge``."""

from core import record


def read(ctx):
    return record.rate(ctx, "devpipe.merge_rows", "devpipe.merge", 1e6)
