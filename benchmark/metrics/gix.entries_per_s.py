"""Millions of GIX entries the host builds a second: the program's counter
``gix.entries`` (each table's rows) over its span ``gix.build``."""

from core import record


def read(ctx):
    return record.rate(ctx, "gix.entries", "gix.build", 1e6)
