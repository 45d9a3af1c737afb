"""Records the output writers emit a second: the program's counter
``io.records`` over its span ``io.write``."""

from core import record


def read(ctx):
    return record.rate(ctx, "io.records", "io.write")
