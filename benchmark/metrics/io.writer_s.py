"""Seconds a job in the output writers (the program's span ``io.write``:
the .1aln writer from skeleton to close, or the PAF or PSL lines)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "io.write")
