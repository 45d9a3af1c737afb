"""Seconds a job in the host's redundancy elimination (span
``aligner.dedup``)."""


def read(ctx):
    return ctx.span_s("aligner.dedup")
