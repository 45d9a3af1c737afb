"""Seconds a job the host waits for the wave results (span
``wave.collect_fetch``)."""


def read(ctx):
    return ctx.span_s("wave.collect_fetch")
