"""Seconds a job building the wave engine's sequence pool (span
``aligner.pool_build``)."""


def read(ctx):
    return ctx.span_s("aligner.pool_build")
