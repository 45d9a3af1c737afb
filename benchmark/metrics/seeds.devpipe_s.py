"""Seconds a job in the device seed pipeline (span ``aligner.devpipe``,
which waits for the card)."""


def read(ctx):
    return ctx.span_s("aligner.devpipe")
