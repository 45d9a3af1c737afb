"""Seconds a job building or uploading the two seed tables (the program's
spans ``devpipe.gix1`` and ``devpipe.gix2``, each counted once: genome 1's
driver or full table and genome 2's full table on the single-shot route,
the uploads of given tables on the tables route; they wait for the
card)."""


def read(ctx):
    return ctx.span_s("devpipe.gix1", "devpipe.gix2")
