"""Seconds a job copying host GIX tables to the card (the program's span
``devpipe.upload``, which waits for the copies)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.upload")
