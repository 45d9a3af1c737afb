"""Seconds a job in the host's GIX build (the program's span
``gix.build``: entries, sort, LCP and prefix index), for both genomes;
under -M the masked tables' build."""

from core import record


def read(ctx):
    return record.span_s(ctx, "gix.build")
