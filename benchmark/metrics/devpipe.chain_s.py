"""Seconds a job in the chain sweep over the merge's seeds (the program's
span ``devpipe.chain``: the seed sort and the sweep, monolithic or in
A-contig panels, and the tubes' copy to the host)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.chain")
