"""Seconds a job packing genomes' bases and contig tables for the card (the
program's span ``devpipe.prep``: ``_prep_genome`` on the single-shot
pair route, inside ``devpipe.gix1`` and ``devpipe.gix2``, and on the
kmer-panel route; it waits for the copies)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.prep")
