"""Seconds a job in the kmer-panel route's scans (the program's span
``devpipe.panel_scan``: one panel's candidate scan and sort of both
genomes, a rescan past the panel's buffer included; it waits for the
card)."""

from core import record


def read(ctx):
    return record.span_s(ctx, "devpipe.panel_scan")
