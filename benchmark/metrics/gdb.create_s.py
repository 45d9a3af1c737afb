"""Seconds a job in the FASTA parse and GDB build (the program's span
``gdb.create``, inside ``cli.resolve_genome``), for both genomes."""

from core import record


def read(ctx):
    return record.span_s(ctx, "gdb.create")
