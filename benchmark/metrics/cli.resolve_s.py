"""Seconds a job in ``cli._common.resolve_genome`` (the benchmark's
wrapper): FASTA parse, GDB build and, under -M, the host's masked GIX
build, for both genomes."""


def read(ctx):
    return ctx.span_s("cli.resolve_genome")
