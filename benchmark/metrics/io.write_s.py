"""Seconds a job outside ``resolve_genome`` and ``align_genomes``: the
output writers (the .1aln or PAF file), which have no span of their own."""


def read(ctx):
    job = ctx.span_s("job")
    if job is None:
        return None
    return job - (ctx.span_s("cli.resolve_genome") or 0.0) \
        - (ctx.span_s("aligner.align_genomes") or 0.0)
