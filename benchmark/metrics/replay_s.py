"""Seconds a job in host trace replay (spans ``batch.replay``,
``batch.replay_fwd`` and ``batch.replay_rev``, a nested one counted
once)."""


def read(ctx):
    return ctx.span_s("batch.replay", "batch.replay_fwd", "batch.replay_rev")
