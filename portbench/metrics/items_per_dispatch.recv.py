"""Digest pipeline: digests delivered over ``DigestPipeline.dispatches``
in the window's sessions (the pipeline's own attributes)."""


def read(ctx):
    n = ctx.counters.get("dispatches", 0)
    return ctx.counters["digests"] / n if n else None
