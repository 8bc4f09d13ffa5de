"""Session parse: host seconds of the traced window outside the digest
pipeline's dispatch and collect spans (``digest.dispatch``,
``digest.collect``: the profiler ranges the port opens with its
``device.dispatch`` / ``device.deliver`` spans), per GiB of wire.

The harness's own recording inside the sessions is counted in it: a
clock read before each write, a tuple for each digest and each change
kept, one ``gc.freeze`` a session.  It is the same work in every run of
a cell, and small beside the parse (a clock read a 64 KiB write)."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    inside = spans_seconds(ctx, ("digest.dispatch", "digest.collect"))
    if inside is None:
        return None
    return per_gib(ctx, ctx.trace.window_s - inside, "wire_bytes")
