"""Session parse: host seconds of the program's ``decoder.change_run``
spans (one a run of the C change loop: the decode of each row's fields,
the ``Change`` it builds, the handler's call and its ack), per million
rows of the window's finished sessions."""

from portbench.readers import spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("decoder.change_run",))
    rows = ctx.counters.get("rows", 0)
    return None if s is None or not rows else s / (rows / 1e6)
