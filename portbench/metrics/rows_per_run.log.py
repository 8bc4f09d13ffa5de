"""Session parse: rows of the window's finished sessions over the
program's ``decoder.change_run`` spans, one a run of the C change loop."""


def read(ctx):
    runs = ctx.trace.span_count("decoder.change_run") if ctx.trace else 0
    return ctx.counters["rows"] / runs if runs else None
