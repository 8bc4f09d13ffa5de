"""CDC host work: host milliseconds of the program's ``cdc.collect`` and
``cdc.greedy`` spans (the candidate readback and the greedy cut pass),
per GiB of file."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("cdc.collect", "cdc.greedy"))
    return None if s is None else per_gib(ctx, s * 1e3, "file_bytes")
