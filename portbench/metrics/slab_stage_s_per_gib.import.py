"""Content route: host seconds of the program's ``cdc.stage`` spans
(each slab's pinned staging and upload enqueue in ``chunk_stream``), per
GiB of file."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("cdc.stage",))
    return None if s is None else per_gib(ctx, s, "file_bytes")
