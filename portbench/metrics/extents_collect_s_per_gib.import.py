"""Content route: host seconds of the program's ``extents.collect``
spans (``hash_extents``' readback of every chunk digest), per GiB of
file."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("extents.collect",))
    return None if s is None else per_gib(ctx, s, "file_bytes")
