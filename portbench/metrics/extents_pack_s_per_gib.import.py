"""Content route: host seconds of the program's ``extents.pack`` spans
(``hash_extents``' host pack of a pipeline chunk's ragged extents into
padded pinned rows), per GiB of file."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("extents.pack",))
    return None if s is None else per_gib(ctx, s, "file_bytes")
