"""Content route: host seconds of the program's ``merkle.fold`` spans
(``root_host``'s host Merkle fold of the chunk digests), per GiB of
file."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("merkle.fold",))
    return None if s is None else per_gib(ctx, s, "file_bytes")
