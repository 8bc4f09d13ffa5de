"""Batch staging: host seconds of the program's ``digest.stage`` spans
(each bucket's pinned allocation, zero fill and per-item copy), per GiB
of wire."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("digest.stage",))
    return None if s is None else per_gib(ctx, s, "wire_bytes")
