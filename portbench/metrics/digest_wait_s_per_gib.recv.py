"""Digest pipeline: host seconds of the program's ``digest.wait`` spans
(the host blocked on a batch's digest readback), per GiB of wire."""

from portbench.readers import per_gib, spans_seconds


def read(ctx):
    s = spans_seconds(ctx, ("digest.wait",))
    return None if s is None else per_gib(ctx, s, "wire_bytes")
