"""Content route: host seconds of the harness's range around each
``content_address`` call outside the program's ``cdc.*`` spans, per GiB
of file: the slab staging and upload, ``hash_extents``' host pack and
its B1 launches, and the host Merkle fold, which no span of the program
splits yet."""

from portbench.readers import per_gib, spans_seconds
from portbench.trace import CALL_SPAN


def read(ctx):
    cdc = spans_seconds(ctx, ("cdc.dispatch", "cdc.collect", "cdc.greedy"))
    if cdc is None or not ctx.trace.span_count(CALL_SPAN):
        return None
    return per_gib(ctx, ctx.trace.span_seconds(CALL_SPAN) - cdc,
                   "file_bytes")
