"""Session parse: host seconds of the program's ``decoder.blob`` spans
(the join of a blob's parts and its submit) outside the digest
pipeline's ``digest.dispatch`` / ``digest.collect`` ranges that nest in
them when a blob fills a batch, per GiB of wire."""

import bisect

from portbench.readers import per_gib


def _clipped(ctx, name):
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    return sorted((max(s, t0), min(t, t1)) for s, t, n in ctx.trace.host
                  if n == name and t > t0 and s < t1)


def read(ctx):
    if ctx.trace is None:
        return None
    blobs = _clipped(ctx, "decoder.blob")
    if not blobs:
        return None
    starts = [s for s, _ in blobs]
    inner = 0.0
    for name in ("digest.dispatch", "digest.collect"):
        for s, t in _clipped(ctx, name):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and t <= blobs[i][1]:
                inner += t - s
    total = sum(t - s for s, t in blobs)
    return per_gib(ctx, (total - inner) / 1e6, "wire_bytes")
