"""Digest pipeline: host seconds of the program's ``digest.submit``
spans (one a run of the C change loop: each payload's submit and the
delivery of the digests of the batches that the submits push out of
flight) outside the ``digest.dispatch`` / ``digest.collect`` ranges
that nest in them, per million rows of the window's finished
sessions."""

import bisect


def _clipped(ctx, name):
    t0, t1 = ctx.trace.t0, ctx.trace.t1
    return sorted((max(s, t0), min(t, t1)) for s, t, n in ctx.trace.host
                  if n == name and t > t0 and s < t1)


def read(ctx):
    rows = ctx.counters.get("rows", 0)
    if ctx.trace is None or not rows:
        return None
    submits = _clipped(ctx, "digest.submit")
    if not submits:
        return None
    starts = [s for s, _ in submits]
    inner = 0.0
    for name in ("digest.dispatch", "digest.collect"):
        for s, t in _clipped(ctx, name):
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and t <= submits[i][1]:
                inner += t - s
    total = sum(t - s for s, t in submits)
    return (total - inner) / 1e6 / (rows / 1e6)
