"""Digest pipeline: the 95th percentile, over the window's batches, of
the milliseconds from a batch's dispatch to its digests in hand: the end
of the k-th ``digest.collect`` range less the start of the k-th
``digest.dispatch`` range of one session (the pipeline delivers its
batches in dispatch order), paired inside each ``portbench.session``
range.  A session flushes every batch it dispatched, so where a
session's counts of the two differ the pairing is unsound and the
metric is left out."""

import bisect

import numpy as np

from portbench.trace import SESSION_SPAN


def read(ctx):
    if ctx.trace is None:
        return None
    host = sorted(ctx.trace.host)
    sessions = [(s, t) for s, t, n in host if n == SESSION_SPAN]
    starts = [s for s, _ in sessions]
    dispatch = [[] for _ in sessions]
    collect = [[] for _ in sessions]
    for s, t, n in host:
        if n != "digest.dispatch" and n != "digest.collect":
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i < 0 or t > sessions[i][1]:
            continue
        if n == "digest.dispatch":
            dispatch[i].append(s)
        else:
            collect[i].append(t)
    out = []
    for starts_k, ends_k in zip(dispatch, collect):
        if len(starts_k) != len(ends_k):
            return None
        out += [(t - s) / 1e3 for s, t in zip(starts_k, sorted(ends_k))]
    return float(np.percentile(out, 95)) if out else None
