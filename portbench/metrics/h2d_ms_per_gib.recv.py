"""Batch staging: device milliseconds of the profiler's host-to-device
copies, per GiB of wire."""

from portbench.readers import per_gib


def read(ctx):
    if ctx.trace is None:
        return None
    s = ctx.trace.device_seconds(lambda base, full: "HtoD" in full)
    return per_gib(ctx, s * 1e3, "wire_bytes") if s > 0 else None
