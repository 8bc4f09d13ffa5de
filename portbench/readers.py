"""What the per-layer metrics' readers share: GiB, roofline shares and
the device's idle share.  A reader returns None where its source did not
fire; the harness then leaves the metric out of the line."""

from __future__ import annotations

import dataclasses

from portbench.work import peaks

GIB = float(1 << 30)


@dataclasses.dataclass
class Context:
    """What a reader reads: the window's trace (None when the run was not
    traced) and the driver's counters."""

    trace: object
    counters: dict


def per_gib(ctx: Context, value: float, key: str):
    nbytes = ctx.counters.get(key, 0)
    return value / (nbytes / GIB) if nbytes else None


def roofline(ctx: Context, kernel_prefix: str, work_key: str):
    """100 x the least time the card could take for the work over the
    device time of the kernels named ``kernel_prefix*``."""
    if ctx.trace is None or work_key not in ctx.counters:
        return None
    seconds = ctx.trace.kernel_seconds(kernel_prefix)
    if seconds <= 0:
        return None
    work = ctx.counters[work_key]
    bound = peaks.bound_s(work["bytes"], work["ops"])
    return 100.0 * bound / seconds if bound > 0 else None


def device_idle(ctx: Context):
    """100 x the share of the window in which no kernel, copy or set ran
    on the card."""
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def spans_seconds(ctx: Context, names) -> float | None:
    """Host seconds of the program's spans ``names``, None when none
    of them fired."""
    if ctx.trace is None or not any(ctx.trace.span_count(n) for n in names):
        return None
    return sum(ctx.trace.span_seconds(n) for n in names)
