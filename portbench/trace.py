"""The traced run: a ``torch.profiler`` capture of the window and its
reduction to device time, program spans and the breakdown.

The capture records the CPU side (torch operators and the
``record_function`` ranges that the program's spans open while a
profiler runs: ``digest.dispatch``, ``digest.collect``, ``cdc.*``) and
the CUDA side (kernels, copies, sets).  The harness opens its own ranges
around the window (:data:`WINDOW_SPAN`) and around each call into the
system under test.  The program's obs gate stays off: it would cost the
traced window 1.2-1.5x and is not what a user runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

# the harness's own ranges: the window, each session, each import call
WINDOW_SPAN = "portbench.window"
SESSION_SPAN = "portbench.session"
CALL_SPAN = "portbench.content_address"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
TOP = 10


@contextlib.contextmanager
def capture():
    """Profile the block; yields a dict that holds the :class:`Trace`
    under ``"trace"`` once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(prefix="portbench-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            out["trace"] = Trace(json.load(f)["traceEvents"])
    finally:
        os.unlink(path)


def kernel_base(name: str) -> str:
    """A device event's function name without its signature, return type,
    namespaces or template arguments (``Memcpy HtoD`` for a copy)."""
    name = name.replace("(anonymous namespace)", "")
    if name.startswith(("Memcpy", "Memset")):
        return name.split("(")[0].strip()
    depth, bare = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            bare.append(ch)
    head = "".join(bare).split("(")[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """Chrome trace events of one window, reduced.  Times are seconds."""

    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        wins = [e for e in xs if e.get("name") == WINDOW_SPAN
                and e.get("cat") == "user_annotation"]
        if not wins:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} range")
        w = wins[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.host_tid = (w.get("pid"), w.get("tid"))
        self.device = []  # (base name, full name, start, end) in us
        self.host = []  # (start, end, name) on the window's thread
        for e in xs:
            cat = e.get("cat")
            s = float(e["ts"])
            t = s + float(e["dur"])
            if cat in DEVICE_CATS:
                s, t = max(s, self.t0), min(t, self.t1)
                if t > s:
                    self.device.append((kernel_base(e["name"]), e["name"],
                                        s, t))
            elif (cat in HOST_CATS and (e.get("pid"), e.get("tid"))
                  == self.host_tid and e is not w):
                self.host.append((s, t, e["name"]))
        self.busy = _merge([(s, t) for _, _, s, t in self.device])
        self.busy_s = sum(t - s for s, t in self.busy) / 1e6

    def device_seconds(self, match) -> float:
        """Device seconds of the events whose base name ``match(base,
        full)`` accepts."""
        return sum(t - s for b, f, s, t in self.device if match(b, f)) / 1e6

    def kernel_seconds(self, prefix: str) -> float:
        return self.device_seconds(lambda b, f: b.startswith(prefix))

    def span_seconds(self, name: str) -> float:
        """Host seconds of the window thread's ranges called ``name``."""
        return sum(min(t, self.t1) - max(s, self.t0)
                   for s, t, n in self.host
                   if n == name and t > self.t0 and s < self.t1) / 1e6

    def span_count(self, name: str) -> int:
        return sum(1 for _, _, n in self.host if n == name)

    def device_ops(self) -> list:
        """The device operations that took most time: [[name, s], ...]."""
        by: dict[str, float] = {}
        for b, _, s, t in self.device:
            by[b] = by.get(b, 0.0) + (t - s) / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]

    def idle_gaps(self) -> list:
        """Idle device time by what the window's thread was inside at the
        middle of each gap (the innermost torch operator or range; the
        harness's own range where it was in plain Python):
        [[name, s], ...], longest first."""
        gaps, at = [], self.t0
        for s, t in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if self.t1 > at:
            gaps.append((at, self.t1))
        mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
        host = sorted(self.host, key=lambda r: (r[0], -r[1]))
        by: dict[str, float] = {}
        stack, i = [], 0
        for m, length in mids:
            while i < len(host) and host[i][0] <= m:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            name = stack[-1][2] if stack else WINDOW_SPAN
            by[name] = by.get(name, 0.0) + length / 1e6
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:TOP]
