"""Causal tracing: wire-offset-correlated spans + Chrome trace export.

A trimmed copy of ``dat_replication_protocol_tpu/obs/tracing.py``;
stdlib only.  The wire already carries a causal key: the byte offset
each frame starts at.  This module records nestable named spans into a
bounded ring, and zero-duration instants with which the session layer
tags every frame the encoder emits and the decoder dispatches.

* :class:`trace_span` — ``with trace_span("device.dispatch", ...):``;
  nesting is tracked per thread, so spans on pipeline and sidecar
  threads never corrupt each other's parent links.  Gated on ``OBS.on``.
* :func:`trace_instant` — the frame-tagging hot path, one record of zero
  duration.  Call sites guard with ``if _OBS.on:``; it does not re-check.
* :data:`SPANS` — the process-global span ring (an
  :class:`~.events.EventLog` subclass: the same wraparound accounting
  and JSONL sink discipline).
* :func:`to_chrome_trace` / :func:`export_chrome_trace` — Chrome
  trace-event JSON (Perfetto, chrome://tracing).  Spans recorded through
  :mod:`..utils.trace` ride in with ``src="torch"``.
* :func:`attach_jsonl_sink` — events and spans into one JSONL file; the
  JAX package's offline timeline tool reads these files unchanged.

Span record shape (one JSON object per line on a sink)::

    {"seq": 12, "ts": 103.2, "dur": 0.0018, "span": "device.dispatch",
     "id": 7, "parent": 3, "tid": 139923, "fields": {"items": 33}}

Frame instants are ``encoder.frame`` / ``decoder.frame`` with fields
``offset`` (the wire offset of the frame's first header byte),
``wire_len`` (header + payload bytes), ``kind`` (``change`` / ``blob`` /
``change_batch``) and, for a batch frame, ``rows``.  Both peers compute
offsets from the same framing, so one frame carries the same offset at
both ends.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Optional

from .events import EVENTS, EventLog
from .metrics import OBS

__all__ = [
    "SPANS",
    "SpanLog",
    "trace_span",
    "trace_instant",
    "to_chrome_trace",
    "export_chrome_trace",
    "attach_jsonl_sink",
]

DEFAULT_SPAN_CAPACITY = 4096


class SpanLog(EventLog):
    """Bounded ring of span records (``span`` instead of ``event``, plus
    ``dur``/``id``/``parent``/``tid``)."""

    def record(self, name: str, ts: float, dur: float, span_id: int,
               parent: Optional[int], tid: int, fields: dict) -> None:
        """Append one finished span.  Not gated: the producers own the
        ``OBS.on`` check (a span that started with the gate on still
        records if the gate flips mid-span)."""
        self._append({"seq": 0, "ts": ts, "dur": dur, "span": name,
                      "id": span_id, "parent": parent, "tid": tid,
                      "fields": fields})

    def spans(self, name: Optional[str] = None) -> list[dict]:
        """The retained span records, oldest first."""
        with self._lock:
            records = list(self._ring)
        if name is None:
            return records
        return [r for r in records if r.get("span") == name]


SPANS = SpanLog(DEFAULT_SPAN_CAPACITY)

# process-wide ids keep parent links unambiguous across threads;
# count().__next__ is atomic under the GIL
_span_ids = itertools.count(1)

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class trace_span:
    """Nestable named span with a per-thread parent stack.  A no-op while
    the gate is off: one gate check at enter, one slot check at exit."""

    __slots__ = ("name", "fields", "_t0", "_id", "_parent", "_on")

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields

    def __enter__(self) -> "trace_span":
        if not OBS.on:
            self._on = False
            return self
        self._on = True
        st = _stack()
        self._id = next(_span_ids)
        self._parent = st[-1] if st else None
        st.append(self._id)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._on:
            st = _stack()
            if st and st[-1] == self._id:
                st.pop()
            fields = self.fields
            if exc_type is not None:
                # a span that ended by exception names it
                fields = dict(fields, error=exc_type.__name__)
            SPANS.record(self.name, self._t0,
                         time.monotonic() - self._t0, self._id,
                         self._parent, threading.get_ident(), fields)
        return False


def trace_instant(name: str, **fields) -> None:
    """Zero-duration span (a Chrome instant): the frame-tagging hot path.
    Call sites guard with ``if _OBS.on:``."""
    st = getattr(_tls, "stack", None)
    SPANS.record(name, time.monotonic(), 0.0, next(_span_ids),
                 st[-1] if st else None, threading.get_ident(), fields)


# -- Chrome trace-event export ------------------------------------------------


def to_chrome_trace(spans: Optional[list] = None,
                    events: Optional[list] = None) -> dict:
    """Chrome trace-event JSON from span and event records (default: the
    live rings).  Spans with a duration become complete events (``ph:
    "X"``), frame instants and events become instants (``ph: "i"``);
    times in microseconds."""
    if spans is None:
        spans = SPANS.spans()
    if events is None:
        events = EVENTS.events()
    pid = os.getpid()
    trace_events = []
    for r in spans:
        if "span" not in r:
            continue
        args = dict(r.get("fields") or {})
        args["seq"] = r.get("seq", 0)
        if r.get("parent") is not None:
            args["parent"] = r["parent"]
        ev = {
            "name": r["span"],
            "ts": r.get("ts", 0.0) * 1e6,
            "pid": pid,
            "tid": r.get("tid", 0),
            "args": args,
        }
        if r.get("dur"):
            ev["ph"] = "X"
            ev["dur"] = r["dur"] * 1e6
        else:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        trace_events.append(ev)
    for e in events:
        if "event" not in e:
            continue
        trace_events.append({
            "name": e["event"],
            "ph": "i",
            "s": "p",  # process-scoped instant
            "ts": e.get("ts", 0.0) * 1e6,
            "pid": pid,
            "tid": 0,
            "args": dict(e.get("fields") or {}, seq=e.get("seq", 0)),
        })
    trace_events.sort(key=lambda ev: ev["ts"])
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "metadata": {"pid": pid},
    }


def export_chrome_trace(path: str, spans: Optional[list] = None,
                        events: Optional[list] = None) -> str:
    """Write :func:`to_chrome_trace` to ``path`` atomically (tmp +
    rename); returns the path."""
    doc = to_chrome_trace(spans, events)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# -- shared JSONL sink --------------------------------------------------------


class _LockedLineFile:
    """A ``write(str)`` sink shared by the event and span logs under one
    lock, so their lines never interleave."""

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()

    def write(self, s: str) -> None:
        with self._lock:
            # serializing this file I/O is this lock's whole job (one
            # line per record across both logs); it is a leaf lock, and
            # callers holding other locks are not excused by this marker
            # datlint: allow-blocking-under-lock(file-io)
            self._f.write(s)
            # datlint: allow-blocking-under-lock(file-io)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


def attach_jsonl_sink(path: str) -> _LockedLineFile:
    """Mirror every later event and span as JSONL into ``path`` (append)
    through one shared lock.  Returns the sink: detach both logs, then
    ``close()`` it."""
    sink = _LockedLineFile(open(path, "a", encoding="utf-8"))
    EVENTS.attach_sink(sink)
    SPANS.attach_sink(sink)
    return sink
