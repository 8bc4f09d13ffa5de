"""Bounded-ring structured event log for session lifecycle.

A trimmed copy of ``dat_replication_protocol_tpu/obs/events.py``;
stdlib only.  Events are the rare, narrative half of telemetry: a
protocol error, a requeued tail, an engine choice, a backend-init stage.
Each record carries a process-wide increasing ``seq`` and a
``time.monotonic()`` stamp.

The ring is bounded (default 1024 records): a storm overwrites the
oldest and bumps ``dropped``.  An optional sink (:meth:`EventLog.
attach_sink`) mirrors each record as one JSON line to an fd or a file
object when it is emitted.

Sink discipline on non-blocking fds: a record is written whole or not
at all.  ``EAGAIN`` before the first byte drops it and bumps
``sink_dropped``; ``EAGAIN`` after a partial write retries briefly, and
if the pipe stays full the sink latches dead, so nothing is ever
appended to a torn line.

Emission is gated on :data:`~.metrics.OBS`; hot sites also guard with
``if _OBS.on:`` so the disabled path never builds the kwargs dict.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

from .metrics import OBS

__all__ = ["EventLog", "EVENTS", "emit"]

DEFAULT_CAPACITY = 1024

# how long a torn record may retry on EAGAIN before the sink latches dead
_SINK_RETRY_S = 0.05


class EventLog:
    """Bounded ring of structured events + optional JSONL sink."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        # the sink's I/O serializes on its own lock, so two records never
        # interleave and the ring lock stays cheap
        self._sink_lock = threading.Lock()
        # datlint: guarded-by(self._lock): self._ring, self._seq, self.dropped
        # datlint: guarded-by(self._lock): self._sink, self._sink_dead
        # datlint: guarded-by(self._sink_lock): self.sink_dropped
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self.dropped = 0  # records overwritten by ring wraparound
        self.sink_dropped = 0  # records the sink dropped whole
        self._sink = None  # int fd, or object with write(str)
        self._sink_dead = False  # a record tore on this sink: latched

    # -- emission -----------------------------------------------------------

    def emit(self, event: str, **fields) -> None:
        """Record one event (no-op while the gate is off).  ``event`` is a
        dot-separated literal; ``fields`` are JSON-able scalars."""
        if not OBS.on:
            return
        self._append({"seq": 0, "ts": time.monotonic(), "event": event,
                      "fields": fields})

    def _append(self, rec: dict) -> None:
        """Ring and sink plumbing shared with the span ring: ``seq``
        under the lock, wraparound accounting, the sink outside it."""
        with self._lock:
            rec["seq"] = self._seq
            self._seq += 1
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(rec)
            sink = self._sink
            dead = self._sink_dead
        if sink is not None:
            with self._sink_lock:
                if dead or self._sink_dead:
                    self.sink_dropped += 1
                else:
                    # _sink_lock exists to serialize this I/O: one record
                    # is one uninterleaved JSONL line.  The lock is a leaf
                    # (nothing is taken inside but _latch_dead's hop), and
                    # only emitters that attached a sink pay for it; a
                    # caller holding another lock is not excused.
                    # datlint: allow-blocking-under-lock
                    self._write_sink(sink, rec)

    def _latch_dead(self, sink) -> None:
        """Latch only if ``sink`` is still the attached one: a fresh sink
        swapped in meanwhile has no torn fragment."""
        with self._lock:
            if self._sink is sink:
                self._sink_dead = True

    def _write_sink(self, sink, rec: dict) -> None:
        """One record -> one JSONL line, whole or not at all.  Runs under
        ``_sink_lock``."""
        line = json.dumps(rec, default=repr) + "\n"
        if not isinstance(sink, int):
            try:
                # a file-object sink runs on the emitting thread: its
                # promptness is the attacher's (an fd rides the deadline
                # loop below)
                # datlint: allow-blocking-reachable(file-io)
                sink.write(line)
                flush = getattr(sink, "flush", None)
                if flush is not None:
                    flush()
            except (OSError, ValueError):
                # a dead sink must never take the session down
                self.sink_dropped += 1
            return
        view = memoryview(line.encode("utf-8"))
        total = len(view)
        deadline = None
        try:
            while view:
                try:
                    # the EAGAIN/deadline loop below bounds this write on
                    # a non-blocking fd; a blocking fd parks only the
                    # emitting thread (the attach_sink contract)
                    # datlint: allow-blocking-reachable(os-io)
                    n = os.write(sink, view)
                except InterruptedError:
                    continue
                except BlockingIOError:
                    if len(view) == total:
                        # nothing written yet: drop the record whole
                        self.sink_dropped += 1
                        return
                    # a torn line is on the fd: retry briefly, then latch
                    now = time.monotonic()
                    if deadline is None:
                        deadline = now + _SINK_RETRY_S
                    elif now >= deadline:
                        self._latch_dead(sink)
                        self.sink_dropped += 1
                        return
                    time.sleep(0.001)
                    continue
                view = view[n:]
        except (OSError, ValueError):
            if len(view) != total:
                self._latch_dead(sink)
            self.sink_dropped += 1

    # -- sink management ----------------------------------------------------

    def attach_sink(self, sink) -> None:
        """Mirror every later record as one JSON line to ``sink`` (an int
        fd, or an object with ``write(str)``); clears a dead latch."""
        with self._lock:
            self._sink = sink
            self._sink_dead = False

    def detach_sink(self) -> None:
        with self._lock:
            self._sink = None
            self._sink_dead = False

    def resize(self, capacity: int) -> None:
        """Hold up to ``capacity`` records from now on, keeping the newest
        retained ones: a capture longer than the default ring (a session
        of thousands of frames) keeps its records without a sink's
        per-record serialization."""
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        with self._lock:
            self._ring = collections.deque(self._ring, maxlen=capacity)

    # -- inspection ---------------------------------------------------------

    def events(self, event: Optional[str] = None) -> list[dict]:
        """The retained records, oldest first; optionally one name."""
        with self._lock:
            records = list(self._ring)
        if event is None:
            return records
        return [r for r in records if r.get("event") == event]

    def count(self, event: str) -> int:
        return len(self.events(event))

    def last(self, event: Optional[str] = None) -> Optional[dict]:
        records = self.events(event)
        return records[-1] if records else None

    def clear(self) -> None:
        """Drop retained records (``seq`` keeps counting).  The sink and
        its dead latch stay."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0
        with self._sink_lock:
            self.sink_dropped = 0


EVENTS = EventLog()


def emit(event: str, **fields) -> None:
    """Emit to the process-global event log (gated)."""
    EVENTS.emit(event, **fields)


class DeferredEmitQueue:
    """Events queued under an owner's lock, emitted after its release.

    The hub's dispatcher may never emit while it holds its lock (a sink
    can block, and blocking under the hub lock stalls every session), so
    shed events capture their fields while the owner's view is
    consistent and leave once the lock is released.  ``queue_locked`` is
    called with ``lock`` held, ``flush`` with it released; ``flush``
    peeks without the lock (a missed peek is drained by the next call),
    swaps under it and emits outside it.
    """

    def __init__(self, event: str, lock):
        self._event = event
        self._lock = lock
        self._pending: list = []

    def queue_locked(self, **fields) -> None:
        self._pending.append(fields)

    def flush(self) -> None:
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        for fields in pending:
            emit(self._event, **fields)
