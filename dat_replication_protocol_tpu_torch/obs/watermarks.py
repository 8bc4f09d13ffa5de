"""Live replication-lag watermarks: wire-position cursors as telemetry.

The port's own copy of ``dat_replication_protocol_tpu/obs/watermarks.py``,
the fleet plane's data layer.  Every layer of the session
stack already maintains an exact wire-position cursor — the sender
journal's append/acked offsets, the decoder's accepted/parsed bytes and
last checkpoint, a fan-out peer's delivered offset — because the resume
and flow-control machinery need them.  This module exports those
cursors as *labeled gauges* without adding any wire traffic or hot-path
work: a cursor is registered ONCE as a zero-argument callable, and the
value is read only at snapshot time (the "Simplicity Scales" split —
the data plane is never taxed; lag is *derived* from state both sides
already keep).

Catalog shape (OBSERVABILITY.md "Fleet plane"):

* ``session.wire.offset{link=L,role=R}`` — one labeled collector entry
  per tracked cursor, merged into every registry snapshot via the
  registry's collector machinery.  ``link`` names one wire (a session key, a
  fan-out peer); ``role`` names the cursor (see :data:`SEND_ROLES` /
  :data:`RECV_ROLES`).
* ``(append - parsed)`` for one link is the link's **exact replication
  lag in bytes**: wire bytes the sender has produced that the receiver
  has not yet fully parsed.
* The per-link **marks ring** ``[(end_offset, monotonic_t), ...]``
  records when each append advanced the wire, so lag in *seconds* is
  clock-free: the age of the oldest unparsed byte is measured entirely
  on the sender's monotonic clock (the fleet aggregator joins a
  receiver's parsed offset against the sender's marks — no wall-clock
  synchronization anywhere).

Registration is idempotent and bounded: re-tracking a (link, role)
replaces the callable (sessions reconnect), :func:`untrack` drops a
link whole (dead sessions vanish from snapshots — nothing leaks), and
the board re-registers its registry collector on every track so a
test-isolation ``Registry.reset()`` (which drops collectors by design)
cannot silently dark the watermark plane for the next owner.

Hot-path budget: the only call that may sit on a session hot path is
:meth:`WatermarkBoard.mark`, and every caller gates it behind
``if _OBS.on:`` — disabled telemetry pays one attribute load, the same
contract as every other instrumentation site.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from .metrics import REGISTRY as _REGISTRY

__all__ = [
    "WATERMARKS",
    "WatermarkBoard",
    "SEND_ROLES",
    "RECV_ROLES",
    "link_lag",
]

# the catalog's role vocabulary (OBSERVABILITY.md).  Sender-side roles
# advance as bytes are produced; receiver-side roles advance as bytes
# are consumed.  Lag joins the largest sender cursor against the
# receive cursor in preference order (parsed is exact; delivered is the
# fan-out transport's "handed to the kernel" position).
SEND_ROLES = ("append", "acked")
RECV_ROLES = ("parsed", "accepted", "checkpoint", "delivered")
# receive-cursor preference for the lag join, strongest first
_LAG_RECV_PREFERENCE = ("parsed", "delivered")

_MARK_RING = 1024
# marks exported per snapshot line: enough to cover any realistic poll
# interval without growing --stats-fd lines unboundedly
_MARK_EXPORT = 256

_BAD_LABEL_CHARS = '{},="\n\r'


def _check_label(kind: str, value: str) -> None:
    # link/role ride telemetry label sets ({link=L,role=R}) and JSON
    # breakdowns — refuse structural characters at the boundary (the
    # hub/fanout key precedent)
    if not isinstance(value, str) or not value or any(
            c in value for c in _BAD_LABEL_CHARS):
        raise ValueError(
            f"watermark {kind} {value!r} must be a non-empty string "
            'containing none of {},=" or newlines')


class _Link:
    __slots__ = ("cursors", "marks", "marks_from", "marks_dropped")

    def __init__(self) -> None:
        self.cursors: dict[str, Callable[[], int]] = {}
        self.marks: deque = deque(maxlen=_MARK_RING)
        self.marks_from: Optional[str] = None
        # marks evicted by ring wraparound: the lag-seconds join must
        # know when the OLDEST retained mark is not the oldest append
        # (an outrun ring would otherwise under-report the age of the
        # frontier byte — the dangerous direction for an SLO gate)
        self.marks_dropped = 0


def link_lag(offsets: dict, marks, now: float,
             marks_dropped: int = 0) -> tuple:
    """The one lag join, shared by the local snapshot and the fleet
    aggregator: ``(lag_bytes, lag_seconds)`` from one link's role ->
    offset dict and its ``[(end_offset, t), ...]`` marks.

    * ``lag_bytes = append - recv`` where ``recv`` is the strongest
      receive cursor present (parsed, else delivered); ``None`` when
      either side is missing (an unjoined half-link is visible, not
      fabricated as zero).
    * ``lag_seconds`` is the age of the oldest unparsed byte on the
      *sender's* clock: ``now`` must be a monotonic stamp from the same
      process that recorded ``marks``.  Exactly ``0.0`` when the link
      is fully caught up; ``None`` when behind but the age cannot be
      attributed EXACTLY — no mark covers the frontier, or
      ``marks_dropped`` says older marks were evicted and the first
      retained mark already sits past the frontier (the evicted marks
      were older: reporting the retained one would UNDER-state the
      age, which is the direction an SLO gate must never err in).
    """
    append = offsets.get("append")
    recv = None
    for role in _LAG_RECV_PREFERENCE:
        if offsets.get(role) is not None:
            recv = offsets[role]
            break
    if append is None or recv is None:
        return None, None
    lag_bytes = max(0, int(append) - int(recv))
    if lag_bytes == 0:
        return 0, 0.0
    lag_seconds = None
    for i, (end, t) in enumerate(marks or ()):
        if end > recv:
            if i == 0 and marks_dropped:
                # the frontier byte predates every retained mark: its
                # true age is OLDER than anything we can attribute
                break
            # the first mark past the receive frontier timestamps the
            # oldest byte the receiver has not consumed (exact: either
            # nothing was ever evicted, or its predecessor covers recv)
            lag_seconds = max(0.0, float(now) - float(t))
            break
    return lag_bytes, lag_seconds


class WatermarkBoard:
    """Process-global registry of wire-position cursors.  See module
    docstring; the instance to use is :data:`WATERMARKS`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # datlint: guarded-by(self._lock): self._links
        self._links: dict[str, _Link] = {}
        # event-loop lag exporters: loop name -> zero-arg
        # callable returning the loopprof export record
        # datlint: guarded-by(self._lock): self._loops
        self._loops: dict[str, Callable[[], dict]] = {}
        self._collector_fn = self._collect

    # -- registration -------------------------------------------------------

    def track(self, role: str, link: str, fn: Callable[[], int], *,
              marks_from: Optional[str] = None) -> None:
        """Track one cursor: ``fn()`` returns the current absolute wire
        offset for ``role`` on ``link``.  ``role`` is a string literal
        at every call site (the obs-discipline greppability contract —
        the catalog keys on it); ``link`` is the runtime wire name (a
        session key).  Re-tracking a (link, role) replaces the callable.

        ``marks_from`` points this link's lag-seconds computation at
        ANOTHER link's marks ring — the fan-out case: one shared
        publish ring serves every per-peer link, keeping the publish
        path O(1) in peers."""
        _check_label("role", role)
        _check_label("link", link)
        with self._lock:
            entry = self._links.get(link)
            if entry is None:
                entry = self._links[link] = _Link()
            entry.cursors[role] = fn
            if marks_from is not None:
                _check_label("link", marks_from)
                entry.marks_from = marks_from
        # idempotent re-registration: Registry.reset() (test/bench
        # isolation) drops collectors on purpose; the next track() must
        # bring the watermark plane back instead of staying dark
        _REGISTRY.register_collector("watermarks", self._collector_fn)

    def untrack(self, link: str) -> None:
        """Drop a link whole (every role + its marks).  Dead sessions
        stop appearing in snapshots; nothing leaks.  Idempotent."""
        with self._lock:
            self._links.pop(link, None)

    def track_loop(self, name: str, fn: Callable[[], dict]) -> None:
        """Track one event loop's lag exporter: ``fn()``
        returns the :meth:`~.loopprof.LoopProfiler.export` record.
        Same contract as :meth:`track` — idempotent replace, label
        hygiene at the boundary, collector re-registration so a
        ``Registry.reset()`` cannot dark the loop plane."""
        _check_label("loop", name)
        with self._lock:
            self._loops[name] = fn
        _REGISTRY.register_collector("watermarks", self._collector_fn)

    def untrack_loop(self, name: str) -> None:
        """Drop one loop's exporter (loop shutdown).  Idempotent."""
        with self._lock:
            self._loops.pop(name, None)

    def mark(self, link: str, end_offset: int) -> None:
        """Note that ``link``'s appended wire now ends at
        ``end_offset`` (monotonic-stamped).  The ONLY board call that
        sits on a hot path — callers gate it with ``if _OBS.on:``."""
        now = time.monotonic()
        with self._lock:
            entry = self._links.get(link)
            if entry is None:
                entry = self._links[link] = _Link()
            if len(entry.marks) == entry.marks.maxlen:
                entry.marks_dropped += 1
            entry.marks.append((end_offset, now))

    # -- snapshots ----------------------------------------------------------

    def _read_cursors(self, entry: _Link) -> dict:
        offsets = {}
        for role, fn in list(entry.cursors.items()):
            try:
                # registered cursor getters are attribute reads (wire
                # offsets) — snapshot-grade, never blocking
                offsets[role] = int(fn())
            except Exception:
                # a dying owner (decoder mid-destroy) must not take the
                # snapshot down — its cursor simply goes missing, the
                # same best-effort contract as registry collectors
                continue
        return offsets

    def snapshot(self) -> dict:
        """Plain-dict view (JSON-able): per-link offsets, bounded marks
        tail, and the locally-computed lag when both sides of a link
        live in this process.  ``monotonic`` stamps the snapshot on
        this process's clock — the fleet aggregator's time base for
        the clock-free seconds join."""
        now = time.monotonic()
        with self._lock:
            links = {name: (entry, list(entry.marks), entry.marks_dropped)
                     for name, entry in self._links.items()}
        out: dict = {"monotonic": now, "links": {}}
        loops = self.loops_now()
        if loops:
            out["loops"] = loops
        for name, (entry, marks, dropped) in links.items():
            offsets = self._read_cursors(entry)
            if not offsets:
                # a marks-only link (the fan-out shared publish ring,
                # or a link whose every cursor died) is a clock
                # source, not a wire: exporting it as a half-link
                # would make the SLO gate fail a healthy fleet on a
                # link that can never join
                continue
            src = entry.marks_from
            if src is not None and src in links:
                marks = links[src][1]
                dropped = links[src][2]
            # the export tail is itself an eviction: marks cut off by
            # _MARK_EXPORT count as dropped for the exactness rule
            dropped += max(0, len(marks) - _MARK_EXPORT)
            lag_bytes, lag_seconds = link_lag(offsets,
                                              marks[-_MARK_EXPORT:], now,
                                              marks_dropped=dropped)
            rec: dict = {"offsets": offsets,
                         "marks": [[o, t] for o, t in marks[-_MARK_EXPORT:]],
                         "marks_dropped": dropped}
            if src is not None:
                rec["marks_from"] = src
            if lag_bytes is not None:
                rec["lag_bytes"] = lag_bytes
                rec["lag_seconds"] = (round(lag_seconds, 6)
                                      if lag_seconds is not None else None)
            out["links"][name] = rec
        return out

    def loops_now(self) -> dict:
        """Current per-loop lag records (the ``loops`` snapshot
        section): loop name -> the exporter's dict.  Best-effort, the
        same contract as cursor reads — a dying loop's exporter simply
        goes missing."""
        with self._lock:
            loops = list(self._loops.items())
        out: dict = {}
        for name, fn in loops:
            try:
                # loop exporters are plain-attribute reads off the
                # profiler (lock-free, one turn stale) — never blocking
                rec = fn()
            except Exception:
                continue
            if isinstance(rec, dict):
                out[name] = rec
        return out

    def _collect(self) -> dict:
        """Registry collector: one labeled gauge per tracked cursor
        (bounded cardinality — untracked links stop appearing), plus
        the per-loop lag gauges (``edge.loop.lag{loop=}``)."""
        gauges: dict = {}
        with self._lock:
            links = list(self._links.items())
        for name, entry in links:
            for role, value in self._read_cursors(entry).items():
                gauges[f"session.wire.offset{{link={name},role={role}}}"] = \
                    float(value)
        for name, rec in self.loops_now().items():
            if rec.get("state") != "live":
                continue  # a dark loop exports nothing: stale zeros
                #   would read as "caught up", the direction an SLO
                #   gate must never err in
            gauges[f"edge.loop.lag{{loop={name}}}"] = float(
                rec.get("lag_s", 0.0))
            gauges[f"edge.loop.lag_max{{loop={name}}}"] = float(
                rec.get("lag_max_s", 0.0))
            gauges[f"edge.loop.oldest_ready{{loop={name}}}"] = float(
                rec.get("oldest_ready_s", 0.0))
        return {"gauges": gauges}

    def reset_for_tests(self) -> None:
        """Drop every link and loop (process-global state — test
        isolation is explicit, the conftest ``obs_enabled``
        contract)."""
        with self._lock:
            self._links.clear()
            self._loops.clear()


WATERMARKS = WatermarkBoard()
