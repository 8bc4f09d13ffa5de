"""The shared broadcast log: one encoder's wire, many independent cursors.

The port's own copy of ``dat_replication_protocol_tpu/fanout/log.py``.
A resume journal retains a *single* window of produced wire bytes for
one resuming receiver.  Broadcast replication needs the same bytes readable by *thousands* of
receivers at independent offsets — and it needs handing a chunk to peer
N+1 to cost zero additional copies, because the frame bytes were
already assembled once by the encoder ("Simplicity Scales",
arxiv 2604.09591: one simple shared log, many independent cursors).

:class:`BroadcastLog` is that multi-reader extension:

* **Segmented storage, zero-copy reads.**  Appended chunks are kept as
  immutable segments (small chunks coalesce into a tail buffer that is
  frozen once, on first read past it — one copy per coalesced run, not
  per peer).  :meth:`read_slices` returns ``memoryview`` slices over
  the retained segments, ready for ``os.writev`` scatter-gather: frame
  bytes are assembled once by the encoder and never re-copied per peer.
* **Per-peer cursors, budget-bounded trim.**  Each attached cursor
  carries its own acked offset.  The log never trims past the
  **minimum** acked offset across live cursors *except* under budget
  pressure — and below the budget it does not trim at all, so a full
  ``retention_budget`` of history stays servable for late joiners.
* **Retention budget.**  One laggard must not pin unbounded memory:
  when retained bytes exceed ``retention_budget`` the log trims to the
  budget window and *invalidates* the cursors it trimmed past — their
  next read raises a structured :class:`SnapshotNeeded` naming the
  retained range, and the fan-out server sheds them (ROBUSTNESS.md
  peer-shed contract).

The log satisfies the encoder journal-tee contract (``append`` /
``seek``), so ``encoder.attach_journal(broadcast_log)`` wires a live
session straight into the fan-out path.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Optional

from ..obs.events import emit as _emit
from ..obs.metrics import (
    OBS as _OBS,
    counter as _counter,
    gauge as _gauge,
)
from ..session.resume import ResumeError

__all__ = ["BroadcastLog", "BroadcastCursor", "SnapshotNeeded"]

# fanout telemetry (OBSERVABILITY.md `fanout.*` catalog)
_M_APPEND = _counter("fanout.append.bytes")
_M_TRIMMED = _counter("fanout.trimmed.bytes")
_M_RETAINED = _gauge("fanout.retained.bytes")
_M_CURSORS = _gauge("fanout.cursors")
_M_SNAPSHOT_NEEDED = _counter("fanout.snapshot_needed")

# appends below this coalesce into the mutable tail; at or above it the
# chunk becomes its own immutable segment with no copy at read time
_COALESCE_BELOW = 4096


class SnapshotNeeded(ResumeError):
    """The requested offset is below the log's retained window: the
    receiver cannot be served from the log alone and must fetch a
    snapshot first.  ``retained`` is the ``(start, end)`` window that
    *is* servable; ``hint`` (when the deployment serves the snapshot
    bootstrap protocol) names where — a dict like
    ``{"port": N, "cap": CAP_SNAPSHOT}`` the fan-out server attaches so
    joiners can redirect without out-of-band config."""

    def __init__(self, message: str, *, offset: int,
                 retained: tuple[int, int], hint: dict | None = None):
        super().__init__(message, offset=offset)
        self.retained = retained
        self.hint = hint


class BroadcastCursor:
    """One reader's position in the log.  ``acked`` is the offset below
    which this reader has confirmed delivery (the trim input); the
    *send* position is the fan-out server's business, not the log's."""

    __slots__ = ("key", "acked", "invalidated", "gone")

    def __init__(self, key: str, offset: int):
        self.key = key
        self.acked = offset
        self.invalidated = False  # trimmed past by the retention budget
        self.gone = False


class BroadcastLog:
    """See module docstring.  Thread-safe; one writer, many readers."""

    def __init__(self, *, retention_budget: int = 64 << 20):
        if retention_budget <= 0:
            raise ValueError("retention_budget must be > 0")
        self.retention_budget = int(retention_budget)
        self._lock = threading.Lock()
        # datlint: guarded-by(self._lock): self._segs, self._seg_offs, self._cursors
        # datlint: guarded-by(self._lock): self._start, self._end, self._sealed
        # datlint: guarded-by(self._lock): self._tail, self._tail_off
        # immutable segments as parallel arrays: _seg_offs[i] is the
        # absolute wire offset of _segs[i][0]; bisect finds the segment
        # containing any retained offset in O(log n)
        self._segs: list[bytes] = []
        self._seg_offs: list[int] = []
        self._tail = bytearray()  # coalescing buffer for small appends
        self._tail_off = 0        # absolute offset of _tail[0]
        self._start = 0           # first retained (servable) offset
        self._end = 0             # one past the last appended byte
        self._sealed = False
        self._cursors: dict[str, BroadcastCursor] = {}
        self._on_append: Optional[Callable[[], None]] = None

    # -- writer section (O(1) in peers) --------------------------------------

    def append(self, data) -> None:
        """Record produced wire bytes.  This is the broadcast write
        path: it does NO per-peer work — the fan-out dispatcher owns the
        O(peers) bookkeeping (and never touches these bytes again; they
        leave as memoryview slices)."""
        n = len(data)
        if n == 0:
            return
        with self._lock:
            if self._sealed:
                raise ValueError("append to a sealed broadcast log")
            if n < _COALESCE_BELOW:
                if not self._tail:
                    self._tail_off = self._end
                self._tail += data
            else:
                self._freeze_tail_locked()
                self._seg_offs.append(self._end)
                self._segs.append(bytes(data))
            self._end += n
            if _OBS.on:
                _M_APPEND.inc(n)
                _M_RETAINED.set(self._end - self._start)
        hook = self._on_append
        if hook is not None:
            hook()

    def seek(self, offset: int) -> None:
        """Align an EMPTY log's window to an absolute wire offset (the
        encoder journal-tee contract: attaching after bytes were already
        emitted starts the window past them)."""
        with self._lock:
            if self._end != self._start or self._segs or self._tail:
                raise ValueError("seek on a non-empty broadcast log")
            self._start = self._end = offset

    def seal(self) -> None:
        """No more appends: ``end`` is final.  The fan-out server
        completes peers once their cursor reaches a sealed end."""
        hook = None
        with self._lock:
            if not self._sealed:
                self._sealed = True
                hook = self._on_append
        if hook is not None:
            hook()  # wake the dispatcher so drained peers complete

    # -- geometry -----------------------------------------------------------

    @property
    def start(self) -> int:
        return self._start

    @property
    def end(self) -> int:
        return self._end

    @property
    def sealed(self) -> bool:
        return self._sealed

    @property
    def retained_bytes(self) -> int:
        return self._end - self._start

    def __len__(self) -> int:
        return self._end - self._start

    def set_append_hook(self, hook: Optional[Callable[[], None]]) -> None:
        """Install the (single) append/seal notification hook — the
        fan-out server's dispatcher wakeup.  Runs outside the log lock."""
        self._on_append = hook

    # -- cursors ------------------------------------------------------------

    def attach(self, key: str, offset: Optional[int] = None
               ) -> BroadcastCursor:
        """Attach a reader at ``offset`` (default: the earliest retained
        byte).  A late joiner may attach at ANY retained offset; below
        the retained window raises :class:`SnapshotNeeded` (structured —
        the caller learns exactly what range is still servable), beyond
        ``end`` raises :class:`~..session.resume.ResumeError`."""
        with self._lock:
            off = self._start if offset is None else int(offset)
            if off < self._start:
                # built under the lock (consistent range), emitted and
                # raised by _snapshot_refusal OUTSIDE it: the event
                # sink can block, and every appender/reader contends
                # on this lock (blocking-under-lock contract)
                snap = SnapshotNeeded(
                    f"peer {key!r} asked for byte {off} below the "
                    f"retained range [{self._start}, {self._end}); a "
                    "snapshot (or restart) is required",
                    offset=off, retained=(self._start, self._end))
            else:
                if off > self._end:
                    raise ResumeError(
                        f"peer {key!r} asked for byte {off} ahead of "
                        f"everything produced (retained range "
                        f"[{self._start}, {self._end}))",
                        offset=off)
                if key in self._cursors:
                    raise ValueError(
                        f"cursor key {key!r} already attached")
                cur = BroadcastCursor(key, off)
                self._cursors[key] = cur
                if _OBS.on:
                    _M_CURSORS.set(len(self._cursors))
                return cur
        raise self._snapshot_refusal(snap, key=key, offset=off)

    @staticmethod
    def _snapshot_refusal(snap: "SnapshotNeeded", **fields
                          ) -> "SnapshotNeeded":
        """Count + emit a SnapshotNeeded refusal — called with the log
        lock RELEASED (the structured error was built under it)."""
        if _OBS.on:
            _M_SNAPSHOT_NEEDED.inc()
            start, end = snap.retained
            _emit("fanout.snapshot_needed", start=start, end=end,
                  **fields)
        return snap

    def detach(self, cursor: BroadcastCursor) -> None:
        """Remove a reader; its acked offset stops constraining the
        trim (a departed laggard releases its pinned window).
        Idempotent."""
        with self._lock:
            if cursor.gone:
                return
            cursor.gone = True
            if self._cursors.get(cursor.key) is cursor:
                del self._cursors[cursor.key]
            if _OBS.on:
                _M_CURSORS.set(len(self._cursors))
            trim = self._maybe_trim_locked()
        self._emit_trim(trim)

    def ack(self, cursor: BroadcastCursor, offset: int) -> None:
        """The reader confirmed delivery below ``offset``.  Acks feed
        the trim policy (see :meth:`_maybe_trim_locked`): below the
        retention budget nothing trims; above it the budget window
        wins and laggard cursors are invalidated."""
        with self._lock:
            if cursor.invalidated:
                raise SnapshotNeeded(
                    f"peer {cursor.key!r} was trimmed past by the "
                    f"retention budget (retained range "
                    f"[{self._start}, {self._end}))",
                    offset=cursor.acked,
                    retained=(self._start, self._end))
            if offset < cursor.acked or offset > self._end:
                # an ack that regresses or runs ahead of production is
                # not a flow-control signal — it is a byzantine peer;
                # the server turns this into a structured shed
                raise ValueError(
                    f"byzantine ack from {cursor.key!r}: offset {offset} "
                    f"outside [{cursor.acked}, {self._end}]")
            cursor.acked = offset
            trim = self._maybe_trim_locked()
        self._emit_trim(trim)

    def enforce_retention(self) -> None:
        """Apply the retention budget now.  The write path stays O(1) in
        peers, so budget pressure from a burst of appends is enforced
        here — called by the fan-out dispatcher each turn (and by any
        caller with no dispatcher at all)."""
        with self._lock:
            trim = self._maybe_trim_locked()
        self._emit_trim(trim)

    @staticmethod
    def _emit_trim(trim) -> None:
        """Emit the trim event with the log lock RELEASED (the fields
        were captured under it by :meth:`_maybe_trim_locked`)."""
        if trim is not None:
            start, end, trimmed = trim
            _emit("fanout.trim", start=start, end=end, trimmed=trimmed)

    def cursors_snapshot(self) -> dict:
        """{key: acked offset} for live cursors (telemetry/debugging)."""
        with self._lock:
            return {k: c.acked for k, c in self._cursors.items()}

    # -- reads --------------------------------------------------------------

    def read_slices(self, offset: int, max_bytes: int,
                    max_iov: int = 64) -> list:
        """Up to ``max_bytes`` of retained bytes at ``offset`` as
        ``memoryview`` slices over the internal segments (at most
        ``max_iov`` of them — the ``os.writev`` IOV budget).  ZERO
        copies: the views alias the log's own immutable segments.  An
        empty list means nothing is available at ``offset`` yet.

        Raises :class:`SnapshotNeeded` when ``offset`` was already
        trimmed away — a structured error naming the retained range,
        never a silent short read."""
        out: list = []
        with self._lock:
            if offset < self._start:
                # built under the lock, emitted + raised AFTER it is
                # released via _snapshot_refusal
                # (blocking-under-lock contract)
                snap = SnapshotNeeded(
                    f"byte {offset} is below the retained range "
                    f"[{self._start}, {self._end})",
                    offset=offset, retained=(self._start, self._end))
            else:
                if offset >= self._end or max_bytes <= 0:
                    return out
                self._freeze_tail_locked()
                want = min(max_bytes, self._end - offset)
                i = bisect.bisect_right(self._seg_offs, offset) - 1
                while want > 0 and i < len(self._segs) \
                        and len(out) < max_iov:
                    seg_off = self._seg_offs[i]
                    seg = self._segs[i]
                    lo = offset - seg_off
                    hi = min(len(seg), lo + want)
                    view = memoryview(seg)[lo:hi]
                    out.append(view)
                    taken = hi - lo
                    want -= taken
                    offset += taken
                    i += 1
                return out
        raise self._snapshot_refusal(snap, offset=snap.offset)

    def read_from(self, offset: int) -> bytes:
        """Journal-compatible copy read: every retained byte at
        ``offset`` and beyond, as one bytes object (tests, resume
        interop).  The scatter-gather path is :meth:`read_slices`."""
        views = self.read_slices(offset, max(0, self._end - offset),
                                 max_iov=1 << 30)
        return b"".join(bytes(v) for v in views)

    # -- trim ---------------------------------------------------------------

    def _maybe_trim_locked(self) -> Optional[tuple]:
        # Returns (start, end, trimmed) when a trim happened with the
        # obs gate on — the CALLER must pass it to _emit_trim once the
        # lock releases (the return value IS the deferred fanout.trim
        # event; dropping it loses the event), else None.
        # Lazy, budget-driven trim: the log retains a full
        # ``retention_budget`` of history even once every live cursor
        # acked past it — that window is what late joiners attach into.
        # Only budget pressure trims, and then the budget WINS over the
        # min-acked floor (the bounded-laggard clause): cursors below
        # the new start are invalidated, never silently short-read.
        target = self._end - self.retention_budget
        if target <= self._start:
            return
        trimmed = target - self._start
        self._start = target
        # laggards the budget trimmed past: invalidate, never short-read
        for c in self._cursors.values():
            if not c.invalidated and c.acked < target:
                c.invalidated = True
        # drop whole segments now fully below the window; a segment
        # straddling the boundary stays until its last byte is trimmed
        drop = 0
        while drop < len(self._segs) and \
                self._seg_offs[drop] + len(self._segs[drop]) <= target:
            drop += 1
        if drop:
            del self._segs[:drop]
            del self._seg_offs[:drop]
        if self._tail and self._tail_off + len(self._tail) <= target:
            self._tail.clear()
        if _OBS.on:
            _M_TRIMMED.inc(trimmed)
            _M_RETAINED.set(self._end - self._start)
            # the EVENT is the caller's to emit once the lock releases
            # (blocking-under-lock contract): return the fields
            return (self._start, self._end, trimmed)
        return None

    def _freeze_tail_locked(self) -> None:
        """Promote the mutable coalescing tail to an immutable segment.
        Needed before any read exports views (a memoryview over a live
        bytearray would pin it against resize) and before a large append
        lands behind it.  One copy per coalesced run — never per peer."""
        if self._tail:
            self._seg_offs.append(self._tail_off)
            self._segs.append(bytes(self._tail))
            self._tail.clear()
