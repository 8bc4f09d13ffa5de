"""Decoder — the consuming end of a replication session.

A trimmed copy of ``dat_replication_protocol_tpu/session/decoder.py``
(reference semantics: decode.js:63-262): a push-based incremental
parser, header -> (change | blob payload) -> header ...

* Handlers are registered with :meth:`change` / :meth:`blob` /
  :meth:`finalize`; each receives a ``done`` callable.  While any
  ``done`` is outstanding, parsing pauses and :meth:`write` returns
  ``False`` — the backpressure of the reference's withheld Writable
  callback (decode.js:87-99,168).
* Unregistered handlers never deadlock: changes are dropped, blobs
  drained, finalize auto-acked (decode.js:50-61).
* :meth:`end` runs the finalize handler after all prior frames are
  consumed, then the session finishes.
* Unknown frame type ids destroy the session with
  :class:`~..wire.framing.ProtocolError` (decode.js:159-161).
* Negotiated ``ChangeBatch`` frames (:meth:`capabilities` advertises
  ``CAP_CHANGE_BATCH``) deliver whole columns to a :meth:`change_batch`
  handler with one ``done``, or row by row to the :meth:`change`
  handler, the stream a per-record peer would give.
* Negotiated ``TYPE_RECONCILE`` and ``TYPE_SNAPSHOT`` frames are decoded
  whole (``wire/reconcile_codec.py``, ``wire/snapshot_codec.py``) and
  delivered with one ``done`` to the :meth:`reconcile` and
  :meth:`snapshot` handlers; without a handler they are dropped.  A
  structurally corrupt payload destroys the session with a
  ProtocolError, as a corrupt Change does.

Telemetry (behind :data:`..obs.metrics.OBS`): the reference's session
counters, ``decoder.frame`` instants that tile the wire (offset,
wire_len, kind; ``rows`` on a batch frame), ``decoder.requeue`` and
``protocol.error`` events, and a flight bundle on a protocol error when
the recorder is armed.  Each run of the C change loop is a
``decoder.change_run`` span (``utils/trace.py``: a profiler range while
a profiler runs, an obs span with the gate on), and ``change_runs``
counts the runs whatever the gate.

:meth:`checkpoint` exports the resume point (``session/resume.py``) and
:meth:`watermark` the wire cursors on the fleet plane.

Two parse routes give the same deliveries, errors and checkpoints.  The
native route (the default, the JAX package's) indexes a queued buffer of
complete frames in one ``dat_split_frames`` call once at least
:attr:`Decoder._NATIVE_MIN` bytes wait at a frame boundary, pre-decodes
the buffer's change payloads in one ``dat_decode_changes`` call, and
dispatches runs of change frames from the ``dat_fastpath`` C loop (one
``decoder.frame.run`` instant a run, where the streaming scanner tags
each frame); the byte-at-a-time scanner takes split headers, partial
frames and small writes.  The wire pump's receive indexes its slab in C
already and installs that index through :meth:`write_indexed`.
``Decoder(native=False)`` is the plain version: the streaming scanner
alone.  A failed build of either host library raises.
Subclasses tap payloads through :meth:`_deliver_change`,
:meth:`_note_change_batch` and the blob hooks
(:meth:`_open_blob_if_ready`, :meth:`_note_blob_bytes`,
:meth:`_end_blob`).
"""

from __future__ import annotations

import threading
from collections import deque
from time import perf_counter as _perf
from typing import Callable, Optional

from .._fastpath_gate import fastpath_mod as _fastpath_mod
from ..obs import wirecost as _wirecost
from ..obs.events import emit as _emit
from ..obs.flight import FLIGHT as _FLIGHT
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import trace_instant as _trace_instant
from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..utils.trace import span as _span
from ..wire.change_codec import Change, decode_change
from ..wire.framing import (LOCAL_CAPS, MAX_HEADER_LEN, TYPE_BLOB,
                            TYPE_CHANGE, TYPE_CHANGE_BATCH, TYPE_HEADER,
                            TYPE_RECONCILE, TYPE_SNAPSHOT, ProtocolError)
from ..wire.framing import header_len as _header_len
from ..wire.varint import decode_uvarint

OnDone = Optional[Callable[[], None]]

# the reference's catalog names (OBSERVABILITY.md); each site is one
# `_OBS.on` attribute load while telemetry is off
_M_DEC_BYTES = _counter("decoder.bytes")
_M_DEC_CHANGES = _counter("decoder.changes")
_M_DEC_BLOBS = _counter("decoder.blobs")
_M_DEC_BLOB_BYTES = _counter("decoder.blob.bytes")
_M_DEC_REQUEUES = _counter("decoder.requeues")
_M_DEC_ERRORS = _counter("decoder.errors")
_M_DEC_BATCH_FRAMES = _counter("decoder.batch.frames")
_M_DEC_RC_FRAMES = _counter("decoder.reconcile.frames")
_M_DEC_SN_FRAMES = _counter("decoder.snapshot.frames")
# bytes a batch frame saved against the same rows per record
_M_BATCH_SAVED_RX = _counter("wire.batch.bytes_saved_rx")
_H_DEC_DISPATCH = _histogram("decoder.dispatch.seconds")

# The bulk route's cursor: frame index and columnar row MUST advance
# together — a frame paired with the wrong row's columns is silent wire
# corruption.  Machine-checked:
# datlint: coupled-state st["f"], st["row"]


class DecoderDestroyedError(Exception):
    pass


class BlobReader:
    """Read side of one streamed blob, handed to the app's blob handler.

    Chunks arrive through :meth:`on_data`; chunks parsed before a data
    callback is registered are buffered and replayed at registration.
    :meth:`pause` / :meth:`resume` stop and restart parsing (per-chunk
    backpressure).
    """

    def __init__(self, decoder: "Decoder", length: int):
        self._decoder = decoder
        self.length = length
        self.received = 0
        self.ended = False
        self.destroyed = False
        self._data_cb: Optional[Callable[[bytes], None]] = None
        self._end_cbs: list[Callable[[], None]] = []
        self._buffered: list[bytes] = []
        self._paused = False
        # blob-level ack pairing (see Decoder._open_blob_if_ready)
        self._latch = {"ended": False, "acked": False}

    def on_data(self, cb: Callable[[bytes], None]) -> "BlobReader":
        self._data_cb = cb
        if self._buffered:
            chunks, self._buffered = self._buffered, []
            for c in chunks:
                cb(c)
        return self

    def on_end(self, cb: Callable[[], None]) -> "BlobReader":
        if self.ended:
            cb()
        else:
            self._end_cbs.append(cb)
        return self

    def collect(self, cb: Callable[[bytes], None]) -> "BlobReader":
        """Buffer the whole blob and deliver it once on end."""
        parts: list[bytes] = []
        self.on_data(parts.append)
        self.on_end(lambda: cb(b"".join(parts)))
        return self

    def pause(self) -> None:
        if self._paused:
            return
        self._paused = True
        self._decoder._paused_readers += 1

    def resume(self) -> None:
        if not self._paused:
            return
        self._paused = False
        self._decoder._paused_readers -= 1
        self._decoder._resume()

    def destroy(self, err: Exception | None = None) -> None:
        """Destroying a blob reader tears down the whole session."""
        if self.destroyed:
            return
        self.destroyed = True
        self._decoder.destroy(err)

    def _deliver(self, chunk: bytes) -> None:
        self.received += len(chunk)
        if self._data_cb is not None:
            self._data_cb(chunk)
        else:
            self._buffered.append(chunk)

    def _finish(self) -> None:
        self.ended = True
        cbs, self._end_cbs = self._end_cbs, []
        for cb in cbs:
            cb()


class _FastAck:
    """One-shot ``done`` for a change handler: the pending counter is
    only taken if the handler did NOT ack before returning, and never if
    it raised, so a raise consumes its change and later frames still
    deliver (the reference decoder's ``_FastAck``).

    States: 0 fresh -> 1 acked before the handler returned (no pending
    ever taken) / 2 armed (the handler kept it; pending taken by the
    delivery site) -> 3 done (pending released).  Transitions run under
    the decoder's ``_ack_lock``, so an ack from another thread between
    the handler returning and the arming is neither lost nor counted
    twice.
    """

    __slots__ = ("dec", "state")

    def __init__(self, dec: "Decoder") -> None:
        self.dec = dec
        self.state = 0

    def __call__(self) -> None:
        dec = self.dec
        with dec._ack_lock:
            st = self.state
            if st == 0:
                self.state = 1  # acked before the handler returned
                return
            if st != 2:
                return  # a second ack is a no-op
            self.state = 3
            dec._pending -= 1
        dec._resume()

    def arm(self) -> None:
        """After the handler returned: take pending unless it acked."""
        if self.state != 1:
            dec = self.dec
            with dec._ack_lock:
                if self.state == 0:
                    self.state = 2
                    dec._pending += 1


def _drain_blob(blob: BlobReader, done: Callable[[], None]) -> None:
    """Default blob handler: consume and discard (decode.js:58-61)."""
    blob.on_data(lambda _chunk: None)
    blob.on_end(done)


class Decoder:
    """Push-based incremental wire parser.  See module docstring."""

    # the wire cost ledger's link name for this session's rx bytes
    cost_link = "session"

    def __init__(self, native: bool = True):
        self._native = native  # the bulk-index route (module docstring)
        self.bytes = 0
        self.changes = 0
        self.blobs = 0
        self.destroyed = False
        self.finished = False
        self._on_change: Callable[[Change, Callable[[], None]], None] | None = None
        self._on_change_batch = None  # whole-batch columnar handler
        self._on_reconcile = None  # whole-frame reconcile messages
        self._on_snapshot = None  # whole-frame snapshot messages
        # negotiated control frames delivered (each ONE frame)
        self.reconcile_frames = 0
        self.snapshot_frames = 0
        self._on_blob: Callable[[BlobReader, Callable[[], None]], None] | None = None
        self._on_finalize: Callable[[Callable[[], None]], None] | None = None
        self._error_cbs: list[Callable[[Exception | None], None]] = []
        self._finish_cbs: list[Callable[[], None]] = []

        # parser state
        self._state = TYPE_HEADER
        self._header = bytearray()  # accumulating varint + id bytes
        self._missing = 0  # payload bytes still to consume
        self._payload_parts: list[bytes] | None = None  # change split across chunks
        self._current_blob: BlobReader | None = None
        # wire offsets of the frame being parsed and of the next one:
        # frames tile the wire, so each header adds its frame's length
        self._frame_start = 0
        self._frame_end = 0
        # wire bytes the parser fully consumed (bytes minus what still
        # sits unparsed in the overflow queue): the watermark's
        # ``parsed`` cursor
        self._parsed = 0
        # the wire offset of the last exported checkpoint
        self._ckpt_offset = 0
        # parked ChangeBatch delivery cursor: a batch whose rows could not
        # all be delivered (async ack / pause) resumes here, and nothing
        # after it is parsed until it drains
        self._pbatch: dict | None = None
        # a ChangeBatch is ONE frame whatever its rows: these take its
        # rows back out of ``changes`` when counting frames
        self._batch_rows_seen = 0
        self._batch_frames_done = 0

        # flow control
        self._pending = 0
        self._paused_readers = 0
        self._overflow: deque[memoryview] = deque()  # unparsed input, in order
        self._overflow_bytes = 0  # running total of the deque's bytes
        self._bulk: dict | None = None  # parked native frame-index cursor
        self._write_cbs: list[Callable[[], None]] = []
        self._end_queued = False
        self._end_cb: OnDone = None
        self._consuming = False  # reentrancy guard for _consume
        # persistent wakeups fired whenever a stall clears (transport pumps)
        self._drain_watchers: list[Callable[[], None]] = []
        # serializes the pending counter against acks from other threads
        self._ack_lock = threading.Lock()
        # the C loop's outstanding-ack counter (dat_fastpath.AckBoard),
        # made the first time the C loop runs
        self._ack_board = None
        # runs of change frames the C loop dispatched
        self.change_runs = 0

    # -- handler registration -------------------------------------------------

    def change(self, cb: Callable[[Change, Callable[[], None]], None]) -> "Decoder":
        self._on_change = cb
        return self

    def reconcile(self, cb) -> "Decoder":
        """Register the reconcile-message handler: ``cb(msg, done)``
        receives each ``TYPE_RECONCILE`` frame's decoded
        :class:`~..wire.reconcile_codec.ReconcileMsg` and one ``done``
        per frame.  Without a handler, reconcile frames are dropped, the
        never-deadlock default of unhandled changes."""
        self._on_reconcile = cb
        return self

    def snapshot(self, cb) -> "Decoder":
        """Register the snapshot-message handler: ``cb(msg, done)``
        receives each ``TYPE_SNAPSHOT`` frame's decoded
        :class:`~..wire.snapshot_codec.SnapshotMsg` and one ``done`` per
        frame.  Without a handler, snapshot frames are dropped."""
        self._on_snapshot = cb
        return self

    def change_batch(self, cb) -> "Decoder":
        """Register a whole-batch handler: ``cb(cols, done)`` receives a
        negotiated ``ChangeBatch`` frame's decoded columns (a
        :class:`~..runtime.replay.ChangeColumns`: ``len()`` rows,
        ``row(i)`` lazy materialization, numpy columns for bulk work) and
        ONE ``done`` for the whole frame.  Without this handler, batch
        rows go to the per-record :meth:`change` handler one
        :class:`Change` at a time, the stream a per-record peer gives.
        Per-record frames always go to :meth:`change`."""
        self._on_change_batch = cb
        return self

    @staticmethod
    def capabilities() -> int:
        """The capability mask this decoder parses: what a receiver
        advertises during session setup."""
        return LOCAL_CAPS

    def blob(self, cb: Callable[[BlobReader, Callable[[], None]], None]) -> "Decoder":
        self._on_blob = cb
        return self

    def finalize(self, cb: Callable[[Callable[[], None]], None]) -> "Decoder":
        self._on_finalize = cb
        return self

    def on_error(self, cb: Callable[[Exception | None], None]) -> "Decoder":
        self._error_cbs.append(cb)
        return self

    def on_finish(self, cb: Callable[[], None]) -> "Decoder":
        if self.finished:
            cb()
        else:
            self._finish_cbs.append(cb)
        return self

    # -- write side -----------------------------------------------------------

    def write(self, data, on_consumed: OnDone = None) -> bool:
        """Feed wire bytes.  True if fully consumed synchronously; False
        if parsing stalled on an outstanding ``done`` (``on_consumed``
        then fires when the app drains)."""
        if self.destroyed:
            raise DecoderDestroyedError("write after destroy")
        if self.finished or self._end_queued:
            raise DecoderDestroyedError("write after end")
        data = memoryview(data.encode("utf-8") if isinstance(data, str) else data)
        self.bytes += len(data)
        if len(data):
            self._overflow.append(data)
            self._overflow_bytes += len(data)
        # park the completion callback BEFORE consuming: _consume's
        # drained epilogue is the one place parked callbacks fire
        entry = None
        if on_consumed is not None:
            entry = lambda cb=on_consumed: cb()  # noqa: E731
            self._write_cbs.append(entry)
        if _OBS.on:
            _M_DEC_BYTES.inc(len(data))
            t0 = _perf()
            try:
                self._consume()
            finally:
                _H_DEC_DISPATCH.observe(_perf() - t0)
        else:
            self._consume()
        if entry is not None:
            return entry not in self._write_cbs  # fired <=> consumed
        return not (self._overflow or self._bulk is not None
                    or self._stalled())

    def write_indexed(self, data, starts, lens, ids, n: int,
                      consumed: int) -> bool:
        """Feed wire bytes with their frame index, made by the wire pump's
        GIL-released receive (``session/pump.py``, ``dat_pump_recv_scan``
        runs ``dat_split_frames`` over ``data``): the index installs as
        the bulk cursor without a second scan.  Returns what
        :meth:`write` returns.

        Only at a clean frame boundary with nothing queued or parked, and
        only on the native route; anything else, and an empty index, takes
        :meth:`write`, which gives the same deliveries.  The cursor keeps
        views of ``starts``/``lens``/``ids`` while it is parked, so the
        caller must not refill them until :meth:`writable` (the pumps wait
        for it before their next receive)."""
        if (not self._native or n <= 0 or self._overflow
                or self._bulk is not None or self._pbatch is not None
                or self._state != TYPE_HEADER or self._header
                or self._consuming or self._stalled()):
            return self.write(data)
        if self.destroyed:
            raise DecoderDestroyedError("write after destroy")
        if self.finished or self._end_queued:
            raise DecoderDestroyedError("write after end")
        import numpy as np

        buf = memoryview(data)
        self.bytes += len(buf)
        self._install_index(buf, np.frombuffer(buf, dtype=np.uint8),
                            starts, lens, ids, n, consumed)
        if _OBS.on:
            _M_DEC_BYTES.inc(len(buf))
            t0 = _perf()
            try:
                self._consume()
            finally:
                _H_DEC_DISPATCH.observe(_perf() - t0)
        else:
            self._consume()
        return not (self._overflow or self._bulk is not None
                    or self._pbatch is not None or self._stalled())

    def end(self, on_finished: OnDone = None) -> None:
        """Graceful end: after all prior frames are consumed, the finalize
        handler runs, then the session finishes."""
        if self.destroyed:
            raise DecoderDestroyedError("end after destroy")
        if self._end_queued or self.finished:
            return
        self._end_queued = True
        self._end_cb = on_finished
        self._maybe_finalize()

    def destroy(self, err: Exception | None = None) -> None:
        """Fail-fast teardown, cascading to a live blob reader."""
        if self.destroyed:
            return
        self.destroyed = True
        blob, self._current_blob = self._current_blob, None
        if blob is not None:
            blob.destroyed = True
        self._overflow.clear()
        self._overflow_bytes = 0
        self._bulk = None
        for cb in self._error_cbs:
            cb(err)
        # release parked write callbacks and watchers so a blocked
        # transport wakes and observes the destroyed state
        cbs, self._write_cbs = self._write_cbs, []
        for cb in cbs:
            cb()
        self._notify_drain_watchers()

    def writable(self) -> bool:
        return not (self._stalled() or self._overflow
                    or self._bulk is not None or self.destroyed
                    or self.finished)

    # -- drain watchers -------------------------------------------------------

    def _add_drain_watcher(self, cb: Callable[[], None]) -> None:
        self._drain_watchers.append(cb)

    def _remove_drain_watcher(self, cb: Callable[[], None]) -> None:
        if cb in self._drain_watchers:
            self._drain_watchers.remove(cb)

    def _notify_drain_watchers(self) -> None:
        for cb in list(self._drain_watchers):
            cb()

    def _frames_delivered(self) -> int:
        """Frames fully delivered, the frame index of structured errors.
        Blobs count at open (a blob mid-payload is the frame being
        parsed); a ChangeBatch is ONE frame, counted at full delivery; a
        reconcile or snapshot frame counts once, at delivery."""
        return (self.changes - self._batch_rows_seen
                + self._batch_frames_done + self.blobs
                + self.reconcile_frames + self.snapshot_frames
                - (1 if self._current_blob is not None else 0))

    def checkpoint(self, emit_event: bool = True):
        """Export this instant's session progress (resume support).

        Cheap and side-effect-free: a :class:`~.resume.SessionCheckpoint`
        whose ``wire_offset`` is the count of wire bytes this decoder has
        accepted, the exact byte a reconnecting sender must resume from
        (parser state, including mid-frame cursors and unparsed overflow,
        lives on in this object).  The frame/row/blob cursors and the
        backend digest state ride along for observability and structured
        error context.

        ``emit_event=False`` skips the ``session.checkpoint`` event: the
        flight recorder snapshots a checkpoint as bundle context, which
        is not a resume point taken.
        """
        from .resume import SessionCheckpoint

        self._ckpt_offset = self.bytes
        if emit_event and _OBS.on:
            _emit("session.checkpoint", wire_offset=self.bytes,
                  frame=self._frames_delivered(), row=self.changes)
        blob = self._current_blob
        return SessionCheckpoint(
            wire_offset=self.bytes,
            frame=self._frames_delivered(),
            row=self.changes,
            blob_offset=blob.received if blob is not None else 0,
            digest=self._checkpoint_digest(),
        )

    def watermark(self, link: str) -> None:
        """Export this decoder's wire-position cursors on the fleet
        plane under ``link``: ``accepted`` (bytes taken from the
        transport, the resume point), ``parsed`` (bytes the parser fully
        consumed) and ``checkpoint`` (the last exported resume point).
        Values are read only at snapshot time, so the hot path pays
        nothing.  Call ``WATERMARKS.untrack(link)`` when the session
        ends."""
        _WATERMARKS.track("accepted", link, lambda: self.bytes)
        _WATERMARKS.track("parsed", link, lambda: self._parsed)
        _WATERMARKS.track("checkpoint", link, lambda: self._ckpt_offset)

    def _checkpoint_digest(self) -> dict:
        """Backend hook: running digest state to carry in a checkpoint
        (the digest decoder records its sequence counters).  Base: no
        digest surface, nothing to record."""
        return {}

    def _protocol_error(self, message: str,
                        cause: BaseException | None = None) -> ProtocolError:
        """The structured wire error, and the flight recorder's hook:
        every decoder-side wire error funnels through here, so an armed
        recorder dumps its bundle before ``destroy`` clears the state."""
        err = ProtocolError(message, frame=self._frames_delivered(),
                            offset=self.bytes, cause=cause)
        if _OBS.on:
            _M_DEC_ERRORS.inc()
            _emit("protocol.error", frame=err.frame, offset=err.offset,
                  message=message)
            self._lit_cost_failure(message)
        if _FLIGHT.armed:
            _FLIGHT.dump("protocol-error", error=err,
                         checkpoint=self.checkpoint(emit_event=False))
        return err

    # -- flow control -----------------------------------------------------------

    def _stalled(self) -> bool:
        if self._pending > 0 or self._paused_readers > 0:
            return True
        board = self._ack_board
        return board is not None and board.outstanding > 0

    def _resume(self) -> None:
        # a nested resume while _consume is live is a no-op: the outer
        # loop keeps going and runs the drained epilogue itself
        if self.destroyed or self._stalled():
            return
        self._notify_drain_watchers()
        if self._consuming:
            return
        self._consume()

    def _maybe_finalize(self) -> None:
        if (not self._end_queued or self.finished or self.destroyed
                or self._overflow or self._bulk is not None
                or self._pbatch is not None or self._stalled()
                or self._consuming):
            return
        if self._state != TYPE_HEADER or self._header:
            self.destroy(self._protocol_error("stream ended mid-frame"))
            return
        self._end_queued = False  # run once

        def finish() -> None:
            self.finished = True
            cb, self._end_cb = self._end_cb, None
            if cb is not None:
                cb()
            cbs, self._finish_cbs = self._finish_cbs, []
            for fcb in cbs:
                fcb()

        if self._on_finalize is not None:
            self._on_finalize(finish)
        else:
            finish()

    # -- parser -------------------------------------------------------------------

    # the native route indexes a queued buffer once this many bytes wait
    # at a frame boundary: below it the index's array set-up costs more
    # than the per-byte scan saves (the JAX package measured 2048 against
    # a transport writing 4 KiB chunks)
    _NATIVE_MIN = 2048

    def _consume(self) -> None:
        """Drain queued input while the app keeps up (decode.js:144-169).

        On the native route, once at least :attr:`_NATIVE_MIN` bytes are
        queued and the parser sits at a frame boundary, the whole queue
        is indexed in one call and frames dispatch from the index
        (:meth:`_start_indexed`, :meth:`_run_indexed`); the streaming
        scanner takes split headers, partial frames and small writes."""
        if self._consuming:
            return
        self._consuming = True
        try:
            while not self._stalled() and not self.destroyed:
                if self._pbatch is not None:
                    # resume a parked ChangeBatch from its row cursor
                    self._run_pending_batch()
                    if self._pbatch is not None:
                        return  # still stalled mid-batch
                    continue
                if self._bulk is not None:
                    # resume a parked index from its cursor: an async ack
                    # must not re-index (and re-decode) the remainder,
                    # which would make bulk decode O(frames^2)
                    self._run_indexed()
                    continue
                if not self._overflow:
                    break
                if (self._native and self._state == TYPE_HEADER
                        and not self._header
                        # O(1) size gate before the merge: the merge
                        # copies the whole queue
                        and self._overflow_bytes >= self._NATIVE_MIN):
                    merged = self._merged_overflow()
                    if self._start_indexed(merged):
                        continue
                    # no complete frame in the queue (a large frame still
                    # arriving): the scanner enters it and consumes its
                    # payload as it comes
                    self._ov_appendleft(merged)
                chunk = self._overflow.popleft()
                self._overflow_bytes -= len(chunk)
                rest = self._consume_chunk(chunk)
                if self.destroyed:
                    return
                if rest is not None and len(rest):
                    self._ov_appendleft(rest)
        finally:
            self._consuming = False
        # fully drained and nothing outstanding: release parked writers
        # and run a queued finalization
        if (not self.destroyed and not self._overflow
                and self._bulk is None and self._pbatch is None
                and not self._stalled()):
            cbs, self._write_cbs = self._write_cbs, []
            for cb in cbs:
                cb()
            self._maybe_finalize()
            self._notify_drain_watchers()

    def _requeue_tail(self, rest) -> None:
        """A handler raised while the chunk's unparsed remainder lived in
        a local: requeue it so a caught raise-then-resume continues with
        the next frame."""
        if len(rest):
            if _OBS.on:
                _M_DEC_REQUEUES.inc()
                _emit("decoder.requeue", bytes=len(rest),
                      offset=self.bytes)
            self._ov_appendleft(rest)

    def _ov_appendleft(self, mv: memoryview) -> None:
        self._overflow.appendleft(mv)
        self._overflow_bytes += len(mv)

    def _merged_overflow(self) -> memoryview:
        """Pop ALL queued input as one contiguous memoryview."""
        if len(self._overflow) == 1:
            merged = self._overflow.popleft()
        else:
            merged = memoryview(b"".join(self._overflow))
            self._overflow.clear()
        self._overflow_bytes = 0
        return merged

    # -- the native bulk-index route -------------------------------------------

    # Subclass opt-in to the C change loop: when True IN THE CLASS'S OWN
    # __dict__ (the opt-in does not inherit), runs of change frames
    # dispatch from the C loop even though _deliver_change is overridden,
    # and the raw payloads of every run are handed to
    # _note_change_payloads afterwards (the digest decoder's tap).  The
    # declaring class's only per-change addition must be payload work
    # that no handler sees.
    _bulk_payload_sink = False

    def _note_change_payloads(self, payloads, count: int) -> None:
        """Bulk tap: ``payloads`` is the in-order list of raw payloads of
        the run just dispatched (None when :meth:`_payload_sink_active`
        is False), ``count`` the changes it dispatched.  Called after
        every C run on an opted-in class.  Base: no-op."""

    def _payload_sink_active(self) -> bool:
        """Whether the tap collects payloads (slicing costs per frame);
        sequence accounting happens either way."""
        return True

    def _start_indexed(self, buf: memoryview) -> bool:
        """Index ``buf``'s complete frames in one ``dat_split_frames``
        call and park the cursor.  False when there is no complete frame.

        A malformed header only stops the scan: the valid prefix
        dispatches from the index and the streaming scanner meets the
        bad header in the tail, raising there what it raises on any
        chunking."""
        import numpy as np

        from ..runtime import native

        arr = np.frombuffer(buf, dtype=np.uint8)
        n, starts, lens, ids, consumed, _ = native.split_frames(arr)
        if n <= 0:
            return False
        self._install_index(buf, arr, starts, lens, ids, n, consumed)
        return True

    def _install_index(self, buf, arr, starts, lens, ids, n: int,
                       consumed: int) -> None:
        """Park a frame index over ``buf`` as the bulk cursor, with the
        change payloads pre-decoded to columns in one serial
        ``dat_decode_changes`` call when the index holds at least 16.  A
        corrupt payload leaves no columns: the per-frame decode then
        delivers the records before it and raises its own error."""
        import numpy as np

        from ..runtime import native

        cols_np = None
        cidx = np.nonzero(ids[:n] == TYPE_CHANGE)[0]
        m = len(cidx)
        if m >= 16:
            cols = (np.empty(m, np.uint32), np.empty(m, np.uint32),
                    np.empty(m, np.uint32), *(np.empty(m, np.int64)
                                              for _ in range(6)))
            if native.decode_changes_serial(
                    arr, np.ascontiguousarray(starts[cidx]),
                    np.ascontiguousarray(lens[cidx]), cols) < 0:
                # the C loop reads these buffers directly; the Python
                # loop gets row tuples lazily (_cols_lists)
                cols_np = cols
        self._bulk = {
            "buf": buf,
            # wire offset of buf[0]: the indexed buffer is exactly the
            # unparsed queue, so it starts where parsing stood
            "base": self._frame_end,
            "starts": starts[:n].tolist(),
            "lens": lens[:n].tolist(),
            "ids": ids[:n].tolist(),
            "ids_np": np.ascontiguousarray(ids[:n]),
            "starts_np": np.ascontiguousarray(starts[:n]),
            "lens_np": np.ascontiguousarray(lens[:n]),
            "n": n,
            "consumed": consumed,
            "f": 0,
            "row": 0,
            "cols_np": cols_np,
            "blob_open": False,
        }

    @staticmethod
    def _cols_lists(st: dict):
        """Python-loop view of the columnar decode: one tuple per row
        (made lazily; the C loop never needs it)."""
        rows = st.get("zrows")
        if rows is None and st["cols_np"] is not None:
            rows = st["zrows"] = list(
                zip(*(a.tolist() for a in st["cols_np"])))
        return rows

    def _run_indexed(self) -> None:
        """Dispatch frames from the parked index until done or stalled.

        Each frame goes through the streaming route's change, batch,
        control and blob machinery (counters, ordering, blob latches,
        zero-length blobs), with the frame's wire extent set first for
        the tracing tags and wire cost.  Runs of change frames take the C
        loop (:meth:`_dispatch_changes_fast`) when the columns exist and
        ``_deliver_change`` is not overridden (or the class opted in with
        ``_bulk_payload_sink``).  Delivery consumes a frame: both cursor
        halves advance before a handler can raise, and every exit writes
        them back together, so a caught raise resumes at the next frame.
        """
        st = self._bulk
        buf = st["buf"]
        starts, lens, ids = st["starts"], st["lens"], st["ids"]
        base = st["base"]
        have_cols = st["cols_np"] is not None
        rows_l = self._cols_lists(st) if have_cols else None
        f = st["f"]
        row = st["row"]
        n = st["n"]
        cls = type(self)
        # the opt-in is read from the class's own __dict__: a subclass
        # overriding _deliver_change would otherwise lose its override on
        # bulk writes and keep it on chunked ones
        fast = have_cols and (
            cls._deliver_change is Decoder._deliver_change
            or cls.__dict__.get("_bulk_payload_sink", False))
        try:
            while f < n:
                if self._stalled() or self.destroyed:
                    return
                type_id = ids[f]
                if fast and type_id == TYPE_CHANGE:
                    try:
                        # the C loop writes both cursors into st, on its
                        # raise path too: st is the one hand-off channel
                        self._dispatch_changes_fast(st, f)
                    finally:
                        f, row = st["f"], st["row"]
                    if self.destroyed:
                        self._bulk = None
                        return
                    continue
                start = starts[f]
                flen = lens[f]
                self._missing = flen
                # this frame's wire extent (starts[] points past the id
                # byte): the tracing tags and wire cost read it
                self._frame_start = base + start - _header_len(flen)
                self._frame_end = base + start + flen
                if type_id == TYPE_CHANGE:
                    row += 1
                    f += 1
                    if have_cols:
                        (cg, fr, to, ko, kl, so, sl, vo, vl) = rows_l[row - 1]
                        # the C decode checked every key and subset
                        change = Change(
                            key=str(buf[ko: ko + kl], "utf-8"),
                            change=cg, from_=fr, to=to,
                            value=bytes(buf[vo: vo + vl]) if vl >= 0 else b"",
                            subset=(str(buf[so: so + sl], "utf-8")
                                    if sl >= 0 else ""))
                        self._parsed = self._frame_end
                        self._missing = 0
                        self._deliver_change(change, buf[start: start + flen])
                    else:
                        self._parsed = base + start
                        self._state = TYPE_CHANGE
                        self._payload_parts = None
                        self._change_data(buf[start: start + flen])
                elif type_id == TYPE_CHANGE_BATCH:
                    f += 1
                    self._parsed = self._frame_end
                    self._missing = 0
                    self._finish_change_batch(buf[start: start + flen])
                    if self.destroyed:
                        self._bulk = None
                        return
                    if self._pbatch is not None or self._stalled():
                        return
                elif type_id == TYPE_RECONCILE or type_id == TYPE_SNAPSHOT:
                    f += 1
                    self._parsed = self._frame_end
                    self._missing = 0
                    if type_id == TYPE_RECONCILE:
                        self._finish_reconcile(buf[start: start + flen])
                    else:
                        self._finish_snapshot(buf[start: start + flen])
                    if self.destroyed:
                        self._bulk = None
                        return
                    if self._stalled():
                        return
                elif type_id == TYPE_BLOB:
                    if not st["blob_open"]:
                        self._state = TYPE_BLOB
                        # the opened state advances WITH the side effect:
                        # a blob handler that raises must not re-open
                        # (and re-count) the blob on resume
                        st["blob_open"] = True
                        self._parsed = base + start
                        self._open_blob_if_ready()
                        if self.destroyed:
                            self._bulk = None
                            return
                        # a handler that paused must not get the payload
                        # until it resumes, as on the streaming route
                        if flen and self._stalled():
                            return
                    st["blob_open"] = False
                    f += 1
                    if flen:
                        self._parsed = base + start
                        self._blob_data(buf[start: start + flen])
                else:
                    self._bulk = None
                    self._parsed = base + start
                    self.destroy(self._protocol_error(
                        f"Protocol error, unknown type: {type_id}"))
                    return
                if self.destroyed:
                    self._bulk = None
                    return
        finally:
            # one write-back for every exit (returns, handler raises,
            # stalls): the cursor halves leave together
            st["f"] = f
            st["row"] = row
        self._bulk = None
        # the run retired: the parser stands at the end of the index
        self._parsed = self._frame_end = base + st["consumed"]
        tail = buf[st["consumed"]:]
        if len(tail):
            self._ov_appendleft(tail)

    def _dispatch_changes_fast(self, st: dict, f: int) -> None:
        """Deliver the run of change frames starting at ``f`` from the C
        loop (``dat_fastpath.dispatch_changes``): one slot-built
        :class:`Change` from the columns, one C ``done`` and one handler
        call a frame, ``self.changes`` counted before each call.  The
        loop stops at a non-change frame, a stall or the index's end and
        writes both cursors into ``st``.  Handler exceptions propagate as
        themselves; a payload that fails UTF-8 comes back as status 2 and
        destroys the session with its error as the cause.  The run gets
        one ``decoder.frame.run`` instant and one wire-cost entry, and
        the C call one ``decoder.change_run`` span; ``change_runs``
        counts the runs."""
        use_tap = type(self).__dict__.get("_bulk_payload_sink", False)
        collect = use_tap and self._payload_sink_active()
        f0 = f
        fp = _fastpath_mod()
        if self._ack_board is None:
            self._ack_board = fp.AckBoard()
        sink = [] if collect else None
        status = 0
        self.change_runs += 1
        try:
            with _span("decoder.change_run"):
                _, _, status = fp.dispatch_changes(
                    self, self._ack_board, self._on_change, Change,
                    st["buf"], st["ids_np"], *st["cols_np"], f, st["row"],
                    st["n"], st, st["starts_np"] if collect else None,
                    st["lens_np"] if collect else None, sink)
        finally:
            # the run sits at a frame boundary throughout; the tap drains
            # even when a handler raised (those changes WERE delivered,
            # so their digests are owed)
            self._missing = 0
            self._state = TYPE_HEADER
            k = st["f"] - f0
            if k:
                self._note_change_run(st, f0, k)
            if use_tap:
                self._note_change_payloads(sink, k)
        if status == 2:
            e = st.pop("decode_error")
            self.destroy(self._protocol_error(str(e), cause=e))

    def _note_change_run(self, st: dict, f0: int, k: int) -> None:
        """Cursor and telemetry of ``k`` change frames from ``f0`` that
        the C loop dispatched."""
        starts, lens, base = st["starts"], st["lens"], st["base"]
        last = f0 + k - 1
        self._frame_start = base + starts[last] - _header_len(lens[last])
        self._frame_end = self._parsed = base + starts[last] + lens[last]
        if _OBS.on:
            _M_DEC_CHANGES.inc(k)
            off0 = base + starts[f0] - _header_len(lens[f0])
            # one tag for the run (the C loop cannot tag per frame),
            # covering the run's contiguous wire range
            _trace_instant("decoder.frame.run", offset=off0, kind="change",
                           frames=k, wire_len=self._frame_end - off0)
            self._lit_cost_change_run(self._frame_end - off0,
                                      sum(lens[f0:f0 + k]), k)

    def _consume_chunk(self, chunk: memoryview) -> memoryview | None:
        if self._state == TYPE_HEADER:
            return self._scan_header(chunk)
        if self._state == TYPE_CHANGE:
            return self._change_data(chunk)
        if self._state == TYPE_CHANGE_BATCH:
            return self._batch_data(chunk)
        if self._state == TYPE_RECONCILE:
            return self._sized_payload_data(chunk, self._finish_reconcile)
        if self._state == TYPE_SNAPSHOT:
            return self._sized_payload_data(chunk, self._finish_snapshot)
        return self._blob_data(chunk)

    def _scan_header(self, chunk: memoryview) -> memoryview | None:
        """Byte-at-a-time varint scan; the byte after the varint is the
        type id (decode.js:251-262).  Bounded at MAX_HEADER_LEN."""
        i = 0
        n = len(chunk)
        while i < n:
            self._header.append(chunk[i])
            i += 1
            if len(self._header) >= 2 and not (self._header[-2] & 0x80):
                self._parsed += i
                try:
                    framed_len, _ = decode_uvarint(self._header)
                except ValueError as e:  # varint exceeds 64 bits
                    self.destroy(self._protocol_error(str(e), cause=e))
                    return None
                type_id = self._header[-1]
                self._frame_start = self._frame_end
                self._frame_end += len(self._header) + framed_len - 1
                self._header.clear()
                self._missing = framed_len - 1  # length counts the id byte
                if framed_len < 1:
                    self.destroy(self._protocol_error("frame length must be >= 1"))
                    return None
                if type_id == TYPE_CHANGE:
                    self._state = TYPE_CHANGE
                    self._payload_parts = None
                elif type_id in (TYPE_CHANGE_BATCH, TYPE_RECONCILE,
                                 TYPE_SNAPSHOT):
                    self._state = type_id
                    self._payload_parts = None
                elif type_id == TYPE_BLOB:
                    self._state = TYPE_BLOB
                    try:
                        self._open_blob_if_ready()
                    except BaseException:
                        self._requeue_tail(chunk[i:])
                        raise
                else:
                    self.destroy(self._protocol_error(
                        f"Protocol error, unknown type: {type_id}"))
                    return None
                return chunk[i:]
            if len(self._header) >= MAX_HEADER_LEN:
                self._parsed += i
                self.destroy(self._protocol_error("frame header too long"))
                return None
        self._parsed += n  # header still accumulating across chunks
        return None

    def _change_data(self, chunk: memoryview) -> memoryview | None:
        return self._sized_payload_data(chunk, self._finish_change)

    def _sized_payload_data(self, chunk: memoryview,
                            finish) -> memoryview | None:
        """Accumulate one whole-payload frame across transport chunks and
        hand the complete payload to ``finish`` (change and ChangeBatch
        frames)."""
        if self._payload_parts is None and len(chunk) >= self._missing:
            # whole payload inside one chunk: zero-copy slice
            payload = chunk[: self._missing]
            rest = chunk[self._missing:]
            self._parsed += self._missing
            self._missing = 0
            try:
                finish(payload)
            except BaseException:
                self._requeue_tail(rest)
                raise
            return rest
        if self._payload_parts is None:
            self._payload_parts = []
        take = min(len(chunk), self._missing)
        self._payload_parts.append(bytes(chunk[:take]))
        self._parsed += take
        self._missing -= take
        rest = chunk[take:]
        if self._missing == 0:
            parts, self._payload_parts = self._payload_parts, None
            try:
                finish(b"".join(parts))
            except BaseException:
                self._requeue_tail(rest)
                raise
        return rest

    def _finish_change(self, payload) -> None:
        try:
            change = decode_change(payload, native=self._native)
        except ValueError as e:
            self.destroy(self._protocol_error(str(e), cause=e))
            return
        self._deliver_change(change, payload)

    def _deliver_change(self, change: Change, payload) -> None:
        """Deliver one decoded change: the single hook subclasses adding
        per-change work (the digest backend) override."""
        self.changes += 1
        if _OBS.on:
            _M_DEC_CHANGES.inc()
            _trace_instant("decoder.frame", offset=self._frame_start,
                           kind="change",
                           wire_len=self._frame_end - self._frame_start)
            self._lit_cost_change(len(payload))
        self._state = TYPE_HEADER
        if self._on_change is not None:
            ack = _FastAck(self)
            self._on_change(change, ack)
            ack.arm()
        # default: drop (decode.js:54-56)

    # -- ChangeBatch frames ----------------------------------------------------

    def _batch_data(self, chunk: memoryview) -> memoryview | None:
        return self._sized_payload_data(chunk, self._finish_change_batch)

    def _finish_change_batch(self, payload) -> None:
        """Decode one complete ChangeBatch payload and start delivering
        its rows.  A structurally corrupt payload (bad width, truncated
        column, out-of-range index, non-UTF-8 dictionary) destroys the
        session with a ProtocolError, as a corrupt Change payload does."""
        from ..wire import batch_codec

        try:
            cols = batch_codec.decode_change_batch(payload)
        except ValueError as e:
            self.destroy(self._protocol_error(str(e), cause=e))
            return
        n = len(cols.change)
        if _OBS.on:
            _M_DEC_BATCH_FRAMES.inc()
            _trace_instant("decoder.frame", offset=self._frame_start,
                           kind="change_batch", rows=n,
                           wire_len=self._frame_end - self._frame_start)
            # the receiver prices the savings with the encoder's exact
            # arithmetic, so both ends' counters agree to the byte
            saved = int(batch_codec.estimate_per_record_bytes(
                cols.key_len, cols.sub_len, cols.val_len, cols.change,
                cols.from_, cols.to)) - (self._frame_end - self._frame_start)
            if saved > 0:
                _M_BATCH_SAVED_RX.inc(saved)
            self._lit_cost_batch(len(payload), saved)
        self._state = TYPE_HEADER
        # digest tap: the whole frame's rows are owed at acceptance, before
        # any row reaches a handler, keeping submit order = wire order
        self._note_change_batch(cols, n)
        self._pbatch = {"cols": cols, "row": 0, "n": n, "bbuf": None}
        self._run_pending_batch()

    def _note_change_batch(self, cols, n: int) -> None:
        """Hook: one call per accepted ChangeBatch frame with its decoded
        columns, before any row is delivered (the digest decoder submits
        each row's canonical per-record encoding here).  Base: no-op."""

    def _run_pending_batch(self) -> None:
        """Deliver rows from the parked batch cursor until done or
        stalled: the columns whole to a ``change_batch`` handler, else
        one :class:`Change` a row to the ``change`` handler."""
        pb = self._pbatch
        cols, n, row = pb["cols"], pb["n"], pb["row"]
        on_batch = self._on_change_batch
        if on_batch is not None and row == 0:
            # whole-batch delivery: one handler call, one ack
            self._pbatch = None
            self.changes += n
            self._batch_rows_seen += n
            self._batch_frames_done += 1
            if _OBS.on:
                _M_DEC_CHANGES.inc(n)
            ack = _FastAck(self)
            on_batch(cols, ack)
            ack.arm()
            return
        on_change = self._on_change
        if on_change is None:
            # no handler: rows drop (decode.js:54-56); the payload was
            # already structurally validated at decode
            k = n - row
            self._pbatch = None
            self.changes += k
            self._batch_rows_seen += k
            self._batch_frames_done += 1
            if _OBS.on and k:
                _M_DEC_CHANGES.inc(k)
            return
        if pb["bbuf"] is None:
            pb["bbuf"] = cols.buf.tobytes()  # one copy per batch
        bbuf = pb["bbuf"]
        ko, kl = cols.key_off, cols.key_len
        so, sl = cols.sub_off, cols.sub_len
        vo, vl = cols.val_off, cols.val_len
        cg, fr, tv = cols.change, cols.from_, cols.to
        row0 = row
        try:
            while row < n:
                # dictionary UTF-8 was validated at decode
                c = Change(
                    key=bbuf[ko[row]: ko[row] + kl[row]].decode("utf-8"),
                    change=int(cg[row]), from_=int(fr[row]), to=int(tv[row]),
                    value=(bbuf[vo[row]: vo[row] + vl[row]]
                           if vl[row] >= 0 else b""),
                    subset=(bbuf[so[row]: so[row] + sl[row]].decode("utf-8")
                            if sl[row] >= 0 else ""))
                # delivery consumes the row BEFORE the handler can raise:
                # a caught raise-then-resume re-enters at the next row
                row += 1
                self.changes += 1
                self._batch_rows_seen += 1
                ack = _FastAck(self)
                on_change(c, ack)
                ack.arm()
                if (self.destroyed or self._pending > 0
                        or self._paused_readers > 0):
                    return
        finally:
            pb["row"] = row
            if row >= n and self._pbatch is pb:
                self._pbatch = None
                self._batch_frames_done += 1
            if _OBS.on and row > row0:
                _M_DEC_CHANGES.inc(row - row0)

    # -- reconcile and snapshot frames ----------------------------------------

    def _finish_reconcile(self, payload) -> None:
        """Decode one complete reconcile payload and dispatch it whole;
        structural corruption (bad subtype or version, a torn symbol run,
        trailing bytes) destroys the session with a ProtocolError, so a
        torn frame never decodes into a wrong diff."""
        from ..wire import reconcile_codec

        self._finish_control(payload, reconcile_codec.decode_reconcile,
                             "reconcile", _M_DEC_RC_FRAMES)

    def _finish_snapshot(self, payload) -> None:
        """Decode one complete snapshot payload and dispatch it whole
        (a flipped chunk BODY is the joiner's per-chunk digest check's
        to catch)."""
        from ..wire import snapshot_codec

        self._finish_control(payload, snapshot_codec.decode_snapshot,
                             "snapshot", _M_DEC_SN_FRAMES)

    def _finish_control(self, payload, decode, kind: str, frames) -> None:
        try:
            msg = decode(payload)
        except ValueError as e:
            self.destroy(self._protocol_error(str(e), cause=e))
            return
        if _OBS.on:
            frames.inc()
            wire_len = self._frame_end - self._frame_start
            # the kind is a literal at each trace call: the tracing
            # vocabulary stays greppable per frame type
            if kind == "reconcile":
                _trace_instant("decoder.frame", offset=self._frame_start,
                               kind="reconcile", wire_len=wire_len)
                self._lit_cost_reconcile(len(payload))
            else:
                _trace_instant("decoder.frame", offset=self._frame_start,
                               kind="snapshot", wire_len=wire_len)
                self._lit_cost_snapshot(len(payload))
        self._state = TYPE_HEADER
        # delivery consumes the frame BEFORE the handler can raise: a
        # caught raise-then-resume re-enters at the next frame
        if kind == "reconcile":
            self.reconcile_frames += 1
            handler = self._on_reconcile
        else:
            self.snapshot_frames += 1
            handler = self._on_snapshot
        if handler is not None:
            ack = _FastAck(self)
            handler(msg, ack)
            ack.arm()
        # default: drop, as unhandled changes are

    # -- wire cost helpers --------------------------------------------------
    # Each site forks once on `_OBS.on` and calls one of these, which hold
    # every wirecost name.  A frame's framing is its wire extent less its
    # payload; the frame class is a literal at every call.

    def _frame_framing(self, plen: int) -> int:
        return self._frame_end - self._frame_start - plen

    def _lit_cost_change(self, plen: int) -> None:
        _wirecost.account("change", self.cost_link, "rx", plen,
                          self._frame_framing(plen))

    def _lit_cost_change_run(self, wire_total: int, payload_total: int,
                             frames: int) -> None:
        _wirecost.account("change", self.cost_link, "rx", payload_total,
                          wire_total - payload_total, frames)

    def _lit_cost_batch(self, plen: int, saved: int) -> None:
        _wirecost.account("change_batch", self.cost_link, "rx", plen,
                          self._frame_framing(plen))
        if saved > 0:
            _wirecost.note_saved(self.cost_link, "rx", saved)

    def _lit_cost_reconcile(self, plen: int) -> None:
        _wirecost.account("reconcile", self.cost_link, "rx", plen,
                          self._frame_framing(plen))

    def _lit_cost_snapshot(self, plen: int) -> None:
        _wirecost.account("snapshot", self.cost_link, "rx", plen,
                          self._frame_framing(plen))

    def _lit_cost_blob(self, length: int) -> None:
        # the whole frame at open, as the decoder.frame tag prices it
        _wirecost.account("blob", self.cost_link, "rx", length,
                          self._frame_framing(length))

    def _lit_cost_failure(self, message: str) -> None:
        # the ledger keeps its watermarks; only the failure count moves
        _wirecost.note_failure(self.cost_link, "rx", message)

    def _open_blob_if_ready(self) -> None:
        """Create the reader and invoke the app handler.

        The blob-level ``done`` does not gate the blob's own payload: as
        in the reference (decode.js:171-177,182), pending is taken at blob
        END, so frames after the blob wait for the app's ack."""
        blob = BlobReader(self, self._missing)
        self._current_blob = blob
        self.blobs += 1
        if _OBS.on:
            _M_DEC_BLOBS.inc()
            _trace_instant("decoder.frame", offset=self._frame_start,
                           kind="blob",
                           wire_len=self._frame_end - self._frame_start)
            self._lit_cost_blob(self._missing)
        latch = blob._latch

        def done() -> None:
            with self._ack_lock:
                if latch["acked"]:
                    return
                latch["acked"] = True
                if not latch["ended"]:
                    return
                self._pending -= 1
            self._resume()

        handler = self._on_blob if self._on_blob is not None else _drain_blob
        try:
            handler(blob, done)
        finally:
            # a zero-length blob has no payload to route through _blob_data
            if self._missing == 0:
                self._end_blob()

    def _blob_data(self, chunk: memoryview) -> memoryview | None:
        blob = self._current_blob
        take = min(len(chunk), self._missing)
        self._parsed += take
        self._missing -= take
        # materialize once: the reader and the _note_blob_bytes tap
        # share this bytes object
        data = bytes(chunk[:take])
        rest = chunk[take:]
        if _OBS.on:
            _M_DEC_BLOB_BYTES.inc(take)
        try:
            self._note_blob_bytes(data)
            blob._deliver(data)
        except BaseException:
            self._requeue_tail(rest)
            raise
        finally:
            if self._missing == 0:
                self._end_blob()
        return rest

    def _note_blob_bytes(self, data: bytes) -> None:
        """Hook: each materialized blob payload piece.  Base: no-op."""

    def _end_blob(self) -> None:
        blob, self._current_blob = self._current_blob, None
        self._state = TYPE_HEADER
        if blob is not None:
            # hold the pipeline until the app acks the blob (decode.js:171-177)
            latch = blob._latch
            with self._ack_lock:
                if not latch["acked"]:
                    latch["ended"] = True
                    self._pending += 1
            blob._finish()
