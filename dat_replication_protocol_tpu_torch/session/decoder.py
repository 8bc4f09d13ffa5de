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
the recorder is armed.

:meth:`checkpoint` exports the resume point (``session/resume.py``) and
:meth:`watermark` the wire cursors on the fleet plane.  Only the
streaming scanner is carried: the JAX package's native bulk index is
not.
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

from ..obs import wirecost as _wirecost
from ..obs.events import emit as _emit
from ..obs.flight import FLIGHT as _FLIGHT
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import trace_instant as _trace_instant
from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..wire.change_codec import Change, decode_change
from ..wire.framing import (LOCAL_CAPS, MAX_HEADER_LEN, TYPE_BLOB,
                            TYPE_CHANGE, TYPE_CHANGE_BATCH, TYPE_HEADER,
                            TYPE_RECONCILE, TYPE_SNAPSHOT, ProtocolError)
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

    def __init__(self):
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
        self._write_cbs: list[Callable[[], None]] = []
        self._end_queued = False
        self._end_cb: OnDone = None
        self._consuming = False  # reentrancy guard for _consume
        # persistent wakeups fired whenever a stall clears (transport pumps)
        self._drain_watchers: list[Callable[[], None]] = []
        # serializes the pending counter against acks from other threads
        self._ack_lock = threading.Lock()

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
        return not (self._overflow or self._stalled())

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
        for cb in self._error_cbs:
            cb(err)
        # release parked write callbacks and watchers so a blocked
        # transport wakes and observes the destroyed state
        cbs, self._write_cbs = self._write_cbs, []
        for cb in cbs:
            cb()
        self._notify_drain_watchers()

    def writable(self) -> bool:
        return not (self._stalled() or self._overflow or self.destroyed
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
        return self._pending > 0 or self._paused_readers > 0

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
                or self._overflow or self._pbatch is not None
                or self._stalled() or self._consuming):
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

    def _consume(self) -> None:
        """Drain queued input while the app keeps up (decode.js:144-169)."""
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
                if not self._overflow:
                    break
                chunk = self._overflow.popleft()
                rest = self._consume_chunk(chunk)
                if self.destroyed:
                    return
                if rest is not None and len(rest):
                    self._overflow.appendleft(rest)
        finally:
            self._consuming = False
        # fully drained and nothing outstanding: release parked writers
        # and run a queued finalization
        if (not self.destroyed and not self._overflow
                and self._pbatch is None and not self._stalled()):
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
            self._overflow.appendleft(rest)

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
            change = decode_change(payload)
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
