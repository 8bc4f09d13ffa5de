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

Only the streaming scanner is carried: the JAX package's native bulk
index, batch/reconcile/snapshot frames, checkpoints and telemetry are
not part of this slice.  Subclasses tap payloads through
:meth:`_deliver_change` and the blob hooks (:meth:`_open_blob_if_ready`,
:meth:`_note_blob_bytes`, :meth:`_end_blob`).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

from ..wire.change_codec import Change, decode_change
from ..wire.framing import (MAX_HEADER_LEN, TYPE_BLOB, TYPE_CHANGE,
                            TYPE_HEADER, ProtocolError)
from ..wire.varint import decode_uvarint

OnDone = Optional[Callable[[], None]]


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


def _drain_blob(blob: BlobReader, done: Callable[[], None]) -> None:
    """Default blob handler: consume and discard (decode.js:58-61)."""
    blob.on_data(lambda _chunk: None)
    blob.on_end(done)


class Decoder:
    """Push-based incremental wire parser.  See module docstring."""

    def __init__(self):
        self.bytes = 0
        self.changes = 0
        self.blobs = 0
        self.destroyed = False
        self.finished = False
        self._on_change: Callable[[Change, Callable[[], None]], None] | None = None
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

    def _protocol_error(self, message: str) -> ProtocolError:
        frames = (self.changes + self.blobs
                  - (1 if self._current_blob is not None else 0))
        return ProtocolError(message, frame=frames, offset=self.bytes)

    # -- flow control -----------------------------------------------------------

    def _stalled(self) -> bool:
        return self._pending > 0 or self._paused_readers > 0

    def _up(self) -> Callable[[], None]:
        """A one-shot ``done`` for an app callback; parsing pauses while
        any are outstanding."""
        with self._ack_lock:
            self._pending += 1
        fired = False

        def done() -> None:
            nonlocal fired
            with self._ack_lock:
                if fired:
                    return
                fired = True
                self._pending -= 1
            self._resume()

        return done

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
                or self._overflow or self._stalled() or self._consuming):
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
            while self._overflow and not self._stalled() and not self.destroyed:
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
        if not self.destroyed and not self._overflow and not self._stalled():
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
            self._overflow.appendleft(rest)

    def _consume_chunk(self, chunk: memoryview) -> memoryview | None:
        if self._state == TYPE_HEADER:
            return self._scan_header(chunk)
        if self._state == TYPE_CHANGE:
            return self._change_data(chunk)
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
                try:
                    framed_len, _ = decode_uvarint(self._header)
                except ValueError as e:  # varint exceeds 64 bits
                    self.destroy(self._protocol_error(str(e)))
                    return None
                type_id = self._header[-1]
                self._header.clear()
                self._missing = framed_len - 1  # length counts the id byte
                if framed_len < 1:
                    self.destroy(self._protocol_error("frame length must be >= 1"))
                    return None
                if type_id == TYPE_CHANGE:
                    self._state = TYPE_CHANGE
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
                self.destroy(self._protocol_error("frame header too long"))
                return None
        return None

    def _change_data(self, chunk: memoryview) -> memoryview | None:
        if self._payload_parts is None and len(chunk) >= self._missing:
            # whole payload inside one chunk: zero-copy slice
            payload = chunk[: self._missing]
            rest = chunk[self._missing:]
            self._missing = 0
            try:
                self._finish_change(payload)
            except BaseException:
                self._requeue_tail(rest)
                raise
            return rest
        if self._payload_parts is None:
            self._payload_parts = []
        take = min(len(chunk), self._missing)
        self._payload_parts.append(bytes(chunk[:take]))
        self._missing -= take
        rest = chunk[take:]
        if self._missing == 0:
            parts, self._payload_parts = self._payload_parts, None
            try:
                self._finish_change(b"".join(parts))
            except BaseException:
                self._requeue_tail(rest)
                raise
        return rest

    def _finish_change(self, payload) -> None:
        try:
            change = decode_change(payload)
        except ValueError as e:
            self.destroy(self._protocol_error(str(e)))
            return
        self._deliver_change(change, payload)

    def _deliver_change(self, change: Change, payload) -> None:
        """Deliver one decoded change: the single hook subclasses adding
        per-change work (the digest backend) override."""
        self.changes += 1
        self._state = TYPE_HEADER
        if self._on_change is not None:
            self._on_change(change, self._up())
        # default: drop (decode.js:54-56)

    def _open_blob_if_ready(self) -> None:
        """Create the reader and invoke the app handler.

        The blob-level ``done`` does not gate the blob's own payload: as
        in the reference (decode.js:171-177,182), pending is taken at blob
        END, so frames after the blob wait for the app's ack."""
        blob = BlobReader(self, self._missing)
        self._current_blob = blob
        self.blobs += 1
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
        self._missing -= take
        # materialize once: the reader and the _note_blob_bytes tap
        # share this bytes object
        data = bytes(chunk[:take])
        rest = chunk[take:]
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
