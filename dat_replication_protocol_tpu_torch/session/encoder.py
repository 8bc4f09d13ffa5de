"""Encoder — the producing end of a replication session.

A trimmed copy of ``dat_replication_protocol_tpu/session/encoder.py``
(reference semantics: encode.js:46-151), pull-based:

* ``change(change, on_flush)`` frames a protobuf Change (type id 1).
* ``blob(length, on_flush)`` opens a streamed blob (type id 2) and
  returns a :class:`BlobWriter`; the length is declared up front because
  the wire header precedes the data.
* Blob FIFO: any number of blobs may be open, but their bytes reach the
  wire in creation order — later blobs are corked until the head ends.
* A change submitted while any blob is open is parked and replayed once
  the blob queue drains.
* Backpressure: the consumer pulls with :meth:`read`; ``on_flush``
  callbacks fire when their bytes have been pulled, and ``write``/
  ``change`` return False above the high-water mark.
* ``finalize()`` marks EOF; :meth:`read` returns ``None`` once drained.
* Negotiated ``ChangeBatch`` framing: with ``CAP_CHANGE_BATCH`` in
  ``peer_caps`` (at construction or by :meth:`negotiate`), changes
  accumulate into columnar ``TYPE_CHANGE_BATCH`` frames behind a
  :class:`BatchPolicy`.  With ``peer_caps=0`` the wire is the
  reference's, byte for byte.

Telemetry (behind :data:`..obs.metrics.OBS`): the reference's session
counters and ``encoder.frame`` instants that tile the wire; a corked
blob is tagged when it uncorks, where its true offset is known.
* :meth:`Encoder.attach_journal` tees every byte :meth:`Encoder.read`
  hands out into a resume journal at absolute wire offsets
  (``session/resume.py``).
* Negotiated control frames: :meth:`Encoder.reconcile_frame` and
  :meth:`Encoder.snapshot_frame` frame one message of the anti-entropy
  protocols (``wire/reconcile_codec.py``, ``wire/snapshot_codec.py``),
  and raise unless the peer advertised ``CAP_RECONCILE`` or
  ``CAP_SNAPSHOT``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from time import monotonic as _now
from typing import Callable, Optional

from .._fastpath_gate import fastpath_mod as _fastpath_mod
from ..obs import wirecost as _wirecost
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import trace_instant as _trace_instant
from ..wire.change_codec import (Change, _check_uint32,
                                 _encode_change_with, encode_change)
from ..wire.framing import CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT, \
    TYPE_BLOB, TYPE_CHANGE, TYPE_CHANGE_BATCH, TYPE_RECONCILE, \
    TYPE_SNAPSHOT, frame_header, header_len

OnDone = Optional[Callable[[], None]]

DEFAULT_HIGH_WATER = 64 * 1024

# the reference's catalog names (OBSERVABILITY.md); each site is one
# `_OBS.on` attribute load while telemetry is off
_M_ENC_BYTES = _counter("encoder.bytes")
_M_ENC_CHANGES = _counter("encoder.changes")
_M_ENC_BLOBS = _counter("encoder.blobs")
_M_ENC_BLOB_CHUNKS = _counter("encoder.blob.chunks")
_M_ENC_PARKED = _counter("encoder.parked.bytes")
# seconds a parked chunk or change waited behind the blob FIFO
_H_ENC_PARK = _histogram("encoder.park.seconds")
_M_BATCH_FRAMES = _counter("wire.batch.frames")
_M_BATCH_ROWS = _counter("wire.batch.rows")
_M_BATCH_SAVED = _counter("wire.batch.bytes_saved")
_M_RC_FRAMES = _counter("reconcile.frames")
_M_RC_WIRE = _counter("reconcile.wire_bytes")
_M_SN_FRAMES = _counter("snapshot.frames")
_M_SN_WIRE = _counter("snapshot.wire_bytes")


@dataclasses.dataclass
class BatchPolicy:
    """Flush policy for negotiated columnar ``ChangeBatch`` framing.

    Rows accumulate until any bound trips: ``max_rows`` / ``max_bytes``
    (approximate payload volume), ``max_delay`` seconds since the first
    pending row (checked on the next submit — there is no timer thread;
    latency-sensitive producers call :meth:`Encoder.flush_batch`), or an
    *uncork*: a consumer pulling :meth:`Encoder.read` while the queue is
    otherwise dry flushes what is pending, so a drained transport never
    waits on a half-full batch.  A blob open or ``finalize()`` always
    flushes first (frame order is submission order).
    """

    max_rows: int = 4096
    max_bytes: int = 1 << 20
    max_delay: float | None = None


class EncoderDestroyedError(Exception):
    pass


class BlobLengthError(Exception):
    """Writes did not match the declared blob length."""


class BlobWriter:
    """Write side of one streamed blob (reference: encode.js:11-44).

    While corked (not head of the blob FIFO) writes are parked and
    flushed on uncork.  Overflow or a short ``end()`` raises
    :class:`BlobLengthError` and destroys the encoder, because a length
    mismatch silently desyncs the wire.
    """

    def __init__(self, encoder: "Encoder", length: int, on_flush: OnDone = None):
        self._encoder = encoder
        self.length = length
        self._on_flush = on_flush
        self._written = 0
        self._corked = False
        # (bytes, on_flush, park time or None while telemetry is off)
        self._parked: list[tuple[bytes, OnDone, float | None]] = []
        # a corked blob's header reaches the wire at uncork: tag it there
        self._tag_on_uncork = False
        self._ended = False
        self._finished = False
        self.destroyed = False

    def write(self, data, on_flush: OnDone = None) -> bool:
        """Append blob bytes; False when the encoder is above its
        high-water mark (wait for :meth:`Encoder.on_drain`)."""
        if self.destroyed or self._encoder.destroyed:
            raise EncoderDestroyedError("write after destroy")
        if self._ended:
            raise BlobLengthError("write after end()")
        if isinstance(data, str):
            data = data.encode("utf-8")
        elif not isinstance(data, (bytes, bytearray, memoryview)):
            data = bytes(data)
        if self._written + len(data) > self.length:
            err = BlobLengthError(
                f"blob overflow: declared {self.length}, writing past it "
                f"({self._written} + {len(data)})")
            self._encoder.destroy(err)
            raise err
        self._written += len(data)
        if _OBS.on:
            _M_ENC_BLOB_CHUNKS.inc()
        if self._corked:
            self._park(bytes(data), on_flush)
            return not self._encoder._above_high_water()
        return self._encoder._push(data, on_flush)

    def end(self, data=None, on_flush: OnDone = None) -> None:
        """Finish the blob (optionally writing a final chunk)."""
        if data is not None:
            self.write(data, on_flush)
        elif on_flush is not None:
            prev = self._on_flush
            if prev is None:
                self._on_flush = on_flush
            else:
                def both(a=prev, b=on_flush):
                    a()
                    b()
                self._on_flush = both
        if self._ended:
            return
        self._ended = True
        if self._written != self.length:
            err = BlobLengthError(
                f"blob ended short: declared {self.length}, "
                f"wrote {self._written}")
            self._encoder.destroy(err)
            raise err
        if not self._corked:
            self._finish()

    def destroy(self, err: Exception | None = None) -> None:
        """Destroying either side of a blob destroys its session."""
        if self.destroyed:
            return
        self.destroyed = True
        self._encoder.destroy(err)

    def _park(self, data: bytes, cb: OnDone) -> None:
        # parked bytes count toward the high-water mark
        self._parked.append((data, cb, _now() if _OBS.on else None))
        self._encoder._parked_bytes += len(data)
        if _OBS.on:
            _M_ENC_PARKED.inc(len(data))

    def _uncork(self) -> None:
        if not self._corked:
            return
        self._corked = False
        if self._tag_on_uncork:
            self._tag_on_uncork = False
            if _OBS.on:
                # the first parked piece is this blob's header: the
                # encoder's byte count now is the frame's wire offset
                _trace_instant("encoder.frame", offset=self._encoder.bytes,
                               kind="blob",
                               wire_len=len(self._parked[0][0]) + self.length)
                self._encoder._lit_cost_blob(self.length)
        for data, cb, t0 in self._parked:
            self._encoder._parked_bytes -= len(data)
            if t0 is not None and _OBS.on:
                _H_ENC_PARK.observe(_now() - t0)
            self._encoder._push(data, cb)
        self._parked.clear()
        if self._ended:
            self._finish()

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if self._on_flush is not None:
            self._encoder._after_flush(self._on_flush)
        self._encoder._blob_finished(self)


class Encoder:
    """Pull-based frame producer.  See module docstring for semantics."""

    # the wire cost ledger's link name for this session's tx bytes
    cost_link = "session"

    def __init__(self, high_water: int = DEFAULT_HIGH_WATER,
                 peer_caps: int = 0,
                 batch_policy: BatchPolicy | None = None):
        self.bytes = 0
        self.changes = 0
        self.blobs = 0
        # capability mask the RECEIVING peer advertised; 0 = assume a
        # reference peer and emit the reference wire byte for byte
        self.peer_caps = peer_caps
        self._batch_policy = (batch_policy if batch_policy is not None
                              else BatchPolicy())
        # pending ChangeBatch rows (prepared tuples) and their flush
        # callbacks; their volume counts toward the high-water mark
        self._batch_rows: list[tuple] = []
        self._batch_cbs: list[Callable[[], None]] = []
        self._batch_pending_bytes = 0
        self._batch_t0: float | None = None
        self.destroyed = False
        self.finalized = False
        self.finished = False  # terminal: drained past finalize, or destroyed
        self._high_water = high_water
        # (wire bytes, on_consumed) in wire order
        self._queue: deque[tuple[bytes | memoryview, OnDone]] = deque()
        self._queued_bytes = 0
        self._parked_bytes = 0
        self._open_blobs: deque[BlobWriter] = deque()
        # parked changes are encoded at submit time, framed on replay
        self._parked_changes: list[tuple[bytes, OnDone, float | None]] = []
        self._drain_cbs: list[Callable[[], None]] = []
        self._error_cbs: list[Callable[[Exception | None], None]] = []
        self._finish_cbs: list[Callable[[], None]] = []
        self._finalize_cb: OnDone = None
        # single consumer hook (the pipe / a transport pump): called when
        # new wire bytes become readable
        self._on_readable: Optional[Callable[[], None]] = None
        # resume tee (session.resume.WireJournal): every byte read()
        # hands out is also appended here
        self._journal = None

    def _attach_readable(self, cb: Callable[[], None]) -> None:
        if self._on_readable is not None:
            raise RuntimeError(
                "encoder is already attached to a pump/pipe; detach it first")
        self._on_readable = cb

    def _detach_readable(self) -> None:
        self._on_readable = None

    def attach_journal(self, journal) -> None:
        """Tee every wire byte :meth:`read` returns into ``journal``
        (anything with ``append(bytes)``: a
        :class:`~.resume.WireJournal` or a broadcast log), so the session
        can resume from a receiver checkpoint after a transport failure.
        ``read`` is the single exit of the output queue, so the journal
        sees bytes in wire order.

        Journal positions are absolute wire offsets: attaching after
        bytes were already read out aligns the journal's window past
        them with ``journal.seek``; a journal that cannot seek is refused
        then, since recording them at offset 0 would make every
        ``read_from(checkpoint.wire_offset)`` replay the wrong bytes."""
        delivered = self.bytes - self._queued_bytes  # already read out
        if delivered:
            seek = getattr(journal, "seek", None)
            if seek is None:
                raise RuntimeError(
                    f"encoder already emitted {delivered} byte(s) and the "
                    "journal cannot seek; attach before the first read")
            seek(delivered)
        self._journal = journal

    # -- capability negotiation ---------------------------------------------

    def negotiate(self, peer_caps: int) -> None:
        """Adopt the receiving peer's advertised capability mask (learned
        out of band).  Takes effect for subsequent submissions; revoking
        ``CAP_CHANGE_BATCH`` re-frames any pending rows as per-record
        ``Change`` frames — the peer can no longer parse a batch frame,
        so none may be emitted after the revocation."""
        had_batch = self._batching
        self.peer_caps = peer_caps
        if had_batch and not self._batching:
            self._flush_pending_per_record()

    @property
    def _batching(self) -> bool:
        return bool(self.peer_caps & CAP_CHANGE_BATCH) and not self.destroyed

    def change(self, change: Change | dict, on_flush: OnDone = None) -> bool:
        """Frame a Change; parked behind any open blob.

        With ``CAP_CHANGE_BATCH`` negotiated and no blob open, the change
        joins the pending columnar batch instead (validated now, framed
        at flush — see :class:`BatchPolicy`)."""
        if self.destroyed:
            raise EncoderDestroyedError("change after destroy")
        if self.finalized:
            raise EncoderDestroyedError("change after finalize")
        if self._batching and not self._open_blobs:
            self._batch_append(self._prepare_row(change), on_flush)
            return not self._above_high_water()
        payload = encode_change(change)
        if self._open_blobs:
            self._parked_changes.append(
                (payload, on_flush, _now() if _OBS.on else None))
            self._parked_bytes += len(payload)
            if _OBS.on:
                _M_ENC_PARKED.inc(len(payload))
            return not self._above_high_water()
        return self._frame_change(payload, on_flush)

    def change_many(self, records, on_flush: OnDone = None) -> bool:
        """Submit a run of changes with per-run, not per-row, overhead:
        the framed bytes land in ONE queue entry and ``on_flush`` fires
        when the run's bytes drain.  Wire bytes are identical to calling
        :meth:`change` per record."""
        if self.destroyed:
            raise EncoderDestroyedError("change after destroy")
        if self.finalized:
            raise EncoderDestroyedError("change after finalize")
        if not isinstance(records, (list, tuple)):
            records = list(records)
        if self._open_blobs:
            # ordering behind the blob FIFO is per-record machinery
            ok = True
            for i, rec in enumerate(records):
                ok = self.change(
                    rec, on_flush if i == len(records) - 1 else None)
            return ok
        if self._batching:
            prepared = [self._prepare_row(r) for r in records]
            for i, row in enumerate(prepared):
                self._batch_append(
                    row, on_flush if i == len(prepared) - 1 else None,
                    defer_flush=True)
            self._maybe_flush_batch()
            return not self._above_high_water()
        fp = _fastpath_mod()  # the C codec, bound once for the run
        payloads = [_encode_change_with(fp, rec) for rec in records]
        self._note_change_run(payloads)
        out = bytearray()
        obs_on = _OBS.on
        plen = 0
        for payload in payloads:
            header = frame_header(len(payload), TYPE_CHANGE)
            if obs_on:
                _trace_instant("encoder.frame", offset=self.bytes + len(out),
                               kind="change",
                               wire_len=len(header) + len(payload))
                plen += len(payload)
            out += header
            out += payload
        if not records:
            if on_flush is not None:
                self._after_flush(on_flush)
            return not self._above_high_water()
        self.changes += len(records)
        if obs_on:
            _M_ENC_CHANGES.inc(len(records))
            # run totals: framing is the framed bytes less the payloads
            self._lit_cost_change(len(out) - plen, plen, len(records))
        return self._push(bytes(out), on_flush)

    # -- ChangeBatch accumulation -------------------------------------------

    @staticmethod
    def _prepare_row(change: Change | dict) -> tuple:
        """Validate and normalize one record at SUBMIT time, so bad input
        raises at the call that supplied it, not at a later flush.  Field
        extraction and error classes are :func:`encode_change`'s."""
        if isinstance(change, dict):
            if "from" in change:
                fr = change["from"]
            elif "from_" in change:
                fr = change["from_"]
            else:
                raise KeyError("from")  # required, same as from_dict
            key = change["key"]
            cg = change["change"]
            to = change["to"]
            value = change.get("value")
            subset = change.get("subset")
        else:
            key = change.key
            cg = change.change
            fr = change.from_
            to = change.to
            value = change.value
            subset = change.subset
        if key is None:
            raise ValueError("Change.key is required")
        return (
            key.encode("utf-8"),
            _check_uint32("change", cg),
            _check_uint32("from", fr),
            _check_uint32("to", to),
            None if value is None else bytes(value),
            None if subset is None else subset.encode("utf-8"),
        )

    def _note_change_run(self, payloads: list[bytes]) -> None:
        """Hook: the payloads of a per-record :meth:`change_many` run, in
        order, before its bytes are queued (the digest encoder submits
        them here, as :meth:`_frame_change` does one).  Base: no-op."""

    def _note_batch_rows(self, rows: list[tuple], payload: bytes) -> None:
        """Hook: one call per batch flush with the prepared row tuples and
        the frame's payload, before the frame reaches the queue (the
        digest encoder submits each row's canonical per-record encoding
        here).  Base: no-op."""

    def _flush_pending_per_record(self) -> None:
        """Capability revocation: pending rows re-frame as per-record
        ``Change`` frames; their flush callbacks fire when the run
        drains, as a batch flush would have fired them."""
        rows, self._batch_rows = self._batch_rows, []
        if not rows:
            return
        cbs, self._batch_cbs = self._batch_cbs, []
        self._batch_pending_bytes = 0
        self._batch_t0 = None

        def all_cbs():
            for cb in cbs:
                cb()

        fp = _fastpath_mod()  # bound once for the run
        last = len(rows) - 1
        for i, (key, cg, fr, to, val, sub) in enumerate(rows):
            payload = _encode_change_with(fp, {
                "key": key.decode("utf-8"), "change": cg, "from": fr,
                "to": to, "value": val,
                "subset": None if sub is None else sub.decode("utf-8")})
            self._frame_change(payload,
                               all_cbs if (i == last and cbs) else None)

    def _batch_append(self, row: tuple, on_flush: OnDone,
                      defer_flush: bool = False) -> None:
        if not self._batch_rows:
            self._batch_t0 = _now()
        self._batch_rows.append(row)
        if on_flush is not None:
            self._batch_cbs.append(on_flush)
        # approximate pending volume: heap bytes + fixed columns
        self._batch_pending_bytes += (
            len(row[0]) + (len(row[4]) if row[4] is not None else 0)
            + (len(row[5]) if row[5] is not None else 0) + 24)
        if not defer_flush:
            self._maybe_flush_batch()

    def _maybe_flush_batch(self) -> None:
        pol = self._batch_policy
        if (len(self._batch_rows) >= pol.max_rows
                or self._batch_pending_bytes >= pol.max_bytes
                or (pol.max_delay is not None and self._batch_t0 is not None
                    and _now() - self._batch_t0 >= pol.max_delay)):
            self.flush_batch()

    # -- wire cost helpers --------------------------------------------------
    # Each site forks once on `_OBS.on` and calls one of these, which hold
    # every wirecost name: the disabled path never reaches the ledger.
    # The frame class is a literal at every call.

    def _lit_cost_change(self, framing: int, payload: int,
                         frames: int = 1) -> None:
        _wirecost.account("change", self.cost_link, "tx", payload,
                          framing, frames)

    def _lit_cost_batch(self, framing: int, payload: int,
                        saved: int) -> None:
        _wirecost.account("change_batch", self.cost_link, "tx", payload,
                          framing)
        if saved > 0:
            _wirecost.note_saved(self.cost_link, "tx", saved)

    def _lit_cost_reconcile(self, framing: int, payload: int) -> None:
        _wirecost.account("reconcile", self.cost_link, "tx", payload,
                          framing)

    def _lit_cost_snapshot(self, framing: int, payload: int) -> None:
        _wirecost.account("snapshot", self.cost_link, "tx", payload,
                          framing)

    def _lit_cost_blob(self, length: int) -> None:
        # the whole frame at header time, as the encoder.frame tag prices
        # it (the chunks stream the declared payload later)
        _wirecost.account("blob", self.cost_link, "tx", length,
                          header_len(length))

    def flush_batch(self) -> None:
        """Frame every pending batch row NOW as one ``TYPE_CHANGE_BATCH``
        frame (no-op when nothing is pending)."""
        from ..wire import batch_codec

        rows, self._batch_rows = self._batch_rows, []
        if not rows:
            return
        cbs, self._batch_cbs = self._batch_cbs, []
        self._batch_pending_bytes = 0
        self._batch_t0 = None
        payload = batch_codec.encode_rows(rows)
        # flush-side tap BEFORE the frame is queued, the batch twin of
        # _frame_change's submit-before-frame ordering
        self._note_batch_rows(rows, payload)
        n = len(rows)
        self.changes += n
        header = frame_header(len(payload), TYPE_CHANGE_BATCH)
        if _OBS.on:
            _M_ENC_CHANGES.inc(n)
            _M_BATCH_FRAMES.inc()
            _M_BATCH_ROWS.inc(n)
            import numpy as np

            est = batch_codec.estimate_per_record_bytes(
                np.asarray([len(r[0]) for r in rows], np.int64),
                np.asarray([-1 if r[5] is None else len(r[5])
                            for r in rows], np.int64),
                np.asarray([-1 if r[4] is None else len(r[4])
                            for r in rows], np.int64),
                np.asarray([r[1] for r in rows], np.uint32),
                np.asarray([r[2] for r in rows], np.uint32),
                np.asarray([r[3] for r in rows], np.uint32))
            saved = est - (len(header) + len(payload))
            if saved > 0:
                _M_BATCH_SAVED.inc(saved)
            _trace_instant("encoder.frame", offset=self.bytes,
                           kind="change_batch", rows=n,
                           wire_len=len(header) + len(payload))
            self._lit_cost_batch(len(header), len(payload), int(saved))
        if len(cbs) > 1:
            def all_cbs(cbs=cbs):
                for cb in cbs:
                    cb()
            cb = all_cbs
        else:
            cb = cbs[0] if cbs else None
        self._push(header + payload, cb)

    def _frame_change(self, payload: bytes, on_flush: OnDone) -> bool:
        self.changes += 1
        header = frame_header(len(payload), TYPE_CHANGE)
        if _OBS.on:
            _M_ENC_CHANGES.inc()
            # self.bytes before the header is pushed is the frame's wire
            # offset: the number the peer's decoder computes for it
            _trace_instant("encoder.frame", offset=self.bytes,
                           kind="change",
                           wire_len=len(header) + len(payload))
            self._lit_cost_change(len(header), len(payload))
        self._push(header, None)
        return self._push(payload, on_flush)

    def _control_frame(self, payload, on_flush: OnDone, what: str,
                       cap: int, cap_name: str, type_id: int,
                       frames, wire) -> bool:
        """Frame one negotiated control message.  Raises unless the peer
        advertised ``cap``, so an encoder never told anything emits the
        reference wire byte for byte; pending batch rows flush first
        (frame order is submission order); an open blob is an API error,
        since a control frame cannot park behind a streaming payload
        without reordering the wire."""
        if self.destroyed:
            raise EncoderDestroyedError(f"{what}_frame after destroy")
        if self.finalized:
            raise EncoderDestroyedError(f"{what}_frame after finalize")
        if not (self.peer_caps & cap):
            raise ValueError(
                f"peer did not advertise {cap_name}; {what} frames "
                "cannot be emitted to it (WIRE.md capability negotiation)"
            )
        if self._open_blobs:
            raise ValueError(f"{what}_frame with a blob open is unsupported")
        if self._batch_rows:
            self.flush_batch()
        payload = bytes(payload)
        header = frame_header(len(payload), type_id)
        if _OBS.on:
            frames.inc()
            wire.inc(len(header) + len(payload))
            _trace_instant("encoder.frame", offset=self.bytes, kind=what,
                           wire_len=len(header) + len(payload))
            if what == "reconcile":
                self._lit_cost_reconcile(len(header), len(payload))
            else:
                self._lit_cost_snapshot(len(header), len(payload))
        return self._push(header + payload, on_flush)

    def reconcile_frame(self, payload, on_flush: OnDone = None) -> bool:
        """Frame one reconcile protocol message (``TYPE_RECONCILE``;
        payload built by :mod:`..wire.reconcile_codec`)."""
        return self._control_frame(payload, on_flush, "reconcile",
                                   CAP_RECONCILE, "CAP_RECONCILE",
                                   TYPE_RECONCILE, _M_RC_FRAMES, _M_RC_WIRE)

    def snapshot_frame(self, payload, on_flush: OnDone = None) -> bool:
        """Frame one snapshot protocol message (``TYPE_SNAPSHOT``;
        payload built by :mod:`..wire.snapshot_codec`)."""
        return self._control_frame(payload, on_flush, "snapshot",
                                   CAP_SNAPSHOT, "CAP_SNAPSHOT",
                                   TYPE_SNAPSHOT, _M_SN_FRAMES, _M_SN_WIRE)

    def blob(self, length: int, on_flush: OnDone = None) -> BlobWriter:
        """Open a streamed blob of exactly ``length`` bytes."""
        if self.destroyed:
            raise EncoderDestroyedError("blob after destroy")
        if self.finalized:
            raise EncoderDestroyedError("blob after finalize")
        if not isinstance(length, int) or length <= 0:
            raise ValueError("blob length is required and must be > 0")
        # frame order is submission order: rows accumulated before this
        # blob reach the wire before its header
        if self._batch_rows:
            self.flush_batch()
        ws = BlobWriter(self, length, on_flush)
        self.blobs += 1
        if _OBS.on:
            _M_ENC_BLOBS.inc()
        header = frame_header(length, TYPE_BLOB)
        if self._open_blobs:
            ws._corked = True
            ws._tag_on_uncork = True
            ws._park(header, None)
        else:
            if _OBS.on:
                _trace_instant("encoder.frame", offset=self.bytes,
                               kind="blob", wire_len=len(header) + length)
                self._lit_cost_blob(length)
            self._push(header, None)
        self._open_blobs.append(ws)
        return ws

    def finalize(self, on_flush: OnDone = None) -> None:
        """Graceful end: after the queue drains, :meth:`read` gives EOF."""
        if self.destroyed:
            raise EncoderDestroyedError("finalize after destroy")
        if self._open_blobs:
            raise EncoderDestroyedError(
                f"finalize with {len(self._open_blobs)} blob(s) still open")
        if self._batch_rows:
            self.flush_batch()
        self.finalized = True
        self._finalize_cb = on_flush
        if not self._queue:
            if on_flush is not None:
                cb, self._finalize_cb = self._finalize_cb, None
                cb()
            self._fire_finish()
        if self._on_readable is not None:
            self._on_readable()  # let a connected pump observe EOF

    def read(self, max_bytes: int = -1) -> bytes | None:
        """Pull up to ``max_bytes`` of wire data (all buffered if -1).

        ``b''`` when nothing is buffered yet, ``None`` at EOF.  A frame
        larger than ``max_bytes`` is handed out in memoryview slices, so
        reading a large blob costs one copy, not one per chunk.
        """
        if self.destroyed:
            raise EncoderDestroyedError("read after destroy")
        if not self._queue and self._batch_rows:
            # uncork: a consumer pulling a dry queue gets what is
            # pending instead of waiting out the batch policy
            self.flush_batch()
        if not self._queue:
            return None if self.finalized else b""
        out = bytearray()
        fired: list[Callable[[], None]] = []
        while self._queue and (max_bytes < 0 or len(out) < max_bytes):
            payload, cb = self._queue[0]
            room = len(payload) if max_bytes < 0 else max_bytes - len(out)
            if len(payload) <= room:
                out += payload
                self._queue.popleft()
                self._queued_bytes -= len(payload)
                if cb is not None:
                    fired.append(cb)
            else:
                view = memoryview(payload)
                out += view[:room]
                self._queue[0] = (view[room:], cb)
                self._queued_bytes -= room
                break
        data = bytes(out)
        if _OBS.on and data:
            _M_ENC_BYTES.inc(len(data))
        if self._journal is not None and data:
            # before the flush callbacks: an on_flush hook that acks the
            # journal window must find its bytes there
            self._journal.append(data)
        below = not self._above_high_water()
        for cb in fired:
            cb()
        if below and self._drain_cbs:
            cbs, self._drain_cbs = self._drain_cbs, []
            for cb in cbs:
                cb()
        if self.finalized and not self._queue:
            if self._finalize_cb is not None:
                cb, self._finalize_cb = self._finalize_cb, None
                cb()
            self._fire_finish()
        return data

    @property
    def buffered_bytes(self) -> int:
        """Framed bytes queued for :meth:`read`; writes parked behind an
        open blob are not counted until they are framed."""
        return self._queued_bytes

    def writable(self) -> bool:
        return not self._above_high_water()

    def on_drain(self, cb: Callable[[], None]) -> None:
        """One-shot callback when the buffer falls below the high-water mark."""
        if self._above_high_water():
            self._drain_cbs.append(cb)
        else:
            cb()

    def on_error(self, cb: Callable[[Exception | None], None]) -> None:
        self._error_cbs.append(cb)

    def on_finish(self, cb: Callable[[], None]) -> None:
        """Fires once: after the finalized session drained, or after
        destroy (error callbacks first)."""
        if self.finished:
            cb()
        else:
            self._finish_cbs.append(cb)

    def _fire_finish(self) -> None:
        if self.finished:
            return
        self.finished = True
        cbs, self._finish_cbs = self._finish_cbs, []
        for cb in cbs:
            cb()

    def destroy(self, err: Exception | None = None) -> None:
        """Fail-fast teardown, destroying every open blob writer."""
        if self.destroyed:
            return
        self.destroyed = True
        for ws in list(self._open_blobs):
            ws.destroyed = True
        self._open_blobs.clear()
        self._queue.clear()
        self._queued_bytes = 0
        self._parked_bytes = 0
        self._parked_changes.clear()
        self._batch_rows.clear()
        self._batch_cbs.clear()
        self._batch_pending_bytes = 0
        for cb in self._error_cbs:
            cb(err)
        # wake a producer gated on the drain signal so it sees the destroy
        cbs, self._drain_cbs = self._drain_cbs, []
        for cb in cbs:
            cb()
        self._fire_finish()

    def _above_high_water(self) -> bool:
        return (self._queued_bytes + self._parked_bytes
                + self._batch_pending_bytes >= self._high_water)

    def _push(self, data, on_consumed: OnDone) -> bool:
        data = bytes(data)
        self.bytes += len(data)
        self._queue.append((data, on_consumed))
        self._queued_bytes += len(data)
        if self._on_readable is not None:
            self._on_readable()
        return not self._above_high_water()

    def _after_flush(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` once everything currently queued has been read."""
        if not self._queue:
            cb()
            return
        payload, prev = self._queue[-1]
        if prev is None:
            self._queue[-1] = (payload, cb)
        else:
            def both(a=prev, b=cb):
                a()
                b()
            self._queue[-1] = (payload, both)

    def _blob_finished(self, ws: BlobWriter) -> None:
        """Head-of-line blob completed: uncork the next and replay parked
        changes (which re-park while blobs remain open)."""
        if not self._open_blobs or self._open_blobs[0] is not ws:
            err = AssertionError("blob FIFO assertion failed")
            self.destroy(err)
            raise err
        self._open_blobs.popleft()
        if self._open_blobs:
            self._open_blobs[0]._uncork()
        parked, self._parked_changes = self._parked_changes, []
        for payload, cb, t0 in parked:
            if self._open_blobs:
                self._parked_changes.append((payload, cb, t0))
            else:
                self._parked_bytes -= len(payload)
                if t0 is not None and _OBS.on:
                    _H_ENC_PARK.observe(_now() - t0)
                self._frame_change(payload, cb)
