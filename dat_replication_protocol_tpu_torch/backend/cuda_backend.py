"""``backend='cuda'`` — the digest session ends.

The counterpart of ``dat_replication_protocol_tpu/backend/tpu_backend.py``.
:class:`CudaEncoder` / :class:`CudaDecoder` keep the host session API
and semantics and additionally content-hash every change payload and
blob, batching them through :class:`DigestPipeline` onto the card.

A change's digest is the BLAKE2b-256 of its per-record payload whatever
framing carried it: rows of a negotiated ``ChangeBatch`` frame are
re-encoded canonically and submitted in wire-row order, so a
batch-framed session gives the digest stream of the per-record session
of the same rows.

Digests arrive through ``on_digest(kind, seq, digest)`` callbacks and are
flushed before finalize: the finalize hook runs only once digests for all
submitted work have been delivered (the analogue of the reference's
drain-before-finalize, decode.js:124-142).

The pipeline's engine is :func:`..ops.blake2b.blake2b_batch_begin` on the
pipeline's device; it follows ``device=`` and nothing else.  Blobs of at
least :data:`DEFAULT_STREAM_THRESHOLD` bytes hash incrementally on the
host with hashlib, as the reference routes them (one serial chain leaves
a batched device idle), so they are never joined in host memory.

Telemetry: ``decoder.digests`` / ``encoder.digests`` per delivery,
``device.submit.items|bytes`` per submit, ``device.dispatch.batches``
per dispatch, and each dispatch and delivery inside a
``device.dispatch`` / ``device.deliver`` obs span joined with a
``digest.dispatch`` / ``digest.collect`` profiler span.  Each batch
observes ``device.batch.fill.seconds``, from its first submit to its
dispatch.  The decoder joins and submits each blob inside a
``decoder.blob`` span, and each run of the C change loop's payloads
inside a ``digest.submit`` span (the dispatches and deliveries the
submits set off nest in it).
"""

from __future__ import annotations

import functools
import hashlib
import time
from typing import Callable

from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..obs.tracing import trace_span as _trace_span
from ..ops.blake2b import DIGEST_SIZE, blake2b_batch_begin
from ..session.decoder import Decoder
from ..session.encoder import Encoder
from ..utils.device import resolve_device
from ..utils.trace import span

OnDigest = Callable[[str, int, bytes], None]  # (kind, seq, digest)

# blobs at least this long hash incrementally instead of being joined in
# host RAM for the batch path
DEFAULT_STREAM_THRESHOLD = 8 << 20

# digest deliveries by session end, and the pipeline's traffic
# (OBSERVABILITY.md catalog)
_M_DEC_DIGESTS = _counter("decoder.digests")
_M_ENC_DIGESTS = _counter("encoder.digests")
_M_SUBMIT_ITEMS = _counter("device.submit.items")
_M_SUBMIT_BYTES = _counter("device.submit.bytes")
_M_DISPATCHES = _counter("device.dispatch.batches")
_M_FILL = _histogram("device.batch.fill.seconds")


class _HostStream:
    """hashlib-backed incremental hasher for one over-threshold blob."""

    def __init__(self):
        self._h = hashlib.blake2b(digest_size=DIGEST_SIZE)
        self.length = 0

    def update(self, data) -> "_HostStream":
        self._h.update(data)
        self.length += memoryview(data).nbytes
        return self

    def digest(self) -> bytes:
        return self._h.digest()


class DigestPipeline:
    """Accumulates payloads into batches, dispatches them asynchronously,
    and maps batch slots back to per-item callbacks in submit order.

    A batch dispatches when it reaches ``max_batch`` items or
    ``max_batch_bytes`` bytes.  Dispatch does not wait for results: the
    card hashes while the host keeps parsing.  Digests are collected
    oldest batch first once more than ``max_inflight`` batches are
    outstanding, or at :meth:`flush`, the finalize barrier.
    """

    def __init__(self, hash_begin=None, max_batch: int = 1024,
                 max_batch_bytes: int = 1 << 30, max_inflight: int = 2,
                 device="cuda"):
        if hash_begin is None:
            dev = resolve_device(device)
            hash_begin = functools.partial(blake2b_batch_begin, device=dev)
            if _OBS.on:
                _note_engine("digest.hash", f"b1-{dev.type}")
        self._hash_begin = hash_begin
        self._max_batch = max_batch
        self._max_batch_bytes = max_batch_bytes
        self._max_inflight = max(1, max_inflight)
        # ordered ("payload", bytes, cb, tag) | ("stream", stream, cb, tag)
        self._entries: list[tuple] = []
        self._pending_bytes = 0
        # monotonic time of the queued batch's first submit, gate on
        self._fill_t0: float | None = None
        self._inflight: list[tuple[list[tuple], Callable[[], list[bytes]]]] = []
        self.dispatches = 0
        self.hashed_bytes = 0
        # delivered digests by route: the batch engine or a host stream
        self.batched = 0
        self.streamed = 0

    def submit(self, payload: bytes, on_digest: Callable, tag=None) -> None:
        """Queue one payload; ``on_digest(digest)``, or
        ``on_digest(tag, digest)`` when ``tag`` is not None."""
        if _OBS.on:
            _M_SUBMIT_ITEMS.inc()
            _M_SUBMIT_BYTES.inc(len(payload))
            if not self._entries:
                self._fill_t0 = time.monotonic()
        self._entries.append(("payload", payload, on_digest, tag))
        self._pending_bytes += len(payload)
        if (len(self._entries) >= self._max_batch
                or self._pending_bytes >= self._max_batch_bytes):
            self.dispatch()

    def submit_stream(self, stream, on_digest: Callable, tag=None) -> None:
        """Queue a finished incremental hash (``.digest()``/``.length``)
        for in-order delivery among the batched payloads."""
        if _OBS.on:
            _M_SUBMIT_ITEMS.inc()
            _M_SUBMIT_BYTES.inc(int(getattr(stream, "length", 0)))
            if not self._entries:
                self._fill_t0 = time.monotonic()
        self._entries.append(("stream", stream, on_digest, tag))
        if len(self._entries) >= self._max_batch:
            self.dispatch()

    @property
    def inflight(self) -> int:
        return len(self._inflight)

    def dispatch(self) -> None:
        """Start hashing everything queued without waiting for results.

        Starting a newer batch begins the digest readback of every older
        one, so a later collect waits on a transfer already under way."""
        if not self._entries:
            return
        entries, self._entries = self._entries, []
        pending = self._pending_bytes
        self._pending_bytes = 0
        self.dispatches += 1
        if _OBS.on:
            _M_DISPATCHES.inc()
            if self._fill_t0 is not None:
                _M_FILL.observe(time.monotonic() - self._fill_t0)
        self._fill_t0 = None
        payloads = [e[1] for e in entries if e[0] == "payload"]
        with _trace_span("device.dispatch", items=len(entries),
                         bytes=pending), span("digest.dispatch"):
            # the hash engine (B1's batch begin unless one was passed):
            # it launches the batch and returns its collect handle, no
            # wait on the card; dispatching is this pipeline's job
            # datlint: allow-callback-escape
            collect = (self._hash_begin(payloads) if payloads
                       else (lambda: []))
        self._prefetch_inflight()
        self._inflight.append((entries, collect))
        while len(self._inflight) > self._max_inflight:
            self._deliver_oldest()

    def _prefetch_inflight(self) -> None:
        for _, collect in self._inflight:
            start = getattr(collect, "start_d2h", None)
            if start is not None:
                start()

    def _deliver_oldest(self) -> None:
        entries, collect = self._inflight.pop(0)
        payload_count = sum(1 for e in entries if e[0] == "payload")
        with _trace_span("device.deliver", items=len(entries)), \
                span("digest.collect"):
            # the engine's own collect handle: it reads back the digests
            # of a batch already launched, the device round the hub's
            # dispatcher exists to make
            # datlint: allow-callback-escape
            digest_list = collect()
        if len(digest_list) != payload_count:
            raise RuntimeError(
                f"hash backend returned {len(digest_list)} digests for "
                f"{payload_count} payloads")
        digests = iter(digest_list)
        for kind, item, cb, tag in entries:
            if kind == "payload":
                self.batched += 1
                self.hashed_bytes += len(item)
                d = bytes(next(digests))
            else:
                self.streamed += 1
                self.hashed_bytes += item.length
                d = item.digest()
            # the submitter's delivery hook: on the hub's dispatcher it
            # is the hub's own router, which appends to the session's
            # completion queue and never blocks
            if tag is None:
                # datlint: allow-callback-escape
                cb(d)
            else:
                # datlint: allow-callback-escape
                cb(tag, d)

    def flush(self) -> None:
        """Dispatch anything queued and deliver ALL outstanding digests in
        submit order — the flush-before-finalize barrier."""
        self.dispatch()
        self._prefetch_inflight()
        while self._inflight:
            self._deliver_oldest()


class _DigestTaps:
    """The digest side shared by both session ends: the pipeline, the
    ``on_digest`` subscribers and the per-kind arrival counters."""

    _digest_counter = _M_DEC_DIGESTS  # decoder.digests or encoder.digests

    def _init_digests(self, pipeline, stream_threshold, device) -> None:
        self._pipeline = (pipeline if pipeline is not None
                          else DigestPipeline(device=device))
        self._digest_cbs: list[OnDigest] = []
        self._change_seq = 0
        self._blob_seq = 0
        self._stream_threshold = stream_threshold

    def on_digest(self, cb: OnDigest):
        self._digest_cbs.append(cb)
        return self

    @property
    def digest_pipeline(self) -> DigestPipeline:
        return self._pipeline

    def _emit_change_digest(self, seq: int, digest: bytes) -> None:
        if _OBS.on:
            self._digest_counter.inc()
        for cb in self._digest_cbs:
            cb("change", seq, digest)

    def _emit_blob_digest(self, seq: int, digest: bytes) -> None:
        if _OBS.on:
            self._digest_counter.inc()
        for cb in self._digest_cbs:
            cb("blob", seq, digest)


class CudaDecoder(_DigestTaps, Decoder):
    """Decoder that also content-hashes every change payload and blob.

    Wire-facing behavior is the host Decoder's.  ``on_digest(kind, seq,
    digest)``: ``kind`` is ``'change'`` or ``'blob'``, ``seq`` that kind's
    0-based arrival index.  All digests are delivered before the
    finalize hook runs.
    """

    def __init__(self, pipeline: DigestPipeline | None = None,
                 stream_threshold: int = DEFAULT_STREAM_THRESHOLD,
                 device="cuda", native: bool = True):
        super().__init__(native=native)
        self._init_digests(pipeline, stream_threshold, device)
        self._blob_parts: dict[int, list[bytes]] = {}
        self._blob_streams: dict[int, _HostStream] = {}

    def _checkpoint_digest(self) -> dict:
        # the next change/blob digest sequence numbers: per-payload
        # digests are independent (no chaining across frames), so the
        # counters are the whole state a resumed session continues from
        # without gaps or repeats
        return {"change_seq": self._change_seq, "blob_seq": self._blob_seq}

    def _deliver_change(self, change, payload) -> None:
        if self._digest_cbs:
            self._pipeline.submit(bytes(payload), self._emit_change_digest,
                                  self._change_seq)
        self._change_seq += 1
        super()._deliver_change(change, payload)

    # ride the decoder's C change loop: the only per-change addition here
    # is the payload digest, which the loop hands over through
    # _note_change_payloads after each run
    _bulk_payload_sink = True

    def _payload_sink_active(self) -> bool:
        # collect payloads only when someone listens for digests;
        # sequence numbers advance either way
        return bool(self._digest_cbs)

    def _note_change_payloads(self, payloads, count: int) -> None:
        # one C run's payloads in delivery order: submitted in seq order,
        # so digests keep the order the per-frame route gives them.  A
        # pipeline with a run surface (the hub's session) takes the whole
        # run in one call: one window check, one lock round trip
        if payloads:
            emit = self._emit_change_digest
            submit_many = getattr(self._pipeline, "submit_many", None)
            with span("digest.submit"):
                if submit_many is not None:
                    submit_many(payloads, emit, self._change_seq)
                else:
                    submit = self._pipeline.submit
                    for seq, payload in enumerate(payloads,
                                                  self._change_seq):
                        submit(payload, emit, seq)
        self._change_seq += count

    def _note_change_batch(self, cols, n: int) -> None:
        # every row's digest is owed at acceptance, before any row reaches
        # a handler: the canonical per-record encodings, in row order
        if not self._digest_cbs:
            self._change_seq += n
            return
        from ..runtime.replay import canonical_change_payloads

        submit, emit = self._pipeline.submit, self._emit_change_digest
        for seq, payload in enumerate(
                canonical_change_payloads(cols, self._native),
                self._change_seq):
            submit(payload, emit, seq)
        self._change_seq += n

    def _open_blob_if_ready(self) -> None:
        if self._digest_cbs:
            # self._missing is the blob's wire length at header time
            if self._missing >= self._stream_threshold:
                self._blob_streams[self._blob_seq] = _HostStream()
            else:
                self._blob_parts[self._blob_seq] = []
        self._blob_seq += 1
        super()._open_blob_if_ready()

    def _note_blob_bytes(self, data: bytes) -> None:
        # holds a reference to the decoder's bytes, not a second copy
        seq = self._blob_seq - 1
        if seq in self._blob_streams:
            self._blob_streams[seq].update(data)
        elif seq in self._blob_parts:
            self._blob_parts[seq].append(data)

    def _end_blob(self) -> None:
        seq = self._blob_seq - 1
        with span("decoder.blob"):
            parts = self._blob_parts.pop(seq, None)
            stream = self._blob_streams.pop(seq, None)
            if stream is not None:
                self._pipeline.submit_stream(stream, self._emit_blob_digest,
                                             seq)
            elif parts is not None:
                self._pipeline.submit(b"".join(parts), self._emit_blob_digest,
                                      seq)
        super()._end_blob()

    def _maybe_finalize(self) -> None:
        # flush-before-finalize
        if (self._end_queued and not self.finished and not self.destroyed
                and not self._overflow and not self._stalled()):
            self._pipeline.flush()
        super()._maybe_finalize()


class CudaEncoder(_DigestTaps, Encoder):
    """Encoder that content-hashes outgoing work on the card.

    Same wire output and ordering as the host Encoder; digests of every
    change payload and completed blob arrive through ``on_digest``.
    """

    _digest_counter = _M_ENC_DIGESTS

    def __init__(self, pipeline: DigestPipeline | None = None,
                 stream_threshold: int = DEFAULT_STREAM_THRESHOLD,
                 device="cuda", **kwargs):
        super().__init__(**kwargs)
        self._init_digests(pipeline, stream_threshold, device)

    def _frame_change(self, payload: bytes, on_flush) -> bool:
        if self._digest_cbs:
            self._pipeline.submit(payload, self._emit_change_digest,
                                  self._change_seq)
        self._change_seq += 1
        return super()._frame_change(payload, on_flush)

    def _note_change_run(self, payloads) -> None:
        # a per-record change_many run: one digest per row, as the rows
        # framed one by one would give (the reference's change_many skips
        # them)
        if self._digest_cbs:
            submit, emit = self._pipeline.submit, self._emit_change_digest
            for seq, payload in enumerate(payloads, self._change_seq):
                submit(payload, emit, seq)
        self._change_seq += len(payloads)

    def _note_batch_rows(self, rows, payload) -> None:
        # a batch flush: each row's canonical per-record encoding, in the
        # seq stream _frame_change would have given, before the frame is
        # queued; the rows are re-encoded from the frame's own columns
        if self._digest_cbs:
            from ..runtime.replay import canonical_change_payloads
            from ..wire.batch_codec import decode_change_batch

            submit, emit = self._pipeline.submit, self._emit_change_digest
            for seq, row in enumerate(canonical_change_payloads(
                    decode_change_batch(payload)), self._change_seq):
                submit(row, emit, seq)
        self._change_seq += len(rows)

    def blob(self, length: int, on_flush=None):
        ws = super().blob(length, on_flush)
        if self._digest_cbs:
            seq = self._blob_seq
            streaming = length >= self._stream_threshold
            sink = _HostStream() if streaming else []
            orig_write, orig_end = ws.write, ws.end

            def write(data, on_flush=None):
                if isinstance(data, str):
                    data = data.encode("utf-8")
                if streaming:
                    sink.update(data)
                else:
                    sink.append(bytes(data))
                return orig_write(data, on_flush)

            def end(data=None, on_flush=None):
                # a final chunk routes through BlobWriter.end -> self.write,
                # the wrapped write above
                was_ended = ws._ended
                orig_end(data, on_flush)
                if not was_ended:  # a double end() adds no second digest
                    if streaming:
                        self._pipeline.submit_stream(
                            sink, self._emit_blob_digest, seq)
                    else:
                        self._pipeline.submit(
                            b"".join(sink), self._emit_blob_digest, seq)

            ws.write = write
            ws.end = end
        self._blob_seq += 1
        return ws

    def finalize(self, on_flush=None) -> None:
        # pending batch rows are framed first, so their digests are among
        # those flushed before finalize (the reference flushes the
        # pipeline first and leaves the last batch's digests queued)
        if self._batch_rows:
            self.flush_batch()
        self._pipeline.flush()  # flush-before-finalize
        super().finalize(on_flush)
