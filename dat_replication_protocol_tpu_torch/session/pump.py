"""The wire pump: batched-syscall byte movers for every socket and fd path.

The port's copy of ``dat_replication_protocol_tpu/session/pump.py``.  The
Python pumps of :mod:`.transport` pay one interpreter round trip per
read or write (a ``read_bytes`` call, a ``decoder.write``, the wake
bookkeeping), all under the GIL.  The pump moves the byte loops into the
host library (``native/dat_native.cpp``, ``runtime/native.py``):

* **Receive** (:func:`recv_pump`): one ``dat_pump_recv_scan`` call a
  slab (a blocking wakeup ``read``, a ``MSG_DONTWAIT`` ``recvmmsg``
  drain of what the kernel already holds, and the frame scan, all with
  the GIL released), then ONE :meth:`~.decoder.Decoder.write_indexed`
  hands the decoder the bytes and the finished frame index.
* **Send** (:func:`send_pump`, :func:`pump_writer`): megabyte pulls from
  the encoder, each through one ``dat_pump_send`` gather loop
  (``sendmmsg`` batches, ``writev`` where the fd has none, partial
  writes resumed in C).
* **Fan-out gather** (:func:`send_spans_nb`, :class:`SpanGather`): a
  dispatcher turn's BroadcastLog slices go to the kernel as (address,
  length) spans through one non-blocking batch; no payload byte becomes
  a Python object.  The dispatcher keeps every window, ack and shed
  decision: only the byte mover changes.
* **The edge** (:class:`EdgePump`, :func:`recv_step`, :func:`send_step`):
  the same primitives cut into one bounded non-blocking turn a call.

**One route, chosen explicitly.**  The batched route is the port's
route.  The Python pumps stay as the plain version: ``native=False`` on
:class:`EdgePump`, :func:`io_for_socket` and ``FanoutServer`` selects
them, and ``sidecar.run_session`` takes them when it is given callables
without fds.  No environment variable picks a route, and nothing falls
back: a host library that does not build or load raises
``RuntimeError`` naming its source.  The C layer's per-fd degradation
(a pipe cannot take ``recvmmsg``/``sendmmsg``, so plain ``read`` and
``writev`` batches carry it) is the byte mover's behaviour on pipes;
:func:`probe_caps` and the ``transport.pump.*`` counters show it.  Both
routes give the same deliveries, digests, checkpoints and structured
errors (``tests/test_torch_pump_parity.py``).

One difference from the JAX package's pump: a blocking send whose fd's
``SO_SNDTIMEO`` ran out raises ``OSError(EAGAIN)``, as ``sendall`` does,
where the JAX package's retries forever (so its gossip round against a
peer that stopped reading never ends).

Backpressure is the transport's contract: the receive pump stops calling
into the kernel while the decoder stalls (the socket buffer absorbs the
window), and the send pump stops pulling while the transport blocks.

The pump is the transport, so it reports the bytes it moves to the wire
cost ledger (:mod:`..obs.wirecost`) as the ground truth the per-frame
ledger is audited against: once a batch on the batched route, once a
read (:func:`_metered_reader`) or a write on the plain one, and once a
turn on the edge's byte totals.  All run only with the obs gate on.
"""

from __future__ import annotations

import errno
import os
import select
import threading
from time import perf_counter as _perf
from typing import Callable, Optional

import numpy as np

from ..obs import wirecost as _wirecost
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.metrics import histogram as _histogram
from ..runtime import native
from .decoder import DecoderDestroyedError
from .encoder import EncoderDestroyedError
from .transport import WAKE_FALLBACK

__all__ = [
    "effective_pump_route", "recv_pump", "send_pump", "pump_reader",
    "pump_writer", "io_for_socket", "send_spans_nb", "probe_caps",
    "SpanGather", "EdgePump", "recv_step", "send_step",
]

# receive slab geometry: one pump call takes at most PUMP_BUF bytes (and
# so the decoder's largest single index) in recv slices of PUMP_SLICE
PUMP_BUF = 2 << 20
PUMP_SLICE = 1 << 20
# send pull size: one encoder.read per gather call
PUMP_SEND_CHUNK = 1 << 20

# transport.pump.* (the reference's catalog names, OBSERVABILITY.md)
_M_BATCHES = _counter("transport.pump.batches")
_M_MSGS = _counter("transport.pump.msgs")
_M_SYSCALLS = _counter("transport.pump.syscalls")
_M_SAVED = _counter("transport.pump.syscalls_saved")
_M_BYTES = _counter("transport.pump.bytes")
_M_GATHER_BYTES = _counter("transport.pump.gather.bytes")
# seconds inside one native pump call: the GIL is released for all of
# it, so this is the GIL-free time the batching buys back
_H_NATIVE = _histogram("transport.pump.native.seconds")


def effective_pump_route() -> str:
    """The route the pumps run: the batched one.  (The plain route runs
    only where a caller passes ``native=False``.)"""
    return "native"


def probe_caps() -> dict:
    """What the sidecar's stats records carry about the pump: the route
    and which batched syscalls this kernel serves (``dat_pump_probe``).
    The probe never gates the pump, which degrades per fd.  Builds and
    loads the host library, and raises if it cannot."""
    caps = native.pump_probe()
    return {"route": effective_pump_route(), "native_available": True,
            "recvmmsg": bool(caps & 1), "sendmmsg": bool(caps & 2)}


class _RecvState:
    """A receive loop's index buffers, allocated once per session.

    The receive SLAB is not here: each batch lands in a fresh allocation
    handed to the decoder as a view (the decoder may keep slices of it
    in its queue or bulk cursor for as long as it likes, and reading the
    next batch into a shared buffer under them would corrupt the wire).
    The index arrays ARE reused: a parked bulk cursor holds views of
    them, so a caller refills them only once the decoder is writable."""

    __slots__ = ("cap", "starts", "lens", "ids", "stats")

    def __init__(self, cap: int):
        self.cap = cap
        # sized for the typical frame density, not the 2-byte worst
        # case: a denser slab comes back as a valid partial index whose
        # tail re-enters the decoder's queue
        icap = cap // 16 + 1
        self.starts = np.empty(icap, dtype=np.int64)
        self.lens = np.empty(icap, dtype=np.int64)
        self.ids = np.empty(icap, dtype=np.uint8)
        self.stats = np.zeros(2, dtype=np.int64)


def _lit_rx(decoder, nbytes: int) -> None:
    """Received transport bytes of ``decoder``'s link (callers hold the
    ``_OBS.on`` gate)."""
    _wirecost.note_transport(
        getattr(decoder, "cost_link", "session"), "rx", nbytes)


def _lit_tx(encoder, nbytes: int) -> None:
    """Sent transport bytes of ``encoder``'s link (callers hold the
    ``_OBS.on`` gate)."""
    _wirecost.note_transport(
        getattr(encoder, "cost_link", "session"), "tx", nbytes)


def _metered_reader(decoder, read_bytes):
    """``read_bytes`` that reports each read to the ledger as
    ``decoder``'s received transport bytes (one gate check a read)."""
    def metered(n: int) -> bytes:
        data = read_bytes(n)
        if data and _OBS.on:
            _lit_rx(decoder, len(data))
        return data

    return metered


def _tapped_reader(read_bytes: Callable[[int], bytes],
                   tap: Optional[Callable[[bytes], None]]
                   ) -> Callable[[int], bytes]:
    """``read_bytes`` that hands every non-empty read to ``tap`` before
    returning it (the broadcast tee: an append and an O(1) mark, never a
    block)."""
    if tap is None:
        return read_bytes

    def tapped(n: int) -> bytes:
        data = read_bytes(n)
        if data:
            tap(data)
        return data

    return tapped


def _note_batch(nbytes: int, stats) -> None:
    syscalls = int(stats[0])
    msgs = int(stats[1])
    _M_BATCHES.inc()
    _M_MSGS.inc(msgs)
    _M_SYSCALLS.inc(syscalls)
    if msgs > syscalls:
        _M_SAVED.inc(msgs - syscalls)
    _M_BYTES.inc(nbytes)


def _raise_errno(code: int):
    """``OSError`` of a ``-errno`` return (``BlockingIOError`` for
    ``EAGAIN``, as the socket calls raise it)."""
    raise OSError(code, os.strerror(code))


def recv_pump(decoder, fd: int,
              tap: Optional[Callable[[bytes], None]] = None,
              cap: int = PUMP_BUF) -> None:
    """Pump blocking ``fd`` into ``decoder`` until EOF or destroy, a slab
    a call.

    The batched twin of :func:`.transport.recv_over` (the same flow
    control: no receive while the decoder stalls, resumed by its drain
    watcher); EOF ends the decoder.  ``tap`` sees every slab before the
    decoder does, as a read-only view of the bytes the decoder is fed
    (the fan-out source's ``publish``, which copies it)."""
    st = _RecvState(cap)
    wake = threading.Event()
    decoder._add_drain_watcher(wake.set)
    try:
        while not decoder.destroyed:
            buf = np.empty(st.cap, dtype=np.uint8)  # fresh: see _RecvState
            t0 = _perf()
            nbytes, nframes, consumed, _err = native.pump_recv_scan(
                fd, buf, PUMP_SLICE, st.starts, st.lens, st.ids, st.stats)
            if _OBS.on:
                _H_NATIVE.observe(_perf() - t0)
            if nbytes == 0:
                if not decoder.destroyed and not decoder.finished:
                    decoder.end()
                return
            if nbytes < 0:
                _raise_errno(-nbytes)
            if _OBS.on:
                _note_batch(nbytes, st.stats)
                _lit_rx(decoder, nbytes)
            # the decoder owns this slab from here (its cursors may keep
            # slices of it); the tap sees the same bytes as one view
            data = memoryview(buf)[:nbytes]
            if tap is not None:
                # the broadcast tee (FanoutServer.publish): an append and
                # an O(1) mark under the server lock, never a block
                # datlint: allow-callback-escape
                tap(data)
            wake.clear()
            try:
                ok = decoder.write_indexed(data, st.starts, st.lens,
                                           st.ids, nframes, consumed)
            except DecoderDestroyedError:
                return
            if not ok:
                # the next scan refills st's arrays, which a parked
                # cursor still reads: receive only once it has retired
                while not (decoder.writable() or decoder.destroyed
                           or decoder.finished):
                    wake.wait(WAKE_FALLBACK)
                    wake.clear()
    finally:
        decoder._remove_drain_watcher(wake.set)


def send_pump(encoder, fd: int,
              close: Optional[Callable[[], None]] = None,
              on_progress: Optional[Callable[[], None]] = None) -> None:
    """Pump ``encoder`` to blocking ``fd`` until EOF or destroy.

    The batched twin of :func:`.transport.send_over`: megabyte pulls,
    each pushed through one GIL-released gather call that owns the
    partial-write loop.  ``on_progress`` runs after every accepted batch
    (a reply-stall clock); ``close`` runs on the way out.  A transport
    error (including ``SO_SNDTIMEO`` running out) raises ``OSError``."""
    addrs = np.zeros(1, dtype=np.int64)
    lens = np.zeros(1, dtype=np.int64)
    stats = np.zeros(2, dtype=np.int64)
    readable = threading.Event()
    encoder._attach_readable(readable.set)
    # a wake hook only: it sets an Event, never blocks
    # datlint: allow-callback-escape
    encoder.on_error(lambda _e: readable.set())
    try:
        while True:
            try:
                data = encoder.read(PUMP_SEND_CHUNK)
            except EncoderDestroyedError:
                break
            if data is None:  # finalized and drained
                break
            if not data:
                readable.wait(WAKE_FALLBACK)
                readable.clear()
                continue
            arr = np.frombuffer(data, dtype=np.uint8)
            addrs[0] = arr.__array_interface__["data"][0]
            lens[0] = len(arr)
            t0 = _perf()
            # `data` and `arr` stay referenced (pinned) across the call
            w = native.pump_send_spans(fd, addrs, lens, 1, stats)
            if _OBS.on:
                _H_NATIVE.observe(_perf() - t0)
            if w < 0:
                _raise_errno(-w)
            if _OBS.on:
                _note_batch(w, stats)
                _lit_tx(encoder, w)
            if on_progress is not None:
                # a reply-stall clock: one monotonic read
                # datlint: allow-callback-escape
                on_progress()
    finally:
        encoder._detach_readable()
        if close is not None:
            try:
                # a shutdown or close syscall on the way out: bounded
                # datlint: allow-callback-escape
                close()
            except OSError:
                pass


def _wait_fd(fd: int, events: int, timeout: float) -> None:
    """Wait until ``fd`` is ready for ``events`` or ``timeout`` seconds
    pass; raise as a socket in timeout mode does (``TimeoutError``, or
    ``BlockingIOError`` at a timeout of 0)."""
    if timeout <= 0:
        _raise_errno(errno.EAGAIN)
    poller = select.poll()
    poller.register(fd, events)
    if not poller.poll(timeout * 1000.0):
        raise TimeoutError("timed out")


def pump_reader(fd: int, cap: int = PUMP_BUF,
                timeout: Optional[float] = None) -> Callable[[int], bytes]:
    """A ``read_bytes`` serving batched receives: the ``os.read`` contract
    (``b""`` at EOF, ``OSError`` on a transport error; under
    ``SO_RCVTIMEO``, ``BlockingIOError``), except that it may return MORE
    than the hint, so feed only decoders with it.  ``timeout`` is the
    timeout of a socket in timeout mode (its fd is non-blocking): a
    receive waits at most that long for the first byte, then raises
    ``TimeoutError``."""
    # a reused slab: this surface returns owned bytes (the os.read
    # contract), so the buffer can be recycled.  The index arrays hold
    # one frame: the caller feeds a decoder through write(), which would
    # throw an index away, and a full one would make every call scan the
    # slab for nothing
    buf = np.empty(cap, dtype=np.uint8)
    starts = np.zeros(1, dtype=np.int64)
    lens = np.zeros(1, dtype=np.int64)
    ids = np.zeros(1, dtype=np.uint8)
    stats = np.zeros(2, dtype=np.int64)

    def read_bytes(_hint: int) -> bytes:
        while True:
            t0 = _perf()
            nbytes = native.pump_recv_scan(fd, buf, PUMP_SLICE, starts,
                                           lens, ids, stats)[0]
            if _OBS.on:
                _H_NATIVE.observe(_perf() - t0)
            if nbytes == -errno.EAGAIN and timeout is not None:
                _wait_fd(fd, select.POLLIN, timeout)
                continue
            if nbytes < 0:
                _raise_errno(-nbytes)
            if nbytes == 0:
                return b""
            if _OBS.on:
                _note_batch(nbytes, stats)
            return buf[:nbytes].tobytes()

    return read_bytes


def pump_writer(fd: int,
                timeout: Optional[float] = None) -> Callable[[bytes], None]:
    """A ``write_bytes`` pushing through the gather loop, partial writes
    resumed in C: every byte reaches ``fd`` or ``OSError`` raises
    (``BlockingIOError`` when a blocking fd's ``SO_SNDTIMEO`` runs out,
    as ``sendall`` raises).  ``timeout`` is the timeout of a socket in
    timeout mode: its non-blocking fd takes non-blocking batches, and a
    wait for room longer than that raises ``TimeoutError``."""
    addrs = np.zeros(1, dtype=np.int64)
    lens = np.zeros(1, dtype=np.int64)
    stats = np.zeros(2, dtype=np.int64)

    def write_bytes(data) -> None:
        arr = np.frombuffer(data, dtype=np.uint8)
        done = 0
        while done < len(arr):
            addrs[0] = arr.__array_interface__["data"][0] + done
            lens[0] = len(arr) - done
            t0 = _perf()
            # `arr` stays referenced (pinned) across the call
            w = native.pump_send_spans(fd, addrs, lens, 1, stats,
                                       nonblocking=timeout is not None)
            if _OBS.on:
                _H_NATIVE.observe(_perf() - t0)
            if w < 0:
                _raise_errno(-w)
            if _OBS.on and w:
                _note_batch(w, stats)
            done += w
            if done < len(arr):  # only a non-blocking batch stops short
                _wait_fd(fd, select.POLLOUT, timeout)

    return write_bytes


def io_for_socket(conn, native: bool = True) -> tuple:
    """``(read_bytes, write_bytes)`` for a connected socket: the batched
    :func:`pump_reader`/:func:`pump_writer` (honouring the socket's
    timeout), or with ``native=False`` the socket's own ``recv`` and
    ``sendall``, the plain version."""
    if not native:
        return conn.recv, conn.sendall
    timeout = conn.gettimeout()
    return (pump_reader(conn.fileno(), timeout=timeout),
            pump_writer(conn.fileno(), timeout=timeout))


class SpanGather:
    """Reusable (address, length) span arrays for the fan-out gather: one
    per dispatcher, refilled each serve turn.  Payload bytes never become
    Python objects, only their addresses do."""

    __slots__ = ("addrs", "lens", "stats", "_arrs")

    def __init__(self, cap: int = 1024):
        self.addrs = np.zeros(cap, dtype=np.int64)
        self.lens = np.zeros(cap, dtype=np.int64)
        self.stats = np.zeros(2, dtype=np.int64)
        self._arrs: list = []  # pins the span buffers across a call

    def fill(self, views) -> int:
        """Load ``views`` (memoryviews or bytes) as spans; returns the
        count.  The numpy wraps are zero-copy: the addresses point into
        the callers' buffers, which this object pins until
        :meth:`release` or the next fill."""
        n = len(views)
        if n > len(self.addrs):
            self.addrs = np.zeros(n, dtype=np.int64)
            self.lens = np.zeros(n, dtype=np.int64)
        arrs = []
        for i, v in enumerate(views):
            a = np.frombuffer(v, dtype=np.uint8)
            arrs.append(a)
            self.addrs[i] = a.__array_interface__["data"][0]
            self.lens[i] = len(a)
        self._arrs = arrs
        return n

    def release(self) -> None:
        """Drop the pins (a memoryview with a live numpy export cannot be
        released)."""
        self._arrs = []


def send_spans_nb(fd: int, gather: SpanGather, n: int) -> int:
    """Push ``n`` loaded spans to non-blocking ``fd`` in one gather batch
    (``sendmmsg``/``writev`` until EAGAIN).  Returns the bytes accepted
    (0 = would block); raises ``OSError`` on a dead transport: the
    ``os.writev`` contract the fan-out dispatcher's bookkeeping is
    written against."""
    t0 = _perf()
    w = native.pump_send_spans(fd, gather.addrs, gather.lens, n,
                               gather.stats, nonblocking=True)
    if _OBS.on:
        _H_NATIVE.observe(_perf() - t0)
    if w < 0:
        _raise_errno(-w)
    if _OBS.on and w:
        _note_batch(w, gather.stats)
        _M_GATHER_BYTES.inc(w)
    return w


class EdgePump:
    """Per-session pump state for the event-driven edge: one bounded
    non-blocking turn per call instead of a thread-owned loop.

    ``fd`` MUST be non-blocking: the edge loop sets ``O_NONBLOCK`` at
    admission and never clears it, so every kernel call below returns at
    once on would-block.  ``native=False`` takes the plain arm
    (``os.read``/``os.write``) instead of the batched one."""

    __slots__ = ("fd", "cap", "native", "recv_st", "gather", "pending")

    def __init__(self, fd: int, cap: int = PUMP_BUF, native: bool = True):
        self.fd = fd
        self.cap = cap
        self.native = native
        self.recv_st = _RecvState(cap) if native else None
        self.gather = SpanGather(cap=1) if native else None
        self.pending: Optional[memoryview] = None  # unsent reply tail


def recv_step(pump: EdgePump, decoder, tap=None) -> tuple:
    """ONE bounded receive turn: drain what the kernel already buffered
    on ``pump.fd`` into ``decoder``, never waiting.  Returns ``(nbytes,
    eof)``; ``(0, False)`` means would-block (wait for the selector's
    next READ event).  The batched arm is one ``dat_pump_recv_scan``
    (its first ``read`` returns ``-EAGAIN`` on the non-blocking fd
    instead of sleeping; the slab is ``pump.cap`` bytes) feeding
    ``decoder.write_indexed``; the plain arm ``os.read`` until
    ``EAGAIN``, EOF, a decoder stall or ``pump.cap`` bytes, never more.
    Either way a faulted neighbour costs this session at most one slab of
    latency a turn.  ``tap`` (the fan-out's ``publish``) sees every chunk
    before the decoder does.  The caller receives only while the decoder
    is writable (a parked cursor reads the reused index arrays)."""
    if pump.native:
        return _recv_step_native(pump, decoder, tap)
    res = _recv_step_py(pump, decoder, tap)
    if _OBS.on and res[0]:
        _lit_rx(decoder, res[0])
    return res


def _recv_step_native(pump: EdgePump, decoder, tap=None) -> tuple:
    """The batched arm of :func:`recv_step`."""
    st = pump.recv_st
    buf = np.empty(st.cap, dtype=np.uint8)  # fresh: see _RecvState
    t0 = _perf()
    nbytes, nframes, consumed, _err = native.pump_recv_scan(
        pump.fd, buf, PUMP_SLICE, st.starts, st.lens, st.ids, st.stats)
    if _OBS.on:
        _H_NATIVE.observe(_perf() - t0)
    if nbytes == -errno.EAGAIN:
        return (0, False)  # would block: the next READ event retries
    if nbytes < 0:
        _raise_errno(-nbytes)
    if nbytes == 0:
        return (0, True)
    if _OBS.on:
        _note_batch(nbytes, st.stats)
        _lit_rx(decoder, nbytes)
    data = memoryview(buf)[:nbytes]
    if tap is not None:
        # the broadcast tee (FanoutServer.publish): an append and an
        # O(1) mark under the server lock, never blocks the loop
        # datlint: allow-callback-escape
        tap(data)
    try:
        decoder.write_indexed(data, st.starts, st.lens, st.ids, nframes,
                              consumed)
    except DecoderDestroyedError:
        pass  # the loop's teardown predicate sees dec.destroyed
    return (nbytes, False)


def _recv_step_py(pump: EdgePump, decoder, tap=None) -> tuple:
    """The plain arm of :func:`recv_step`; split out so the transport
    note forks ONCE on the turn's byte total instead of at every
    return."""
    total = 0
    while total < pump.cap:
        try:
            # bounded: pump.fd is O_NONBLOCK by the EdgePump contract, so
            # a silent peer surfaces as BlockingIOError, never a sleep;
            # the read size keeps the turn within pump.cap (the JAX
            # package's reads a whole slice and may pass it)
            # datlint: allow-blocking-reachable(os-io)
            data = os.read(pump.fd, min(PUMP_SLICE, pump.cap - total))
        except BlockingIOError:
            return (total, False)
        except InterruptedError:
            continue
        if not data:
            return (total, True)
        total += len(data)
        if tap is not None:
            # the same broadcast tee as the batched arm's
            # datlint: allow-callback-escape
            tap(data)
        try:
            ok = decoder.write(data)
        except DecoderDestroyedError:
            return (total, False)
        if not ok:
            return (total, False)  # decoder stall: the loop gates reads
    return (total, False)


# one send turn pushes at most this many pulls: the encoder's high-water
# mark bounds what it can buffer, this bounds the turn even against a
# producer that never stops
_SEND_TURN_PULLS = 8


def send_step(pump: EdgePump, encoder) -> tuple:
    """ONE bounded send turn: push encoder output to ``pump.fd`` until
    would-block, the encoder runs dry, or the turn budget.  Returns
    ``(accepted, finished, blocked)``: ``finished`` means the encoder is
    finalized AND drained (the loop may shut the write half down);
    ``blocked`` means the kernel refused bytes still held in
    ``pump.pending`` (watch ``EVENT_WRITE``).  The batched arm sends
    through :func:`send_spans_nb`, the plain one through ``os.write``."""
    res = _send_step_impl(pump, encoder)
    if _OBS.on and res[0]:
        _lit_tx(encoder, res[0])
    return res


def _send_step_impl(pump: EdgePump, encoder) -> tuple:
    """The engine of :func:`send_step`; split out so the transport note
    forks ONCE on the turn's accepted-byte total."""
    accepted = 0
    for _ in range(_SEND_TURN_PULLS):
        if pump.pending is None:
            try:
                data = encoder.read(PUMP_SEND_CHUNK)
            except EncoderDestroyedError:
                return (accepted, True, False)
            if data is None:  # finalized and drained
                return (accepted, True, False)
            if not data:  # nothing ready (the producer still appends)
                return (accepted, False, False)
            pump.pending = memoryview(data) if not isinstance(
                data, memoryview) else data
        view = pump.pending
        if pump.native:
            n = pump.gather.fill([view])
            try:
                w = send_spans_nb(pump.fd, pump.gather, n)
            finally:
                pump.gather.release()
        else:
            try:
                # bounded: pump.fd is O_NONBLOCK by the EdgePump contract,
                # so would-block is an exception, not a sleep
                # datlint: allow-blocking-reachable(os-io)
                w = os.write(pump.fd, view)
            except (BlockingIOError, InterruptedError):
                w = 0
        accepted += w
        if w < len(view):
            pump.pending = view[w:] if w else view
            return (accepted, False, True)
        pump.pending = None
    return (accepted, False, False)
