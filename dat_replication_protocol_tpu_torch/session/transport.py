"""Byte-transport adapters: run a session over real OS byte streams.

The port's own copy of ``dat_replication_protocol_tpu/session/transport.py``
(the reference's L0 is any Node stream: ``encode.pipe(socket)`` /
``socket.pipe(decode)``, example.js:53).  Blocking pump loops move wire
bytes between the pull-based Encoder / push-based Decoder and a socket
or file descriptor while honoring both sides' flow control:

* **Sender**: :func:`send_over` pulls from :meth:`Encoder.read` and
  writes to the transport.  A full kernel send buffer blocks the write,
  which stops the pull, which leaves the encoder above its high-water
  mark, which makes producer ``write()`` calls return ``False``.
* **Receiver**: :func:`recv_over` stops reading whenever
  :meth:`Decoder.write` reports a stall (an outstanding app ``done``),
  resuming on the decoder's drain watcher.  The kernel receive buffer
  fills meanwhile and the peer's sends block: the reference's end-to-end
  valve, with the OS socket buffers as the pipe.

The pumps block by design (one thread per end).  They are the plain
version of the wire pump: :mod:`.pump` holds the batched-syscall twins
(``recv_pump``, ``send_pump``, ``io_for_socket``), the route every
socket and fd path takes unless a caller passes ``native=False``.

Telemetry: ``transport.{send,recv}.wake.{event,poll}`` count waits ended
by the event plumbing and by the ``WAKE_FALLBACK`` poll.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Callable

from ..obs.metrics import OBS as _OBS, counter as _counter
from .decoder import Decoder, DecoderDestroyedError
from .encoder import Encoder, EncoderDestroyedError

DEFAULT_CHUNK = 64 * 1024

# Wakeup attribution (OBSERVABILITY.md): `.event` counts waits ended by
# the drain-watcher / readable-hook actually firing, `.poll` counts
# WAKE_FALLBACK expiries — whether the event plumbing really carries the
# wakeups or the guarded poll is doing the work.
_M_RECV_WAKE_EVENT = _counter("transport.recv.wake.event")
_M_RECV_WAKE_POLL = _counter("transport.recv.wake.poll")
_M_SEND_WAKE_EVENT = _counter("transport.send.wake.event")
_M_SEND_WAKE_POLL = _counter("transport.send.wake.poll")

# Guarded-fallback poll period: wakeups are event-driven (the encoder's
# readable hook / the decoder's drain watchers), so this bound only
# matters if a wakeup is ever lost to an unknown race — the pump then
# rediscovers the state within one period instead of hanging forever.
WAKE_FALLBACK = 0.5


def send_over(
    encoder: Encoder,
    write_bytes: Callable[[bytes], None],
    close: Callable[[], None] | None = None,
    chunk_size: int = DEFAULT_CHUNK,
) -> None:
    """Pump ``encoder`` to a blocking byte sink until EOF or destroy.

    ``write_bytes`` must block when the transport is congested (that is
    the backpressure).  ``close`` (e.g. ``sock.shutdown(SHUT_WR)``) runs
    on the way out so the peer observes EOF.

    The pump's own waits are bounded (``WAKE_FALLBACK``); blocking in
    ``write_bytes`` is the backpressure contract, and a caller that needs
    a bound sets it on the socket or fd.
    """
    readable = threading.Event()
    encoder._attach_readable(readable.set)
    # wake hook only: sets an Event, never blocks
    encoder.on_error(lambda _e: readable.set())
    try:
        while True:
            try:
                data = encoder.read(chunk_size)
            except EncoderDestroyedError:
                break
            if data is None:  # finalized and drained
                break
            if not data:
                # bounded: the readable hook fires on every push, but a
                # hang here has no recovery path at all — re-check on the
                # fallback period rather than trusting a single wakeup
                woke = readable.wait(WAKE_FALLBACK)
                if _OBS.on:
                    (_M_SEND_WAKE_EVENT if woke
                     else _M_SEND_WAKE_POLL).inc()
                readable.clear()
                continue
            # blocking here IS the backpressure (docstring above)
            write_bytes(bytes(data))
    finally:
        encoder._detach_readable()
        if close is not None:
            try:
                close()
            except OSError:
                pass


def recv_over(
    decoder: Decoder,
    read_bytes: Callable[[int], bytes],
    chunk_size: int = DEFAULT_CHUNK,
) -> None:
    """Pump a blocking byte source into ``decoder`` until EOF or destroy.

    ``read_bytes(n)`` returns up to n bytes, or ``b''`` at EOF.  When the
    decoder stalls on an outstanding app ``done``, reading is suspended
    until the decoder's drain watcher fires — so the kernel receive
    buffer (not host RAM) absorbs the in-flight window and the peer's
    sends eventually block.

    The stall loop is bounded (``WAKE_FALLBACK``); a silent peer parks
    ``read_bytes`` until the session's owner tears it down, so the bound
    lives with whoever owns the fd.
    """
    # Persistent drain watcher, not a per-write on_consumed callback: a
    # done() ack landing on another thread while THIS thread is still
    # inside _consume used to be a lost wakeup (the acking thread's
    # _resume saw _consuming and returned without firing anything; the
    # consuming thread had already taken its stall exit).  The watcher
    # fires from the acking thread the moment the stall clears, so the
    # pump wakes immediately; the bounded wait below stays only as a
    # guarded fallback for wakeup paths not yet mapped.
    wake = threading.Event()
    decoder._add_drain_watcher(wake.set)
    try:
        while not decoder.destroyed:
            data = read_bytes(chunk_size)
            if not data:
                if not decoder.destroyed and not decoder.finished:
                    decoder.end()
                return
            wake.clear()
            try:
                consumed = decoder.write(data)
            except DecoderDestroyedError:
                return
            if not consumed:
                while not (decoder.writable() or decoder.destroyed
                           or decoder.finished):
                    woke = wake.wait(WAKE_FALLBACK)
                    if _OBS.on:
                        (_M_RECV_WAKE_EVENT if woke
                         else _M_RECV_WAKE_POLL).inc()
                    wake.clear()
    finally:
        decoder._remove_drain_watcher(wake.set)


def start_sender(encoder: Encoder, write_bytes: Callable[[bytes], None],
                 close: Callable[[], None] | None = None,
                 chunk_size: int = DEFAULT_CHUNK,
                 name: str = "send-over") -> threading.Thread:
    """:func:`send_over` on a daemon thread, the sender half of a duplex
    driver.  A transport error there (the peer went away) ends the
    thread quietly: the driver's receive half surfaces the failure as
    the session's structured error."""

    def run() -> None:
        try:
            send_over(encoder, write_bytes, close, chunk_size=chunk_size)
        except OSError:
            pass

    sender = threading.Thread(target=run, name=name, daemon=True)
    sender.start()
    return sender


# -- socket / fd bindings ----------------------------------------------------


def send_over_socket(encoder: Encoder, sock: socket.socket,
                     chunk_size: int = DEFAULT_CHUNK) -> None:
    send_over(
        encoder,
        sock.sendall,
        close=lambda: sock.shutdown(socket.SHUT_WR),
        chunk_size=chunk_size,
    )


def recv_over_socket(decoder: Decoder, sock: socket.socket,
                     chunk_size: int = DEFAULT_CHUNK) -> None:
    recv_over(decoder, sock.recv, chunk_size=chunk_size)


def once(close_fn: Callable[[], None]) -> Callable[[], None]:
    """Close-once guard: the returned callable runs ``close_fn`` on the
    first call only, atomically across threads (mirrors the sidecar's
    once-only stdio close).  Share it between a pump's ``close`` hook and
    the caller's own error-path cleanup so neither double-closes — a
    second ``os.close`` on a released fd number can hit an unrelated
    descriptor some other thread was just handed."""
    guard = threading.Lock()

    def _once() -> None:
        if guard.acquire(blocking=False):
            close_fn()

    return _once


def write_all(fd: int, data) -> None:
    """Blocking write loop: every byte of ``data`` reaches ``fd`` or the
    OSError propagates (the sidecar's stdio writer binds it)."""
    view = memoryview(data)
    while view:
        # a full pipe or socket blocking here is the backpressure
        view = view[os.write(fd, view):]


def send_over_fd(encoder: Encoder, fd: int,
                 chunk_size: int = DEFAULT_CHUNK,
                 close: Callable[[], None] | None = None,
                 ) -> Callable[[], None]:
    """Pump ``encoder`` into a raw fd; closes it exactly once on the way
    out.  ``close`` lets the caller share its own :func:`once` guard (and
    is returned either way, so error-path cleanup can safely invoke it
    again — the old ``close=lambda: os.close(fd)`` double-closed when the
    caller also closed the fd after a pump error)."""
    if close is None:
        close = once(lambda: os.close(fd))
    send_over(encoder, lambda data: write_all(fd, data), close=close,
              chunk_size=chunk_size)
    return close


def recv_over_fd(decoder: Decoder, fd: int,
                 chunk_size: int = DEFAULT_CHUNK) -> None:
    recv_over(decoder, lambda n: os.read(fd, n), chunk_size=chunk_size)


class SocketSession:
    """Both ends of a session wired through an OS socketpair.

    The in-process stand-in for the reference's
    ``encode.pipe(socket) ... socket.pipe(decode)`` wiring: unlike
    :class:`.pipe.Pipe` (a same-call-stack loopback), every byte crosses
    the kernel, both pump loops run on their own threads, and flow
    control is exercised against real, bounded socket buffers.
    """

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 chunk_size: int = DEFAULT_CHUNK,
                 sndbuf: int | None = None):
        self.encoder = encoder
        self.decoder = decoder
        self._a, self._b = socket.socketpair()
        if sndbuf is not None:
            # shrink the kernel window so tests can observe stalls with
            # modest payloads
            self._a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, sndbuf)
            self._b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, sndbuf)
        self._sender = threading.Thread(
            target=send_over_socket, args=(encoder, self._a, chunk_size),
            daemon=True,
        )
        self._receiver = threading.Thread(
            target=recv_over_socket, args=(decoder, self._b, chunk_size),
            daemon=True,
        )
        self._sender.start()
        self._receiver.start()

    def wait(self, timeout: float | None = 30.0) -> None:
        """Join both pumps (the session is over when both return)."""
        self._sender.join(timeout)
        self._receiver.join(timeout)
        if self._sender.is_alive() or self._receiver.is_alive():
            raise TimeoutError("transport pumps did not finish")
        self._a.close()
        self._b.close()


def session_over_socketpair(encoder: Encoder, decoder: Decoder,
                            chunk_size: int = DEFAULT_CHUNK,
                            sndbuf: int | None = None) -> SocketSession:
    """Start pumping ``encoder -> kernel socketpair -> decoder``."""
    return SocketSession(encoder, decoder, chunk_size, sndbuf)
