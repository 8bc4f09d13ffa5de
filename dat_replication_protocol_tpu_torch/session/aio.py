"""asyncio transport pumps: a session over non-blocking byte streams.

The port of ``dat_replication_protocol_tpu/session/aio.py``.  The
reference protocol lives on Node's event loop: ``pipe()`` composes with
any async stream, and backpressure travels through ``write()`` return
values and ``'drain'`` events.  :mod:`.transport` covers blocking
sockets with thread pumps; this module is the single-threaded event-loop
equivalent over :mod:`asyncio` streams:

* **Sender**: pulls :meth:`Encoder.read` and writes to a
  ``StreamWriter``; ``await writer.drain()`` is the congestion stall
  (the kernel send buffer pushes back through asyncio's flow control).
  An empty pull awaits the encoder's readable event.
* **Receiver**: feeds ``StreamReader`` chunks to :meth:`Decoder.write`;
  when the decoder stalls on an outstanding ``done``, the pump awaits
  the write-completion callback before reading on, so the kernel
  receive buffer (not host memory) absorbs the in-flight window.
  Everything runs on one event loop, so there is no lost-wakeup window.

With ``decode(backend="cuda")`` on the receiving end every change and
blob is hashed on kernel B1 through the decoder's ``DigestPipeline``;
the pump moves bytes only.  App callbacks fire on the event loop
thread; ``done`` acks may be issued at once or from any later task or
callback on the same loop.

Telemetry: ``aio.wake.event`` / ``aio.wake.poll`` count the pumps' waits
ended by the event and by the :data:`~.transport.WAKE_FALLBACK` bound.
"""

from __future__ import annotations

import asyncio

from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS, counter as _counter
from ..wire.framing import ProtocolError
from .decoder import Decoder, DecoderDestroyedError
from .encoder import Encoder, EncoderDestroyedError
from .transport import DEFAULT_CHUNK, WAKE_FALLBACK

__all__ = ["send_over_async", "recv_over_async",
           "open_connection_with_retry", "session_over_asyncio"]

_M_AIO_WAKE_EVENT = _counter("aio.wake.event")
_M_AIO_WAKE_POLL = _counter("aio.wake.poll")


async def _bounded_wait(event: asyncio.Event) -> None:
    """Await ``event`` for at most :data:`~.transport.WAKE_FALLBACK`
    seconds; the waiter re-checks its loop condition either way, so a
    lost wakeup costs a short delay, never a parked pump."""
    try:
        await asyncio.wait_for(event.wait(), WAKE_FALLBACK)
        if _OBS.on:
            _M_AIO_WAKE_EVENT.inc()
    except asyncio.TimeoutError:
        if _OBS.on:
            _M_AIO_WAKE_POLL.inc()


async def _drain_with_stall_detect(encoder: Encoder,
                                   writer: asyncio.StreamWriter,
                                   stall_timeout: float) -> bool:
    """Drain with a PROGRESS deadline, not a completion deadline: a slow
    but live peer (buffer shrinking) re-arms the clock every
    ``stall_timeout``; only a peer whose window made no progress at all
    is declared stalled (structured error, encoder destroyed).  Returns
    False when the session was failed."""
    while True:
        before = writer.transport.get_write_buffer_size()
        try:
            await asyncio.wait_for(writer.drain(), stall_timeout)
            return True
        except asyncio.TimeoutError:
            if writer.transport.get_write_buffer_size() < before:
                continue  # the peer IS reading, slowly: re-arm
            if _OBS.on:
                _emit("session.stall", kind="peer-drain",
                      seconds=stall_timeout, offset=encoder.bytes)
            err = ProtocolError(
                f"peer stalled: no drain progress for {stall_timeout}s",
                offset=encoder.bytes,
            )
            if not encoder.destroyed:
                encoder.destroy(err)
            return False


async def send_over_async(
    encoder: Encoder,
    writer: asyncio.StreamWriter,
    chunk_size: int = DEFAULT_CHUNK,
    stall_timeout: float | None = None,
) -> None:
    """Pump ``encoder`` into an asyncio writer until EOF or destroy.

    ``stall_timeout`` bounds drain *progress*, not completion: a peer
    that reads nothing for that long fails the session with a structured
    :class:`~..wire.framing.ProtocolError`, while a slow but live peer
    re-arms the clock each window; ``None`` trusts the peer entirely.
    """
    readable = asyncio.Event()
    encoder._attach_readable(readable.set)
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
                await _bounded_wait(readable)
                readable.clear()
                continue
            try:
                writer.write(bytes(data))
                if stall_timeout is None:
                    # congestion backpressure, unbounded by the caller's
                    # choice (see stall_timeout)
                    # datlint: allow-unbounded-wait (opt-in via stall_timeout)
                    await writer.drain()
                elif not await _drain_with_stall_detect(
                        encoder, writer, stall_timeout):
                    break
            except OSError as e:  # every ConnectionError included
                # the peer is gone mid-session: cascade into the encoder
                # (destroy releases parked callbacks) and stop
                if not encoder.destroyed:
                    encoder.destroy(e)
                break
    finally:
        encoder._detach_readable()
        try:
            if writer.can_write_eof():
                writer.write_eof()
        except (OSError, RuntimeError):
            pass


async def recv_over_async(
    decoder: Decoder,
    reader,
    chunk_size: int = DEFAULT_CHUNK,
) -> None:
    """Pump an asyncio reader into ``decoder`` until EOF or destroy.

    ``reader`` is anything with ``async read(n)``: an
    ``asyncio.StreamReader`` or a fault-injecting wrapper
    (:class:`~.faults.AsyncFaultyReader`).
    """
    while not decoder.destroyed:
        try:
            data = await reader.read(chunk_size)
        except OSError as e:
            # the peer reset mid-frame: cascade so the app's on_error
            # fires (a decoder already destroyed or finished stays so)
            if not decoder.destroyed and not decoder.finished:
                decoder.destroy(e)
            return
        if not data:
            if not decoder.destroyed and not decoder.finished:
                decoder.end()
            return
        drained = asyncio.Event()
        try:
            consumed = decoder.write(data, on_consumed=drained.set)
        except DecoderDestroyedError:
            return
        if not consumed:
            # acks run on this loop, so the event cannot be missed; the
            # wait is bounded all the same (an ack deferred off the loop
            # costs a fallback period, not a hang)
            while not (decoder.writable() or decoder.destroyed
                       or decoder.finished):
                await _bounded_wait(drained)
                drained.clear()


async def open_connection_with_retry(
    host: str,
    port: int,
    policy=None,
) -> tuple[asyncio.StreamReader, asyncio.StreamWriter]:
    """``asyncio.open_connection`` under the reconnect backoff policy.

    Retries refused or failed dials with exponential backoff and full
    jitter (:class:`~.reconnect.BackoffPolicy`); running out of attempts
    raises ONE :class:`~..wire.framing.ProtocolError` whose ``cause`` is
    the last ``OSError``.
    """
    from .reconnect import BackoffPolicy

    if policy is None:
        policy = BackoffPolicy()
    failures = 0
    while True:
        try:
            return await asyncio.open_connection(host, port)
        except OSError as e:
            failures += 1
            if failures > policy.max_retries:
                raise ProtocolError(
                    f"connect to {host}:{port} failed after {failures} "
                    f"attempt(s)",
                    cause=e,
                ) from e
            await asyncio.sleep(policy.delay(failures))


async def session_over_asyncio(
    encoder: Encoder,
    decoder: Decoder,
    chunk_size: int = DEFAULT_CHUNK,
) -> None:
    """Run a whole session over a kernel socketpair on the event loop.

    Opens both ends, pumps them concurrently, and returns when the
    sender has flushed EOF and the receiver has finished (or either was
    destroyed).  Teardown aborts the transports, so it never waits on a
    peer that stopped reading.
    """
    import socket

    a, b = socket.socketpair()
    a.setblocking(False)
    b.setblocking(False)
    writers: list[asyncio.StreamWriter] = []
    send_task = recv_task = None
    try:
        _, writer = await asyncio.open_connection(sock=a)
        writers.append(writer)  # at once: if the second open raises, the
        # finally must still tear this transport down
        reader, writer_b = await asyncio.open_connection(sock=b)
        writers.append(writer_b)
        send_task = asyncio.ensure_future(
            send_over_async(encoder, writer, chunk_size)
        )
        recv_task = asyncio.ensure_future(
            recv_over_async(decoder, reader, chunk_size)
        )
        done, pending = await asyncio.wait(
            {send_task, recv_task}, return_when=asyncio.FIRST_COMPLETED
        )
        if pending and recv_task in done:
            # the receiver left early (destroy): nothing will read the
            # socket again.  Abort the transports (fails a sender blocked
            # in drain()) AND destroy the encoder (wakes a sender parked
            # on an idle encoder's readable event)
            for w in writers:
                w.transport.abort()
            if not encoder.destroyed:
                encoder.destroy(ConnectionAbortedError("receiver gone"))
        await asyncio.gather(send_task, recv_task)
    finally:
        # one pump failing must not orphan the other
        for t in (send_task, recv_task):
            if t is not None and not t.done():
                t.cancel()
                try:
                    await t
                except (asyncio.CancelledError, Exception):
                    pass
        # abort, not close: a flushing close on a congested transport
        # waits for a peer that may never read; on the normal path the
        # sender already drained every write, so nothing is discarded
        for w in writers:
            try:
                w.transport.abort()
                w.close()
            except (OSError, RuntimeError):
                pass
        for w in writers:
            try:
                await w.wait_closed()
            except (OSError, RuntimeError):
                pass
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass
