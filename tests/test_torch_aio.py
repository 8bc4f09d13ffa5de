"""The port's asyncio transport against the JAX package's.

The JAX package's cases of ``test_aio.py`` on the port (changes and a
blob over ``session_over_asyncio``, deferred acks, a 1 MiB blob under
backpressure, the two destroy cases that must end within 10 s, and the
re-segmenting ``AsyncFaultyReader``), then:

* ``session_over_asyncio`` into ``decode(backend="cuda", device="cpu")``
  (B1's plain version): every digest in submit order, before the
  finalize hook, equal to ``hashlib`` and to the JAX package's session
  over the same wire;
* ``AsyncFaultyReader`` against the JAX ``AsyncFaultyReader`` for the
  same plans (``FaultPlan.for_sweep`` seeds 0-7): the same chunks, the
  same faults;
* ``open_connection_with_retry`` dialling until a late server appears,
  and running out of attempts in one ``ProtocolError`` whose ``cause``
  is an ``OSError``.
"""

import asyncio
import dataclasses
import hashlib
import socket

import pytest

import dat_replication_protocol_tpu as jax_protocol
from dat_replication_protocol_tpu.session import aio as jax_aio
from dat_replication_protocol_tpu.session import faults as jax_faults
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.session import aio
from dat_replication_protocol_tpu_torch.session.aio import (
    open_connection_with_retry, recv_over_async, send_over_async,
    session_over_asyncio)
from dat_replication_protocol_tpu_torch.session.faults import (
    AsyncFaultyReader, FaultPlan)
from dat_replication_protocol_tpu_torch.session.reconnect import (
    BackoffPolicy)
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change)
from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError


def _run(coro):
    return asyncio.run(coro)


def _h(p: bytes) -> bytes:
    return hashlib.blake2b(p, digest_size=32).digest()


# -- the JAX package's cases, on the port -----------------------------------------


def test_changes_and_blob_over_asyncio():
    enc, dec = protocol.encode(), protocol.decode()
    got = []
    dec.change(lambda c, done: (got.append(("change", c.key)), done()))
    dec.blob(
        lambda b, done: b.collect(lambda d: (got.append(("blob", d)), done()))
    )
    dec.finalize(lambda done: (got.append(("finalize",)), done()))

    async def main():
        enc.change({"key": "a", "change": 1, "from": 0, "to": 1})
        ws = enc.blob(11)
        ws.write(b"hello ")
        ws.end(b"world")
        enc.change({"key": "b", "change": 2, "from": 1, "to": 2})
        enc.finalize()
        await asyncio.wait_for(session_over_asyncio(enc, dec), 30)

    _run(main())
    assert got == [("change", "a"), ("blob", b"hello world"),
                   ("change", "b"), ("finalize",)]
    assert enc.bytes == dec.bytes and dec.changes == 2 and dec.blobs == 1


def test_deferred_ack_stalls_and_resumes():
    enc, dec = protocol.encode(), protocol.decode()
    order = []

    def on_change(c, done):
        order.append(f"change-{c.key}")
        # acked later from the event loop: the pump stalls (no drop, no
        # reorder) until the deferred done fires
        asyncio.get_running_loop().call_later(0.05, done)

    dec.change(on_change)
    dec.finalize(lambda done: (order.append("finalize"), done()))

    async def main():
        for i in range(5):
            enc.change({"key": str(i), "change": i, "from": i, "to": i + 1})
        enc.finalize()
        await asyncio.wait_for(session_over_asyncio(enc, dec), 30)

    _run(main())
    assert order == [f"change-{i}" for i in range(5)] + ["finalize"]


def test_large_blob_backpressure_over_asyncio():
    enc, dec = protocol.encode(), protocol.decode()
    total = (1 << 20) + 12345
    seen = bytearray()

    def on_blob(b, done):
        b.on_data(lambda piece: seen.extend(piece))
        b.on_end(lambda: done())

    dec.blob(on_blob)

    async def feed():
        ws = enc.blob(total)
        sent = 0
        while sent < total:
            n = min(64 * 1024, total - sent)
            ws.write(bytes([sent % 251]) * n)
            sent += n
            await asyncio.sleep(0)  # let the pumps interleave
        ws.end()
        enc.finalize()

    async def main():
        await asyncio.wait_for(
            asyncio.gather(feed(), session_over_asyncio(enc, dec)), 60)

    _run(main())
    assert len(seen) == total
    assert dec.blobs == 1


def test_decoder_destroy_mid_blob_does_not_hang():
    # a destroyed decoder leaves the socket unread: the session aborts
    # the stuck sender instead of deadlocking in writer.drain()
    enc, dec = protocol.encode(), protocol.decode()

    def on_blob(b, done):
        b.on_data(lambda piece: dec.destroy(RuntimeError("app bail")))

    dec.blob(on_blob)
    dec.on_error(lambda e: None)
    enc.on_error(lambda e: None)

    async def main():
        ws = enc.blob(4 << 20)
        ws.end(b"\xab" * (4 << 20))
        enc.finalize()
        await asyncio.wait_for(session_over_asyncio(enc, dec), 10)

    _run(main())
    assert dec.destroyed


def test_decoder_destroy_with_idle_sender_does_not_hang():
    # the receiver leaves while the sender is parked on an idle,
    # unfinalized encoder: the session destroys the encoder
    enc, dec = protocol.encode(), protocol.decode()
    errs = []
    dec.change(lambda c, done: dec.destroy(RuntimeError("bail")))
    dec.on_error(lambda e: errs.append(e))
    enc.on_error(lambda e: errs.append(e))

    async def main():
        enc.change({"key": "x", "change": 1, "from": 0, "to": 1})
        await asyncio.wait_for(session_over_asyncio(enc, dec), 10)

    _run(main())
    assert dec.destroyed and enc.destroyed


def test_async_fault_injector_resegmentation_is_transparent():
    enc, dec = protocol.encode(), protocol.decode()
    got = []
    dec.change(lambda c, done: (got.append(("change", c.key)), done()))
    dec.blob(
        lambda b, done: b.collect(lambda d: (got.append(("blob", d)), done()))
    )

    async def main():
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        _, writer = await asyncio.open_connection(sock=a)
        reader, writer_b = await asyncio.open_connection(sock=b)
        enc.change({"key": "a", "change": 1, "from": 0, "to": 1})
        ws = enc.blob(11)
        ws.write(b"hello ")
        ws.end(b"world")
        enc.change({"key": "b", "change": 2, "from": 1, "to": 2})
        enc.finalize()
        chaotic = AsyncFaultyReader(
            reader, FaultPlan(seed=9, max_segment=7, latency_prob=0.1,
                              latency_s=0.001))
        await asyncio.wait_for(asyncio.gather(
            send_over_async(enc, writer),
            recv_over_async(dec, chaotic),
        ), 30)
        for w in (writer, writer_b):
            w.transport.abort()
            w.close()
        a.close()
        b.close()

    _run(main())
    assert got == [("change", "a"), ("blob", b"hello world"), ("change", "b")]
    assert dec.finished


# -- digests on B1 against hashlib and the JAX package's session -----------------


def _records(n: int) -> list:
    return [{"key": f"r{i}", "change": i, "from": 0, "to": 1,
             "value": bytes([i % 251]) * (i % 97 + 1)} for i in range(n)]


def _blob(i: int) -> bytes:
    return bytes([(i * 7 + k) % 256 for k in range(64)]) * (8 + i)


def _digest_session(prot, dec, aio_mod) -> tuple:
    enc = prot.encode()
    got = []
    finalized = []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, bytes(d))))
    dec.change(lambda c, done: done())
    dec.blob(lambda b, done: b.collect(lambda _d: done()))
    dec.finalize(lambda done: (finalized.append(len(got)), done()))

    async def main():
        recs = _records(120)
        for i, r in enumerate(recs):
            enc.change(r)
            if i % 30 == 29:
                enc.blob(len(_blob(i))).end(_blob(i))
        enc.finalize()
        await asyncio.wait_for(aio_mod.session_over_asyncio(enc, dec), 60)

    _run(main())
    return got, finalized, dec.finished


def test_cuda_decoder_digests_over_asyncio_equal_hashlib_and_jax():
    got, fin, ok = _digest_session(
        protocol, protocol.decode(backend="cuda", device="cpu"), aio)
    want, jfin, jok = _digest_session(
        jax_protocol, jax_protocol.decode(backend="tpu"), jax_aio)
    assert ok and jok
    assert got == want
    recs = _records(120)
    truth = []
    for i, r in enumerate(recs):
        truth.append(("change", i, _h(encode_change(r))))
        if i % 30 == 29:
            truth.append(("blob", i // 30, _h(_blob(i))))
    assert got == truth
    assert fin == [len(truth)] == jfin  # every digest before finalize


# -- AsyncFaultyReader against the JAX package's ---------------------------------


class _AsyncBytes:
    """An ``async read(n)`` source over bytes, in reads of at most 4 KiB."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    async def read(self, n: int) -> bytes:
        await asyncio.sleep(0)
        j = min(len(self._data), self._pos + min(n, 4096))
        out = self._data[self._pos:j]
        self._pos = j
        return out


async def _deliveries(reader) -> list:
    out = []
    while True:
        try:
            chunk = await reader.read(1000)
        except Exception as e:  # noqa: BLE001 — the fault is the result
            out.append(("raise", type(e).__name__))
            return out
        out.append(chunk)
        if not chunk:
            return out


@pytest.mark.parametrize("seed", range(8))
def test_async_faulty_reader_delivers_what_jax_delivers(seed):
    data = hashlib.shake_256(b"aio-%d" % seed).digest(8192)
    runs = []
    for cls, plan_cls in ((AsyncFaultyReader, FaultPlan),
                          (jax_faults.AsyncFaultyReader,
                           jax_faults.FaultPlan)):
        plan = plan_cls.for_sweep(seed, len(data), attempt=0)
        plan = dataclasses.replace(plan, stall_s=min(plan.stall_s, 0.01),
                                   latency_s=min(plan.latency_s, 0.001))
        runs.append(_run(_deliveries(cls(_AsyncBytes(data), plan))))
    got, want = runs
    assert got == want
    delivered = b"".join(c for c in got if isinstance(c, bytes))
    assert 0 < len(delivered) <= len(data)


# -- open_connection_with_retry ----------------------------------------------------


def _free_port() -> int:
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    return port


def test_open_connection_with_retry_dials_until_server_appears():
    async def main():
        port = _free_port()  # nothing listens yet
        box = {}

        async def start_server_later():
            await asyncio.sleep(0.1)
            # the handler closes its writer: on Python 3.12 the server's
            # wait_closed() waits for every connection it accepted
            box["srv"] = await asyncio.start_server(
                lambda r, w: w.close(), "127.0.0.1", port)

        starter = asyncio.ensure_future(start_server_later())
        policy = BackoffPolicy(base=0.05, cap=0.1, max_retries=20, seed=3)
        reader, writer = await open_connection_with_retry(
            "127.0.0.1", port, policy)
        writer.close()
        await starter
        box["srv"].close()
        await box["srv"].wait_closed()
        return True

    assert asyncio.run(asyncio.wait_for(main(), 10))


def test_open_connection_with_retry_exhausts_to_one_protocol_error():
    async def main():
        policy = BackoffPolicy(base=0.01, cap=0.02, max_retries=2, seed=1)
        with pytest.raises(ProtocolError) as ei:
            await open_connection_with_retry("127.0.0.1", _free_port(),
                                             policy)
        return ei.value

    err = asyncio.run(asyncio.wait_for(main(), 10))
    assert isinstance(err.cause, OSError)
    assert "after 3 attempt(s)" in str(err)
