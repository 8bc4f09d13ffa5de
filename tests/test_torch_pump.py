"""The port's wire pump, case by case against the JAX package's.

The port's counterpart of every case of ``tests/test_pump.py``: the
probe and the route (native, whatever ``DAT_PUMP`` says), batched
receives that index, zero-length and one-byte frames straddling
receive batches, a pipe (no ``recvmmsg``), ``write_indexed`` mid-frame,
the blocking and non-blocking gathers, a dead fd, partial writes
resumed, the reader/writer pair, the fan-out's gather (its byte counter
equal to ``fanout.sent.bytes``) and its plain route, and the route in
the stats record and the hub's snapshot.

Then what the port adds:

* the JAX package's fault that the port does not copy: under
  ``SO_SNDTIMEO`` a blocking native send to a peer that stopped reading
  raises ``OSError(EAGAIN)`` in the port, as ``sendall`` does, while the
  JAX package's writer is still blocked seconds later;
* a parked bulk cursor keeps views of the pump's reused index arrays,
  so no receive may scan while one is parked: a handler holds its
  ``done`` across a second batch;
* ``serve_stdio`` over real pipes (the sidecar's ``--stdio``);
* ``write_indexed`` on a ``Decoder(native=False)`` takes ``write()``;
* sockets in timeout mode and under ``SO_RCVTIMEO`` through
  ``io_for_socket``; ``run_session`` over fds against its callables.
"""

from __future__ import annotations

import errno
import hashlib
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.runtime import native as jax_native
from dat_replication_protocol_tpu.session import pump as jax_pump
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.runtime import native
from dat_replication_protocol_tpu_torch.session import pump
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire.framing import (TYPE_BLOB,
                                                             frame,
                                                             frame_wire_len)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def port_obs():
    """The port's gate on, with a clean registry."""
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()


def _recv_all(sock: socket.socket) -> bytes:
    parts = []
    while True:
        d = sock.recv(1 << 16)
        if not d:
            return b"".join(parts)
        parts.append(d)


def _gather_for(payloads):
    g = pump.SpanGather()
    n = g.fill([memoryview(p) for p in payloads])
    return g, n


def _blob_collector(dec) -> list:
    got = []
    dec.blob(lambda blob, done: blob.collect(
        lambda data: (got.append(bytes(data)), done())))
    return got


# -- probe and route ---------------------------------------------------------


def test_probe_reports_syscall_tier():
    caps = pump.probe_caps()
    assert caps["native_available"] is True
    assert caps["route"] == "native"
    assert isinstance(caps["recvmmsg"], bool)
    assert isinstance(caps["sendmmsg"], bool)
    assert caps == {**jax_pump.probe_caps(), "route": "native"}


def test_route_selector_resolution(monkeypatch):
    # no environment variable picks the port's route: DAT_PUMP is the
    # JAX package's switch alone
    for value in ("python", "native", "iouring"):
        monkeypatch.setenv("DAT_PUMP", value)
        assert pump.effective_pump_route() == "native"
        assert pump.EdgePump(0).native is True
    monkeypatch.delenv("DAT_PUMP")
    assert pump.effective_pump_route() == "native"
    assert pump.EdgePump(0, native=False).native is False


# -- batched receive -----------------------------------------------------------


def test_recv_scan_batches_and_indexes():
    a, b = socket.socketpair()
    try:
        wire = frame(TYPE_BLOB, b"x" * 1000) * 40
        a.sendall(wire)
        a.shutdown(socket.SHUT_WR)
        dec = Decoder()
        got = _blob_collector(dec)
        pump.recv_pump(dec, b.fileno())
        assert dec.finished and len(got) == 40
        assert all(g == b"x" * 1000 for g in got)
    finally:
        a.close()
        b.close()


def test_zero_length_and_single_byte_frames_straddle_batches():
    """A zero-length blob frame and headers arriving one byte a batch
    decode as one whole write does: batch edges are not frame edges."""
    wire = (frame(TYPE_BLOB, b"") + frame(TYPE_BLOB, b"z")
            + frame(TYPE_BLOB, b"") + frame(TYPE_BLOB, b"tail"))
    a, b = socket.socketpair()
    try:
        dec = Decoder()
        got = _blob_collector(dec)

        def feed():
            for i in range(len(wire)):
                a.sendall(wire[i:i + 1])
                if i % 3 == 0:
                    time.sleep(0.002)
            a.shutdown(socket.SHUT_WR)

        t = threading.Thread(target=feed, daemon=True)
        t.start()
        pump.recv_pump(dec, b.fileno())
        t.join(10)
        assert dec.finished
        assert got == [b"", b"z", b"", b"tail"]
        assert dec.blobs == 4
    finally:
        a.close()
        b.close()


def test_recv_pump_on_pipe_degrades_to_plain_reads(port_obs):
    """A pipe has no recvmmsg (ENOTSOCK): the wakeup read carries the
    session alone, the sidecar's --stdio shape."""
    r, w = os.pipe()
    try:
        wire = frame(TYPE_BLOB, b"p" * 500) * 8
        os.write(w, wire)
        os.close(w)
        w = None
        dec = Decoder()
        got = _blob_collector(dec)
        pump.recv_pump(dec, r)
        assert dec.finished and len(got) == 8
        c = metrics.snapshot()["counters"]
        assert c["transport.pump.bytes"] == len(wire)
        assert c["transport.pump.batches"] >= 1
    finally:
        os.close(r)
        if w is not None:
            os.close(w)


def test_write_indexed_falls_back_mid_frame():
    """The bulk entry installs only at a clean boundary: mid-frame it
    takes write() with the same deliveries."""
    wire = frame(TYPE_BLOB, b"A" * 1000)
    dec = Decoder()
    got = _blob_collector(dec)
    dec.write(wire[:100])  # mid-blob now
    starts = np.zeros(4, np.int64)
    lens = np.zeros(4, np.int64)
    ids = np.zeros(4, np.uint8)
    # a bogus index must be ignored: the parser is mid-frame
    ok = dec.write_indexed(wire[100:], starts, lens, ids, 1, 50)
    assert ok
    dec.end()
    assert got == [b"A" * 1000]


def test_write_indexed_on_the_plain_decoder_takes_write():
    enc = protocol.encode()
    enc.change_many([{"key": f"k{i}", "change": i, "from": 0, "to": 1,
                      "value": bytes([i]) * 40} for i in range(64)])
    enc.blob(3).end(b"abc")
    enc.finalize()
    wire = b"".join(iter(lambda: enc.read(1 << 20), None))
    n, starts, lens, ids, consumed, _ = native.split_frames(
        np.frombuffer(wire, np.uint8))
    outs = []
    for route in (True, False):
        dec = Decoder(native=route)
        got = []
        dec.change(lambda c, done, got=got: (got.append(c.key), done()))
        blobs = _blob_collector(dec)
        writes = []
        plain_write = dec.write
        dec.write = lambda data, *a: (writes.append(len(data)),
                                      plain_write(data, *a))[1]
        assert dec.write_indexed(wire, starts, lens, ids, n, consumed)
        dec.end()
        assert dec.finished and dec.bytes == len(wire)
        outs.append((got, blobs))
        # the native decoder installs the index; the plain one writes
        assert writes == ([] if route else [len(wire)])
    assert outs[0] == outs[1]
    assert outs[0][0] == [f"k{i}" for i in range(64)]


# -- gather send ---------------------------------------------------------------


def test_send_spans_blocking_gather_exact_bytes():
    payloads = [os.urandom(137) for _ in range(300)]
    g, n = _gather_for(payloads)
    a, b = socket.socketpair()
    try:
        got = {}
        t = threading.Thread(
            target=lambda: got.__setitem__("d", _recv_all(b)), daemon=True)
        t.start()
        w = native.pump_send_spans(a.fileno(), g.addrs, g.lens, n, g.stats)
        a.shutdown(socket.SHUT_WR)
        t.join(10)
        assert w == sum(len(p) for p in payloads)
        assert got["d"] == b"".join(payloads)
        # the 300 spans cost far fewer kernel entries
        assert int(g.stats[0]) < 300
    finally:
        g.release()
        a.close()
        b.close()


def test_send_spans_nb_eagain_mid_batch_returns_accepted():
    """A non-blocking fd that stops accepting mid-batch returns the
    accepted count (no raise, no spin): the fan-out's window contract."""
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
        a.setblocking(False)
        payloads = [b"q" * 4096 for _ in range(200)]  # >> the buffer
        g, n = _gather_for(payloads)
        accepted = pump.send_spans_nb(a.fileno(), g, n)
        g.release()
        assert 0 < accepted < sum(len(p) for p in payloads)
        # a partial acceptance resumes at the accepted offset: the
        # receiver sees one contiguous stream
        whole = b"".join(payloads)
        got = []
        sent = accepted
        b.setblocking(False)
        deadline = time.monotonic() + 30
        while (sent < len(whole) or len(b"".join(got)) < len(whole)) \
                and time.monotonic() < deadline:
            try:
                got.append(b.recv(1 << 16))
            except BlockingIOError:
                pass
            if sent < len(whole):
                g2, n2 = _gather_for([whole[sent:]])
                sent += pump.send_spans_nb(a.fileno(), g2, n2)
                g2.release()
        assert b"".join(got) == whole
    finally:
        a.close()
        b.close()


def test_send_to_dead_fd_raises_oserror():
    a, b = socket.socketpair()
    a_fd = os.dup(a.fileno())
    a.close()
    b.close()
    os.close(a_fd)  # gone: the pump surfaces EBADF, never hangs
    g, n = _gather_for([b"x" * 100])
    with pytest.raises(OSError) as e:
        pump.send_spans_nb(a_fd, g, n)
    assert e.value.errno == errno.EBADF
    g.release()


def test_send_pump_partial_writes_resume():
    """A blocking gather against a slow reader: partial accepts resume
    mid-span in C, every byte arrives in order."""
    enc = protocol.encode()
    payload = os.urandom(2 << 20)
    blob = enc.blob(2 << 20)
    blob.write(payload)
    blob.end()
    enc.finalize()
    a, b = socket.socketpair()
    try:
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 32768)
        got = {}

        def slow_reader():
            parts = []
            while True:
                d = b.recv(8192)
                if not d:
                    break
                parts.append(d)
                time.sleep(0.0002)
            got["d"] = b"".join(parts)

        t = threading.Thread(target=slow_reader, daemon=True)
        t.start()
        pump.send_pump(enc, a.fileno(),
                       close=lambda: a.shutdown(socket.SHUT_WR))
        t.join(30)
        assert len(got["d"]) == frame_wire_len(2 << 20)
        assert got["d"].endswith(payload)
    finally:
        a.close()
        b.close()


# -- the reader/writer pair ------------------------------------------------------


def test_pump_io_roundtrip():
    a, b = socket.socketpair()
    try:
        wr = pump.pump_writer(a.fileno())
        rd = pump.pump_reader(b.fileno())
        payload = os.urandom(300_000)
        t = threading.Thread(
            target=lambda: (wr(payload), a.shutdown(socket.SHUT_WR)),
            daemon=True)
        t.start()
        parts = []
        while True:
            d = rd(65536)
            if not d:
                break
            parts.append(d)
        t.join(10)
        assert b"".join(parts) == payload
    finally:
        a.close()
        b.close()


def test_io_for_socket_honours_a_socket_timeout():
    """A socket in timeout mode (its fd non-blocking): the batched pair
    moves every byte, and a receive with nothing to read raises
    ``TimeoutError`` after the timeout, as ``conn.recv`` does."""
    a, b = socket.socketpair()
    try:
        a.settimeout(5.0)
        b.settimeout(5.0)
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 16384)
        rd, _ = pump.io_for_socket(b)
        _, wr = pump.io_for_socket(a)
        payload = os.urandom(1 << 20)  # many times the send buffer
        t = threading.Thread(target=wr, args=(payload,), daemon=True)
        t.start()
        got = bytearray()
        while len(got) < len(payload):
            got += rd(65536)
        t.join(10)
        assert bytes(got) == payload
        b.settimeout(0.2)
        rd, _ = pump.io_for_socket(b)
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            rd(65536)
        assert 0.15 < time.monotonic() - t0 < 3.0
        assert pump.io_for_socket(a, native=False) == (a.recv, a.sendall)
    finally:
        a.close()
        b.close()


def test_a_receive_under_so_rcvtimeo_raises_as_recv_does():
    a, b = socket.socketpair()
    try:
        tv = struct.pack("ll", 0, 200_000)
        b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
        rd, _ = pump.io_for_socket(b)
        for read in (rd, b.recv):
            t0 = time.monotonic()
            with pytest.raises(BlockingIOError):
                read(4096)
            assert time.monotonic() - t0 < 3.0
    finally:
        a.close()
        b.close()


# -- the JAX package's unbounded blocking send, not copied ----------------------


@pytest.mark.skipif(not jax_native.available(),
                    reason="the JAX package's native library is missing")
def test_a_blocking_send_under_so_sndtimeo_raises_eagain(monkeypatch):
    """A peer that never reads, SO_SNDTIMEO of 0.2 s, 64 MiB to send: the
    port's writer raises ``OSError(EAGAIN)`` within 3 s, as ``sendall``
    does; the JAX package's writer retries EAGAIN forever and is still
    blocked after 2 s, until the peer's close fails its send."""
    monkeypatch.delenv("DAT_PUMP", raising=False)  # its native route
    payload = bytes(64 << 20)
    tv = struct.pack("ll", 0, 200_000)

    def wedged():
        a, b = socket.socketpair()
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
        return a, b

    a, b = wedged()
    try:
        _, wr = pump.io_for_socket(a)
        t0 = time.monotonic()
        with pytest.raises(OSError) as e:
            wr(payload)
        assert e.value.errno == errno.EAGAIN
        assert time.monotonic() - t0 < 3.0
        t0 = time.monotonic()
        with pytest.raises(OSError) as e:
            a.sendall(payload)
        assert e.value.errno == errno.EAGAIN
    finally:
        a.close()
        b.close()

    a, b = wedged()
    out = {}

    def jax_writer():
        try:
            jax_pump.io_for_socket(a)[1](payload)
            out["result"] = "returned"
        except OSError as err:
            out["result"] = err.errno

    t = threading.Thread(target=jax_writer, daemon=True)
    try:
        t.start()
        t.join(2.0)
        assert t.is_alive(), "the JAX package's writer gave up"
    finally:
        b.close()  # the peer goes: that error ends the JAX writer's retries
        t.join(10)
        a.close()
    assert not t.is_alive()
    # the peer closed with bytes unread: EPIPE, or ECONNRESET for the RST
    assert out["result"] in (errno.EPIPE, errno.ECONNRESET)


# -- a parked cursor and the reused index arrays -------------------------------


def test_a_held_done_keeps_the_pump_off_the_index_arrays(monkeypatch):
    """The decoder's parked bulk cursor reads views of the pump's index
    arrays (the C change loop's ``starts_np``/``lens_np``/``ids_np``),
    which the next receive refills.  A handler holds its ``done`` while
    a second batch waits in the socket: no receive may scan until the
    cursor retired, and every change arrives once, in order."""
    enc = protocol.encode()
    rows = [{"key": f"row-{i:04d}", "change": i, "from": 0, "to": 1,
             "value": bytes([i % 251]) * 50} for i in range(400)]
    enc.change_many(rows[:200])
    first = b"".join(iter(lambda: enc.read(1 << 20), b""))
    enc.change_many(rows[200:])
    enc.finalize()
    second = b"".join(iter(lambda: enc.read(1 << 20), None))
    scans = []
    parked_views = []
    real_scan = native.pump_recv_scan

    def scan(fd, buf, slice_bytes, starts, lens, ids, stats):
        scans.append(dec._bulk is not None)
        return real_scan(fd, buf, slice_bytes, starts, lens, ids, stats)

    monkeypatch.setattr(native, "pump_recv_scan", scan)
    dec = Decoder()
    got = []
    held = []

    def on_change(c, done):
        got.append(c.key)
        if len(got) == 10 and not held:
            st = dec._bulk
            parked_views.append(st is not None and st["cols_np"] is not None)
            held.append(done)  # released from the test thread below
        else:
            done()

    dec.change(on_change)
    a, b = socket.socketpair()
    try:
        a.sendall(first)
        t = threading.Thread(target=pump.recv_pump, args=(dec, b.fileno()),
                             daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while not held and time.monotonic() < deadline:
            time.sleep(0.01)
        assert held, "the handler never parked the cursor"
        a.sendall(second)  # the second batch waits in the socket
        a.shutdown(socket.SHUT_WR)
        time.sleep(0.3)
        assert dec._bulk is not None and len(got) == 10
        held[0]()
        t.join(10)
        assert not t.is_alive()
    finally:
        a.close()
        b.close()
    assert parked_views == [True]  # the C loop's columns, on the views
    assert dec.finished and not dec.destroyed
    assert got == [r["key"] for r in rows]
    assert scans and not any(scans)


# -- the fan-out's gather ------------------------------------------------------


def test_fanout_native_gather_counter_proof(port_obs):
    """Every delivered broadcast byte rides the gather:
    ``transport.pump.gather.bytes == fanout.sent.bytes``; payload bytes
    go to the kernel as (address, length) spans over log segments."""
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    srv = FanoutServer(max_peers=8, window_bytes=1 << 22)
    socks, peers, readers = [], [], []
    try:
        assert srv._gather is not None
        got = {}
        for i in range(4):
            a, b = socket.socketpair()
            socks.append((a, b))
            peers.append(srv.attach_peer(f"p{i}", fd=a.fileno(), offset=0))
            t = threading.Thread(
                target=lambda i=i, b=b: got.__setitem__(i, _recv_all(b)),
                daemon=True)
            t.start()
            readers.append(t)
        payload = os.urandom(1 << 20)
        srv.publish(payload)
        srv.seal()
        assert srv.drain(timeout=30)
        for i, (a, b) in enumerate(socks):
            peers[i].close()
            a.close()
        srv.close()  # its owned fd dups close with it: EOF at the readers
        for t in readers:
            t.join(10)
        assert all(got.get(i) == payload for i in range(4))
        c = metrics.snapshot()["counters"]
        assert c["fanout.sent.bytes"] == 4 * len(payload)
        assert c["transport.pump.gather.bytes"] == 4 * len(payload)
    finally:
        srv.close()
        for a, b in socks:
            a.close()
            b.close()


def test_fanout_python_route_unchanged():
    """``native=False`` keeps the ``os.writev`` path: same bytes."""
    from dat_replication_protocol_tpu_torch.fanout import FanoutServer

    srv = FanoutServer(max_peers=4, native=False)
    a, b = socket.socketpair()
    try:
        assert srv._gather is None and srv._serve_iov_factor == 1
        peer = srv.attach_peer("p0", fd=a.fileno(), offset=0)
        payload = os.urandom(100_000)  # fits the kernel buffer whole
        srv.publish(payload)
        srv.seal()
        assert srv.drain(timeout=30)
        peer.close()
        a.close()
        srv.close()
        assert _recv_all(b) == payload
    finally:
        srv.close()
        a.close()
        b.close()


# -- the route in the records ----------------------------------------------------


def test_stats_snapshot_carries_pump_route(monkeypatch):
    from dat_replication_protocol_tpu_torch import sidecar

    monkeypatch.setenv("DAT_PUMP", "python")  # not the port's switch
    snap = sidecar.snapshot_stats()
    assert snap["pump"] == pump.probe_caps()
    assert snap["pump"]["route"] == "native"
    assert snap["pump"]["native_available"] is True


def test_hub_snapshot_carries_pump_route():
    from dat_replication_protocol_tpu_torch.hub import ReplicationHub

    hub = ReplicationHub(device="cpu", max_sessions=2)
    try:
        assert hub.snapshot()["pump_route"] == "native"
    finally:
        hub.close()


# -- the sidecar's fds -----------------------------------------------------------


def _digest_wire(n_changes: int = 24, blob: int = 3000) -> tuple:
    enc = protocol.encode()
    want = []
    for i in range(n_changes):
        c = {"key": f"k{i}", "change": i, "from": 0, "to": 1,
             "value": bytes([i]) * (i + 5)}
        enc.change(c)
        want.append(("change", i, hashlib.blake2b(
            protocol.encode_change(c), digest_size=32).digest()))
    data = bytes(range(256)) * (blob // 256) + b"\x01" * (blob % 256)
    enc.blob(blob).end(data)
    want.append(("blob", 0, hashlib.blake2b(data, digest_size=32).digest()))
    enc.finalize()
    return b"".join(iter(lambda: enc.read(1 << 20), None)), want


def _replies(raw: bytes) -> list:
    dec = protocol.decode()
    out = []
    dec.change(lambda c, done: (out.append(
        (c.subset.split(":")[1], c.change, bytes(c.value))), done()))
    dec.write(raw)
    dec.end()
    assert dec.finished
    return sorted(out)


def test_run_session_over_fds_equals_its_callables():
    """``run_session`` with ``rx_fd``/``tx_fd`` (the batched route) and
    with the socket's callables (the plain one): the same reply digests,
    equal to ``hashlib``, and the same bytes through the ``publish``
    tap."""
    from dat_replication_protocol_tpu_torch import sidecar

    wire, want = _digest_wire()
    outs = []
    for fds in (True, False):
        a, b = socket.socketpair()
        tapped = bytearray()
        try:
            t = threading.Thread(
                target=lambda: (a.sendall(wire), a.shutdown(socket.SHUT_WR)),
                daemon=True)
            t.start()
            kw = ({"rx_fd": b.fileno(), "tx_fd": b.fileno()} if fds
                  else {})
            rec = sidecar.run_session(
                b.recv, b.sendall,
                close_write=lambda: b.shutdown(socket.SHUT_WR),
                device="cpu", publish=tapped.extend, **kw)
            raw = _recv_all(a)
            t.join(10)
        finally:
            a.close()
            b.close()
        assert rec["ok"] and rec["bytes"] == len(wire)
        outs.append((_replies(raw), bytes(tapped)))
    assert outs[0] == outs[1]
    assert outs[0][0] == sorted(want) and outs[0][1] == wire


def test_serve_stdio_over_pipes():
    """The ``--stdio`` sidecar on real pipes (``rx_fd=0, tx_fd=1``: the
    pump's pipe path, no mmsg syscalls): its replies carry ``hashlib``'s
    digests and its session line says ok."""
    wire, want = _digest_wire(8, 1000)
    proc = subprocess.run(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
         "--stdio", "--device", "cpu"],
        input=wire, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert _replies(proc.stdout) == sorted(want)
    assert "'ok': True" in proc.stderr.decode()


def test_serve_stdio_snapshot_over_pipes(tmp_path):
    """``--stdio --snapshot`` on real pipes: the responder's byte pair is
    the pump's reader and writer on fds 0 and 1; a cold joiner over the
    subprocess's pipes assembles the dataset byte for byte."""
    from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
        run_snapshot_joiner)

    data = np.random.default_rng(19).bytes(24 << 10)
    path = tmp_path / "data.bin"
    path.write_bytes(data)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
         "--stdio", "--snapshot", str(path), "--device", "cpu"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, cwd=REPO)
    try:
        rd = pump.pump_reader(proc.stdout.fileno())
        wr = pump.pump_writer(proc.stdin.fileno())
        res = run_snapshot_joiner(rd, wr, close_write=proc.stdin.close,
                                  device="cpu")
        proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert res["ok"] and res["data"] == data
    assert proc.returncode == 0, err.decode()[-2000:]
    assert "'ok': True" in err.decode()
