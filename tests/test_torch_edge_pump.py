"""The edge's non-blocking pump steps against the JAX package's Python arm.

``recv_step`` and ``send_step`` of the port and of the JAX package
(``DAT_PUMP=python``) run side by side, each on its own socketpair fed
the same bytes in the same order: their ``(nbytes, eof)`` and
``(accepted, finished, blocked)`` sequences, the bytes they move and
what the decoders make of them are equal, for a session fed one byte at
a time, one with a 64 KiB blob, one with a 3 MiB blob, and a frame cut
by EOF.  The port's receive turn never reads past ``cap`` (the JAX
package's reads a whole slice, so it can); a slow reader behind a tiny
send buffer gets the reply whole and in order with no send turn
blocking.  The port's side runs its plain arm (``EdgePump(native=False)``),
the arm these sequences pin; ``tests/test_torch_pump.py`` holds the
batched arm.
"""

import hashlib
import select
import socket
import threading
import time

import pytest

import dat_replication_protocol_tpu as jax_protocol
from dat_replication_protocol_tpu.session import pump as jax_pump
from dat_replication_protocol_tpu_torch import decode, encode
from dat_replication_protocol_tpu_torch.session import pump

from test_wire_fixtures import SESSION_4


@pytest.fixture(autouse=True)
def _python_arm(monkeypatch):
    # the JAX package's Python arm, the route the port carries
    monkeypatch.setenv("DAT_PUMP", "python")


def _wire(enc_factory, blob: int, changes: int = 3) -> bytes:
    e = enc_factory()
    for i in range(changes):
        e.change({"key": f"k{i}", "change": i, "from": i, "to": i + 1,
                  "value": bytes([i]) * (i + 1)})
    if blob:
        e.blob(blob).end(bytes(range(256)) * (blob // 256)
                         + b"\x07" * (blob % 256))
    e.finalize()
    out = bytearray()
    while (c := e.read(1 << 20)) is not None:
        out += c
    return bytes(out)


WIRES = {
    "one_byte_writes": (SESSION_4, 1),
    "blob_64k": (_wire(encode, 64 << 10), 64 << 10),
    "blob_3m": (_wire(encode, 3 << 20), 64 << 10),
}


def _collecting(dec) -> list:
    got = []
    dec.change(lambda c, done: (got.append(("change", c.key, bytes(
        c.value or b""))), done()))
    dec.blob(lambda b, done: b.collect(lambda d: (got.append(
        ("blob", hashlib.blake2b(bytes(d)).hexdigest())), done())))
    return got


def _plain_arm(mod) -> dict:
    """The port's EdgePump keyword for its plain arm (the JAX package's
    takes its arm from DAT_PUMP)."""
    return {"native": False} if mod is pump else {}


class _Side:
    """One implementation's receive end: a socketpair, its pump and a
    collecting host decoder."""

    def __init__(self, mod, dec, cap=None):
        self.cli, self.srv = socket.socketpair()
        self.srv.setblocking(False)
        kw = _plain_arm(mod)
        self.pump = (mod.EdgePump(self.srv.fileno(), **kw) if cap is None
                     else mod.EdgePump(self.srv.fileno(), cap=cap, **kw))
        self.mod = mod
        self.dec = dec
        self.got = _collecting(dec)
        self.steps = []

    def turns(self) -> None:
        """Receive turns until one returns would-block or EOF."""
        while True:
            res = self.mod.recv_step(self.pump, self.dec)
            self.steps.append(res)
            if res[1]:
                if not self.dec.destroyed and not self.dec.finished:
                    self.dec.end()
                return
            if res[0] == 0:
                return

    def close(self) -> None:
        self.cli.close()
        self.srv.close()


@pytest.mark.parametrize("name", sorted(WIRES))
def test_recv_step_sequences_equal_the_jax_python_arm(name):
    wire, piece = WIRES[name]
    sides = [_Side(pump, decode()), _Side(jax_pump, jax_protocol.decode())]
    assert sides[1].pump.native is False
    try:
        for i in range(0, len(wire), piece):
            for s in sides:
                s.cli.sendall(wire[i:i + piece])
                s.turns()
        for s in sides:
            s.cli.shutdown(socket.SHUT_WR)
            s.turns()
        port, jax = sides
        assert port.steps == jax.steps
        assert port.steps[-1] == (0, True)
        assert sum(n for n, _ in port.steps) == len(wire)
        assert port.got == jax.got and port.got
        assert port.dec.finished and jax.dec.finished
    finally:
        for s in sides:
            s.close()


def test_recv_step_eof_mid_frame_equals_the_jax_python_arm():
    cut = SESSION_4[:len(SESSION_4) // 2]
    sides = [_Side(pump, decode()), _Side(jax_pump, jax_protocol.decode())]
    for s in sides:
        s.dec.on_error(lambda e: None)
    try:
        for s in sides:
            s.cli.sendall(cut)
            s.cli.shutdown(socket.SHUT_WR)
            s.turns()
        port, jax = sides
        assert port.steps == jax.steps == [(len(cut), True)]
        assert port.dec.destroyed and jax.dec.destroyed
        assert not port.dec.finished and not jax.dec.finished
        assert port.got == jax.got
    finally:
        for s in sides:
            s.close()


def test_recv_step_would_block_returns_at_once_and_reads_at_most_cap():
    side = _Side(pump, decode(), cap=4096)
    try:
        t0 = time.monotonic()
        assert pump.recv_step(side.pump, side.dec) == (0, False)
        assert time.monotonic() - t0 < 0.05  # EAGAIN, never a sleep
        wire = WIRES["blob_64k"][0][:48 << 10]
        side.cli.sendall(wire)
        side.turns()
        assert side.steps[-1] == (0, False)
        assert all(n <= 4096 for n, _ in side.steps)
        assert sum(n for n, _ in side.steps) == len(wire)
        # the JAX package's Python arm reads whole slices past its cap
        jax = _Side(jax_pump, jax_protocol.decode(), cap=4096)
        try:
            jax.cli.sendall(wire)
            jax.turns()
            assert jax.steps[0] == (len(wire), False)
        finally:
            jax.close()
    finally:
        side.close()


def _enc_with(enc_factory, name: str):
    e = enc_factory()
    if name == "one_byte_writes":
        e.change({"key": "k", "change": 0, "from": 0, "to": 1,
                  "value": b"v"})
    else:
        n = 64 << 10 if name == "blob_64k" else 3 << 20
        e.change({"key": "k", "change": 0, "from": 0, "to": 1,
                  "value": b"v"})
        e.blob(n).end(bytes(range(256)) * (n // 256))
    e.finalize()
    return e


def _drain(sock) -> bytes:
    out = bytearray()
    while True:
        try:
            d = sock.recv(1 << 20)
        except BlockingIOError:
            return bytes(out)
        if not d:
            return bytes(out)
        out += d


@pytest.mark.parametrize("name", sorted(WIRES))
def test_send_step_sequences_equal_the_jax_python_arm(name):
    results = []
    for mod, enc_factory in ((pump, encode), (jax_pump,
                                              jax_protocol.encode)):
        a, b = socket.socketpair()
        a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 64 << 10)
        a.setblocking(False)
        b.setblocking(False)
        p = mod.EdgePump(a.fileno(), **_plain_arm(mod))
        enc = _enc_with(enc_factory, name)
        steps, got = [], bytearray()
        try:
            while True:
                res = mod.send_step(p, enc)
                steps.append(res)
                if res[1]:
                    break
                got += _drain(b)  # the peer reads all it was sent
            got += _drain(b)
        finally:
            a.close()
            b.close()
        results.append((steps, bytes(got)))
    (port_steps, port_bytes), (jax_steps, jax_bytes) = results
    assert port_steps == jax_steps
    assert port_bytes == jax_bytes
    assert port_steps[-1][1] is True
    if name == "blob_3m":
        assert any(blocked for _, _, blocked in port_steps)


def test_send_step_slow_reader_tiny_buffer_whole_and_in_order():
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    b.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    a.setblocking(False)
    enc = _enc_with(encode, "blob_64k")
    want = bytearray()
    probe = _enc_with(encode, "blob_64k")
    while (c := probe.read(1 << 20)) is not None:
        want += c
    got = bytearray()

    def slow_reader():
        while True:
            d = b.recv(4096)
            if not d:
                return
            got.extend(d)
            time.sleep(0.001)

    reader = threading.Thread(target=slow_reader, daemon=True)
    reader.start()
    p = pump.EdgePump(a.fileno())
    worst = 0.0
    blocked_turns = 0
    deadline = time.monotonic() + 30
    try:
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            accepted, finished, blocked = pump.send_step(p, enc)
            worst = max(worst, time.monotonic() - t0)
            if finished:
                break
            if blocked:
                blocked_turns += 1
                assert p.pending is not None and len(p.pending) > 0
                select.select([], [a], [], 1.0)
        else:
            pytest.fail("the reply never finished")
        a.shutdown(socket.SHUT_WR)
        reader.join(30)
        assert not reader.is_alive()
    finally:
        a.close()
        b.close()
    assert bytes(got) == bytes(want)
    assert blocked_turns > 0  # the tiny buffer did push back
    assert worst < 0.05, f"a send turn took {worst:.3f} s"
