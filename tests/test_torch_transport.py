"""The port's blocking transport against the JAX package's session.

``send_over``/``recv_over`` and ``session_over_socketpair`` must move a
session (changes, blobs, reconcile and snapshot frames) through a real
kernel socket into a decoder of either package with the same
deliveries, honor a stalled ``done`` (backpressure across the socket),
and end promptly when either side is destroyed mid-stream.  Every wait
is bounded.
"""

import os
import socket
import threading
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu.session.encoder import Encoder as JaxEncoder
from dat_replication_protocol_tpu_torch.session import transport
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.session.encoder import Encoder
from dat_replication_protocol_tpu_torch.wire import reconcile_codec as rc
from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
from dat_replication_protocol_tpu_torch.wire.framing import (
    CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT)

ALL = CAP_CHANGE_BATCH | CAP_RECONCILE | CAP_SNAPSHOT
WAIT = 20.0


def _fill(enc, n_changes=200, blob_bytes=300_000, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_changes):
        enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                    "value": rng.bytes(int(rng.integers(0, 200)))})
        if i == 50:
            enc.reconcile_frame(rc.encode_more(i))
            enc.snapshot_frame(sn.encode_chunks([(bytes(32), rng.bytes(5000))]))
        if i == 100:
            enc.blob(blob_bytes).end(rng.bytes(blob_bytes))
    enc.finalize()


def _collect(dec):
    got = []
    dec.change(lambda c, done: (got.append(("ch", c.key, c.value)), done()))
    dec.blob(lambda b, done: b.collect(
        lambda d: (got.append(("blob", len(d), hash(d))), done())))
    dec.reconcile(lambda m, done: (got.append(("rc", m.n)), done()))
    dec.snapshot(lambda m, done: (got.append(
        ("sn", [(bytes(d), bytes(c)) for d, c in m.chunks])), done()))
    return got


def _pump(enc, dec, chunk=4096):
    a, b = socket.socketpair()
    a.settimeout(WAIT)
    b.settimeout(WAIT)
    tx = threading.Thread(target=transport.send_over_socket,
                          args=(enc, a, chunk), daemon=True)
    tx.start()
    transport.recv_over_socket(dec, b, chunk)
    tx.join(WAIT)
    assert not tx.is_alive()
    a.close()
    b.close()


@pytest.mark.parametrize("encoder", ["port", "jax"])
@pytest.mark.parametrize("decoder", ["port", "jax"])
def test_send_over_and_recv_over_deliver_as_the_jax_session(encoder, decoder):
    results = []
    for enc_cls, dec_cls in ((Encoder if encoder == "port" else JaxEncoder,
                              Decoder if decoder == "port" else JaxDecoder),
                             (JaxEncoder, JaxDecoder)):
        enc, dec = enc_cls(peer_caps=ALL), dec_cls()
        got = _collect(dec)
        _fill(enc)
        _pump(enc, dec)
        assert dec.finished and not dec.destroyed
        results.append(got)
    assert results[0] == results[1]
    assert len(results[0]) == 200 + 1 + 2


def test_session_over_socketpair_with_a_small_window_and_a_held_done():
    enc, dec = Encoder(peer_caps=ALL), Decoder()
    got = []
    held = []

    def on_change(c, done):
        got.append(c.key)
        if c.key == "k10":
            held.append(done)  # stall the pipe across the kernel socket
        else:
            done()

    dec.change(on_change)
    sess = transport.session_over_socketpair(enc, dec, chunk_size=1024,
                                             sndbuf=4096)
    _fill(enc, n_changes=400, blob_bytes=200_000)
    deadline = time.monotonic() + WAIT
    while not held and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    assert held and got[-1] == "k10"  # nothing past the held change
    held[0]()
    sess.wait(WAIT)
    assert dec.finished and len(got) == 400


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_a_destroy_mid_stream_ends_both_pumps(side):
    enc, dec = Encoder(peer_caps=ALL), Decoder()
    seen = []

    def on_change(c, done):
        seen.append(c.key)
        if len(seen) == 20 and side == "decoder":
            dec.destroy(RuntimeError("receiver gave up"))
        done()

    dec.change(on_change)
    errs = []
    dec.on_error(errs.append)
    sess = transport.session_over_socketpair(enc, dec, chunk_size=512,
                                             sndbuf=4096)
    for i in range(2000):
        if enc.destroyed:
            break
        enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                    "value": b"v" * 100})
        if side == "encoder" and i == 300:
            enc.destroy(RuntimeError("sender gave up"))
            break
        if dec.destroyed:
            enc.destroy()
            break
        time.sleep(0.0005 if i % 50 == 0 else 0)
    if not enc.destroyed:
        enc.finalize()
    t0 = time.monotonic()
    sess.wait(WAIT)
    assert time.monotonic() - t0 < WAIT
    if side == "decoder":
        assert dec.destroyed and len(seen) == 20
    else:
        # the receiver saw EOF mid-session: a clean prefix, never a hang
        assert (dec.finished or dec.destroyed) and len(seen) <= 301


def test_recv_over_ends_a_stream_torn_mid_frame_with_one_error():
    enc = Encoder(peer_caps=ALL)
    _fill(enc, n_changes=10, blob_bytes=10_000)
    wire = bytearray()
    while (c := enc.read()) is not None:
        wire += c
    torn = bytes(wire[: len(wire) - 3])
    chunks = [torn[i:i + 100] for i in range(0, len(torn), 100)] + [b""]
    dec = Decoder()
    _collect(dec)
    errs = []
    dec.on_error(errs.append)
    transport.recv_over(dec, lambda n: chunks.pop(0))
    assert dec.destroyed and len(errs) == 1
    assert "ended mid-frame" in str(errs[0])


def test_once_write_all_and_send_over_fd():
    calls = []
    close = transport.once(lambda: calls.append(1))
    close()
    close()
    assert calls == [1]
    r, w = os.pipe()
    try:
        transport.write_all(w, b"abc")
        assert os.read(r, 10) == b"abc"
    finally:
        os.close(r)
        os.close(w)
    r, w = os.pipe()
    enc = Encoder()
    enc.change({"key": "k", "change": 1, "from": 0, "to": 1})
    enc.finalize()
    closer = transport.send_over_fd(enc, w)
    closer()  # a second close is a no-op, never a double close
    dec = Decoder()
    got = _collect(dec)
    transport.recv_over_fd(dec, r)
    os.close(r)
    assert dec.finished and got == [("ch", "k", b"")]


def test_start_sender_swallows_a_dead_peer():
    enc = Encoder()
    for i in range(200):
        enc.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                    "value": b"v" * 1000})
    enc.finalize()

    def dead(_data):
        raise BrokenPipeError("peer went away")

    t = transport.start_sender(enc, dead, name="test-send")
    t.join(WAIT)
    assert not t.is_alive()
