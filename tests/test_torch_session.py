"""The port's session layer against the JAX package's.

The four reference sessions pinned in ``tests/test_wire_fixtures.py``
are driven through both encoders and both decoders: the wire must be
byte-identical and the deliveries identical, in the same order.  Then
the backpressure and failure probes: a held ``done`` stalls the decoder
and the pipe and releasing it resumes them; blob length errors destroy
the encoder; garbage destroys the decoder with a ProtocolError.
"""

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.session.encoder import (
    BlobLengthError,
)
from tests.test_wire_fixtures import (
    JS_CHANGE,
    SESSION_1,
    SESSION_2,
    SESSION_3_CLEAN,
    SESSION_4,
)

CHANGE = {"key": "key", "from": 0, "to": 1, "change": 1, "value": b"hello"}


def _drain(e) -> bytes:
    out = bytearray()
    while (c := e.read()) not in (None, b""):
        out += c
    return bytes(out)


def _session_1(p):
    e = p.encode()
    e.change(CHANGE)
    return e


def _session_2(p):
    e = p.encode()
    b = e.blob(11)
    b.write(b"hello ")
    b.write(b"world")
    b.end()
    return e


def _session_3(p):
    e = p.encode()
    b1, b2 = e.blob(11), e.blob(11)
    b1.write(b"hello ")
    b2.write(b"HELLO ")
    b1.write(b"world")
    b2.write(b"WORLD")
    b1.end()
    b2.end()
    return e


def _session_4(p):
    e = p.encode()
    b = e.blob(11)
    e.change(CHANGE)  # parked behind the open blob
    b.write(b"hello ")
    b.end(b"world")
    return e


SESSIONS = [(_session_1, SESSION_1), (_session_2, SESSION_2),
            (_session_3, SESSION_3_CLEAN), (_session_4, SESSION_4)]


@pytest.mark.parametrize("build,wire", SESSIONS)
def test_encoder_wire_matches_jax_and_fixture(build, wire):
    ours = _drain(build(protocol))
    assert ours == _drain(build(jax_protocol))
    assert ours == wire


def _deliveries(p, wire, chunking):
    d = p.decode()
    events = []
    d.change(lambda c, done: (events.append(("change", c.to_dict())), done()))
    d.blob(lambda blob, done: blob.collect(
        lambda x: (events.append(("blob", x)), done())))
    d.finalize(lambda done: (events.append(("finalize",)), done()))
    for off in range(0, len(wire), chunking):
        d.write(wire[off:off + chunking])
    d.end()
    assert d.finished and not d.destroyed
    return events, (d.bytes, d.changes, d.blobs)


@pytest.mark.parametrize("chunking", [1, 3, 1 << 16])
@pytest.mark.parametrize("wire", [SESSION_1, SESSION_2, SESSION_3_CLEAN,
                                  SESSION_4])
def test_decoder_deliveries_match_jax(wire, chunking):
    ours = _deliveries(protocol, wire, chunking)
    assert ours == _deliveries(jax_protocol, wire, chunking)
    if wire is SESSION_1:
        assert ours[0][0] == ("change", JS_CHANGE)


def _random_session(p, seed):
    """Changes and blobs in a seeded order, piped into a collecting
    decoder; returns (wire bytes, deliveries)."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(40):
        if rng.random() < 0.3:
            ops.append(("blob", rng.bytes(int(rng.integers(1, 5000)))))
        else:
            ops.append(("change", {
                "key": f"k{i}", "change": i, "from": i, "to": i + 1,
                "value": rng.bytes(int(rng.integers(0, 300))),
                "subset": "s" if i % 3 == 0 else None}))
    e = p.encode()
    wire = bytearray()
    for kind, item in ops:
        if kind == "change":
            e.change(item)
        else:
            e.blob(len(item)).end(item)
    e.finalize()
    while (chunk := e.read(777)) is not None:
        wire += chunk
    return bytes(wire)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sessions_match_jax(seed):
    wire = _random_session(protocol, seed)
    assert wire == _random_session(jax_protocol, seed)
    assert (_deliveries(protocol, wire, 1000)
            == _deliveries(jax_protocol, wire, 1000))


@pytest.mark.parametrize("p", [protocol, jax_protocol],
                         ids=["torch", "jax"])
def test_held_done_stalls_decoder_and_release_resumes(p):
    wire = _drain(_session_1(p)) * 3
    d = p.decode()
    held, got = [], []
    d.change(lambda c, done: (got.append(c.key), held.append(done)))
    assert d.write(wire) is False  # stalled on the first change
    assert got == ["key"] and not d.writable()
    held.pop()()
    assert got == ["key", "key"]
    held.pop()()
    held.pop()()
    assert got == ["key"] * 3 and d.writable()
    d.end()
    assert d.finished


@pytest.mark.parametrize("p", [protocol, jax_protocol],
                         ids=["torch", "jax"])
def test_pipe_stalls_and_resumes_on_release(p):
    e, d = p.encode(), p.decode()
    held, got, order = [], [], []
    d.change(lambda c, done: (got.append(c.change), held.append(done)))
    d.blob(lambda b, done: b.collect(lambda x: (order.append(x), done())))
    d.finalize(lambda done: (order.append("finalize"), done()))
    p.pipe(e, d)
    e.change(dict(CHANGE, change=1))
    b = e.blob(11)
    e.change(dict(CHANGE, change=2))  # parked behind the blob
    b.write(b"hello ")
    b.end(b"world")  # late writes must flow once the stall clears
    e.finalize()
    assert got == [1] and order == [] and not d.finished
    held.pop()()
    assert order == [b"hello world"] and got == [1, 2]
    held.pop()()
    assert order == [b"hello world", "finalize"] and d.finished
    assert (e.bytes, e.changes, e.blobs) == (d.bytes, d.changes, d.blobs)


def test_blob_overflow_and_short_end_destroy_encoder():
    e = protocol.encode()
    b = e.blob(4)
    with pytest.raises(BlobLengthError):
        b.write(b"12345")
    assert e.destroyed
    e = protocol.encode()
    b = e.blob(4)
    b.write(b"12")
    with pytest.raises(BlobLengthError):
        b.end()
    assert e.destroyed


@pytest.mark.parametrize("garbage", [b"\xff" * 64, bytes([0x02, 0x07]),
                                     bytes([0x00, 0x01])])
def test_garbage_destroys_decoder_with_protocol_error(garbage):
    errs = []
    for p in (protocol, jax_protocol):
        d = p.decode()
        seen = []
        d.on_error(seen.append)
        d.write(garbage)
        d_end = d.destroyed or d.end() or d.destroyed
        assert d_end and not d.finished
        assert isinstance(seen[0], p.ProtocolError)
        errs.append(str(seen[0]))
    assert errs[0] == errs[1]


def test_truncated_frame_at_end_is_a_protocol_error():
    d = protocol.decode()
    seen = []
    d.on_error(seen.append)
    d.write(SESSION_1[:-3])
    d.end()
    assert d.destroyed and isinstance(seen[0], protocol.ProtocolError)


def test_finalize_runs_after_all_frames_then_finish():
    d = protocol.decode()
    order = []
    d.change(lambda c, done: (order.append("change"), done()))
    d.finalize(lambda done: (order.append("finalize"), done()))
    d.on_finish(lambda: order.append("finish"))
    d.write(SESSION_4)
    d.end()
    assert order == ["change", "finalize", "finish"]
