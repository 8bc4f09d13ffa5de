"""The decoder's bulk-index route against its streaming route and the JAX
package's decoder.

``Decoder()`` indexes a queued buffer of at least ``_NATIVE_MIN`` bytes
in one native call and dispatches change runs from the C loop;
``Decoder(native=False)`` is the streaming scanner alone.  The two must
be observably identical: callbacks, ordering, errors (type, message,
frame, offset, cause), flow control, checkpoints and digests.  Every
case of the JAX package's ``tests/test_decoder_bulk.py`` runs on both
routes (the ``route`` fixture); the cases that compare events also hold
them against the JAX package's decoder on its default and its Python
route (``DAT_NATIVE_DISABLE=1`` / ``DAT_FASTPATH_DISABLE=1``, set on the
JAX package only).
"""

import hashlib
import random
import threading
import time

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    CudaDecoder,
    DigestPipeline,
)
from dat_replication_protocol_tpu_torch.obs import metrics, tracing, wirecost
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_BLOB,
    TYPE_CHANGE,
    ProtocolError,
    frame,
)
from dat_replication_protocol_tpu_torch.wire.varint import encode_uvarint

ROUTES = ["native", "python"]
JAX_ROUTES = ["jax-native", "jax-python"]


@pytest.fixture(params=ROUTES)
def route(request):
    return request.param


def _decode(route):
    return protocol.decode(native=route == "native")


def _jax_decode(jax_route, monkeypatch):
    if jax_route == "jax-python":
        monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
        monkeypatch.setenv("DAT_FASTPATH_DISABLE", "1")
    else:
        monkeypatch.delenv("DAT_NATIVE_DISABLE", raising=False)
        monkeypatch.delenv("DAT_FASTPATH_DISABLE", raising=False)
    return jax_protocol.decode()


def _row(ch):
    return (ch.key, ch.change, ch.from_, ch.to, bytes(ch.value), ch.subset)


def _wire(n=400, blob_every=7):
    parts = []
    for i in range(n):
        parts.append(frame(TYPE_CHANGE, encode_change({
            "key": f"key-{i}", "change": i, "from": i, "to": i + 1,
            "value": b"v" * (i % 90), "subset": "s" if i % 3 else None,
        })))
        if i % blob_every == 0:
            parts.append(frame(TYPE_BLOB, bytes([i & 255]) * (i % 300)))
    return b"".join(parts)


def _drive(dec, wire, chunk_size):
    events = []
    dec.change(lambda ch, done: (events.append(("c", _row(ch))), done()))

    def on_blob(blob, done):
        parts = []
        blob.on_data(parts.append)
        blob.on_end(lambda: (events.append(("b", b"".join(parts))), done()))

    dec.blob(on_blob)
    for off in range(0, len(wire), chunk_size):
        dec.write(wire[off:off + chunk_size])
    dec.end()
    assert dec.finished
    return events


def _jax_events(wire, chunk_size, monkeypatch):
    return {r: _drive(_jax_decode(r, monkeypatch), wire, chunk_size)
            for r in JAX_ROUTES}


def test_bulk_path_matches_streaming_scanner(route, monkeypatch):
    wire = _wire()
    bulk = _drive(_decode(route), wire, 1 << 16)
    slow = _drive(_decode(route), wire, 97)
    assert bulk == slow
    assert len(bulk) > 400
    for want in _jax_events(wire, 1 << 16, monkeypatch).values():
        assert bulk == want


def test_async_acks_resume_from_cursor(route):
    wire = _wire(n=300, blob_every=5)
    dec = _decode(route)
    events = []
    pending = []
    dec.change(lambda ch, done: (events.append(("c", ch.key)),
                                 pending.append(done)))
    dec.blob(lambda blob, done: blob.collect(
        lambda d: (events.append(("b", len(d))), done())))
    writes = [dec.write(wire)]
    dec.end()
    while pending:
        pending.pop(0)()
    assert dec.finished
    keys = [e[1] for e in events if e[0] == "c"]
    assert keys == [f"key-{i}" for i in range(300)]
    assert writes == [False]


def test_corrupt_record_mid_bulk_delivers_prefix_then_destroys(route):
    frames = [frame(TYPE_CHANGE, encode_change({
        "key": f"z{i}", "change": i, "from": 0, "to": 1})) for i in range(60)]
    blob = bytearray(b"".join(frames))
    off40 = sum(len(f) for f in frames[:40])
    blob[off40 + 2] = 0x07  # an invalid proto wire type
    dec = _decode(route)
    seen, errs = [], []
    dec.change(lambda ch, done: (seen.append(ch.key), done()))
    dec.on_error(errs.append)
    dec.write(bytes(blob))
    assert dec.destroyed and errs
    assert seen == [f"z{i}" for i in range(40)]


def test_invalid_utf8_key_destroys_with_protocol_error(route):
    frames = [frame(TYPE_CHANGE, encode_change({
        "key": f"u{i}", "change": i, "from": 0, "to": 1})) for i in range(40)]
    bad_payload = bytes([0x12, 0x02, 0xFF, 0xFE,
                         0x18, 0x01, 0x20, 0x00, 0x28, 0x01])
    frames.insert(20, frame(TYPE_CHANGE, bad_payload))
    dec = _decode(route)
    seen, errs = [], []
    dec.change(lambda ch, done: (seen.append(ch.key), done()))
    dec.on_error(errs.append)
    dec.write(b"".join(frames))
    assert dec.destroyed
    assert errs and isinstance(errs[0], ProtocolError)
    assert isinstance(errs[0].cause, UnicodeDecodeError)
    assert seen == [f"u{i}" for i in range(20)]


def test_u64_varint_truncates_identically_on_both_paths(route):
    big = (1 << 32) + 5
    payload = (bytes([0x12, 0x01]) + b"k" + bytes([0x18])
               + encode_uvarint(big) + bytes([0x20, 0x00, 0x28, 0x01]))
    wire = frame(TYPE_CHANGE, payload) * 200

    def decode_with(chunk):
        dec = _decode(route)
        out = []
        dec.change(lambda ch, done: (out.append(ch.change), done()))
        for off in range(0, len(wire), chunk):
            dec.write(wire[off:off + chunk])
        dec.end()
        return out

    assert decode_with(len(wire)) == decode_with(7) == [5] * 200


def test_bulk_then_partial_blob_tail(route):
    head = _wire(n=64, blob_every=9)
    blob_frame = frame(TYPE_BLOB, b"Q" * 100_000)
    dec = _decode(route)
    got = {"c": 0, "bytes": 0, "ended": 0}
    dec.change(lambda ch, done: (got.__setitem__("c", got["c"] + 1), done()))

    def on_blob(blob, done):
        blob.on_data(lambda ch: got.__setitem__(
            "bytes", got["bytes"] + len(ch)))
        blob.on_end(lambda: (got.__setitem__("ended", got["ended"] + 1),
                             done()))

    dec.blob(on_blob)
    wire = head + blob_frame
    split = len(head) + 5000
    dec.write(wire[:split])
    dec.write(wire[split:])
    dec.end()
    assert dec.finished
    assert got["c"] == 64
    assert got["bytes"] == sum(
        (i % 300) for i in range(64) if i % 9 == 0) + 100_000


def test_corrupt_header_mid_bulk_delivers_prefix_then_destroys(route):
    frames = [frame(TYPE_CHANGE, encode_change({
        "key": f"h{i}", "change": i, "from": 0, "to": 1})) for i in range(40)]
    wire = b"".join(frames) + bytes([0x80] * 10 + [0x01])

    def drive(chunk):
        dec = _decode(route)
        seen, errs = [], []
        dec.change(lambda ch, done: (seen.append(ch.key), done()))
        dec.on_error(errs.append)
        for off in range(0, len(wire), chunk):
            if dec.destroyed:
                break
            dec.write(wire[off:off + chunk])
        return seen, errs, dec.destroyed

    bulk = drive(len(wire))
    slow = drive(13)
    assert bulk[2] and slow[2]
    assert bulk[0] == slow[0] == [f"h{i}" for i in range(40)]
    assert bulk[1] and slow[1]
    assert str(bulk[1][0]) == str(slow[1][0])


def test_blob_pause_in_handler_defers_payload_in_bulk(route):
    head = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": f"p{i}", "change": i, "from": 0, "to": 1})) for i in range(20))
    wire = head + frame(TYPE_BLOB, b"Z" * 5000) + frame(
        TYPE_CHANGE, encode_change({"key": "after", "change": 1, "from": 0,
                                    "to": 1}))
    dec = _decode(route)
    got = {"chunks": [], "keys": []}
    holder = {}
    dec.change(lambda ch, done: (got["keys"].append(ch.key), done()))

    def on_blob(blob, done):
        blob.pause()
        holder["blob"] = blob
        blob.on_data(got["chunks"].append)
        blob.on_end(done)

    dec.blob(on_blob)
    dec.write(wire)
    assert got["chunks"] == [], "payload delivered despite pause()"
    assert got["keys"] == [f"p{i}" for i in range(20)]
    holder["blob"].resume()
    dec.end()
    assert dec.finished
    assert b"".join(got["chunks"]) == b"Z" * 5000
    assert got["keys"][-1] == "after"


def test_fuzz_random_chunking_equivalence(route):
    rng = random.Random(42)
    wire = _wire(n=120, blob_every=4)
    ref = _drive(_decode("python"), wire, len(wire))
    for trial in range(8):
        dec = _decode(route)
        events = []
        dec.change(lambda ch, done: (events.append(("c", _row(ch))), done()))
        dec.blob(lambda blob, done: blob.collect(
            lambda d: (events.append(("b", d)), done())))
        off = 0
        while off < len(wire):
            step = rng.choice([1, 3, 17, 255, 4096, 9999])
            dec.write(wire[off:off + step])
            off += step
        dec.end()
        assert dec.finished, trial
        assert events == ref, trial


def test_fuzz_hostile_bytes_never_hang(route):
    """Random garbage destroys with one ProtocolError or parses; the
    error is the same on both routes and on the JAX package's Python
    route, message, frame and offset."""
    rng = random.Random(7)
    for trial in range(20):
        blob = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 9000)))
        outcome = {}
        for r in ("native", "python"):
            dec = _decode(r)
            errs = []
            dec.on_error(errs.append)
            dec.write(blob)
            if dec.destroyed:
                assert errs, trial
            outcome[r] = [(str(e), e.frame, e.offset) for e in errs]
        assert outcome["native"] == outcome["python"], trial


def test_double_ack_on_bulk_path_is_noop(route):
    wire = _wire(n=120, blob_every=1 << 30)
    dec = _decode(route)
    seen, dones = [], []
    dec.change(lambda ch, done: (seen.append(ch.key), dones.append(done),
                                 done(), done()))
    dec.write(wire)
    dec.end()
    assert dec.finished
    assert seen == [f"key-{i}" for i in range(120)]
    for d in dones:
        d()
    assert dec.finished and not dec.destroyed


def test_cross_thread_ack_race_never_loses_or_doublecounts(route):
    wire = _wire(n=200, blob_every=1 << 30)
    for _ in range(20):
        dec = _decode(route)
        seen = []
        threads = []

        def on_change(ch, done):
            seen.append(ch.key)
            t = threading.Thread(target=done)
            t.start()
            threads.append(t)

        dec.change(on_change)
        done_box = []
        dec.write(wire)
        dec.end(lambda: done_box.append(1))
        for t in threads:
            t.join(timeout=5)
        deadline = time.monotonic() + 5
        while not dec.finished and time.monotonic() < deadline:
            time.sleep(0.01)
        assert dec.finished, "session never finished: an ack was lost"
        assert seen == [f"key-{i}" for i in range(200)]
        assert done_box == [1]


def test_changes_counter_increments_before_each_callback(route):
    wire = _wire(n=50, blob_every=1 << 30)
    dec = _decode(route)
    observed = []
    dec.change(lambda ch, done: (observed.append(dec.changes), done()))
    dec.write(wire)
    dec.end()
    assert observed == list(range(1, 51))


def test_handler_valueerror_propagates_not_protocolerror(route):
    wire = _wire(n=40, blob_every=1 << 30)
    dec = _decode(route)
    seen = []

    def handler(ch, done):
        seen.append(ch.key)
        if len(seen) == 10:
            raise ValueError("bad app state")
        done()

    dec.change(handler)
    errs = []
    dec.on_error(errs.append)
    with pytest.raises(ValueError, match="bad app state"):
        dec.write(wire)
    assert not dec.destroyed
    assert errs == []
    assert seen == [f"key-{i}" for i in range(10)]


def _drive_with_raising_handler(dec, wire, boom):
    seen = []

    def handler(ch, done):
        seen.append((ch.key, ch.change))
        done()
        if ch.change in boom:
            raise ValueError(f"app bug at change {ch.change}")

    dec.change(handler)
    raises = 0
    data = wire
    while True:
        try:
            dec.write(data)
            break
        except ValueError:
            raises += 1
            data = b""  # resume the parked cursor
    dec.end()
    return seen, raises


def test_handler_raise_then_resume_keeps_rows_paired(route):
    """The PR 7 pin on the bulk route: a handler raise mid-run advances
    both cursor halves, so a caught raise resumes at the next frame with
    payloads still paired to their rows."""
    n = 200
    wire = _wire(n=n, blob_every=1 << 30)
    dec = _decode(route)
    seen, raises = _drive_with_raising_handler(dec, wire, boom={17, 95, 160})
    assert dec.finished and not dec.destroyed
    assert raises == 3
    assert seen == [(f"key-{i}", i) for i in range(n)]


def test_handler_raise_then_resume_general_indexed_loop(route):
    class SubclassedDecoder(Decoder):
        # any override leaves the C change loop for the general one
        def _deliver_change(self, change, payload):
            super()._deliver_change(change, payload)

    n = 120
    wire = _wire(n=n, blob_every=1 << 30)
    dec = SubclassedDecoder(native=route == "native")
    seen, raises = _drive_with_raising_handler(dec, wire, boom={3, 64, 65})
    assert dec.finished and not dec.destroyed
    assert raises == 3
    assert seen == [(f"key-{i}", i) for i in range(n)]


def test_blob_handler_raise_then_resume_delivers_payload_once(route):
    head = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": f"k{i}", "change": i, "from": 0, "to": 1,
        "value": b"v" * 80})) for i in range(30))
    wire = head + frame(TYPE_BLOB, b"B" * 500) + frame(
        TYPE_CHANGE, encode_change({"key": "after", "change": 1,
                                    "from": 0, "to": 1}))
    dec = _decode(route)
    keys, chunks, boom = [], [], [True]
    dec.change(lambda ch, done: (keys.append(ch.key), done()))

    def on_blob(blob, done):
        def on_data(chunk):
            chunks.append(bytes(chunk))
            if boom:
                boom.clear()
                raise ValueError("blob handler bug")

        blob.on_data(on_data)
        blob.on_end(done)

    dec.blob(on_blob)
    with pytest.raises(ValueError, match="blob handler bug"):
        dec.write(wire)
    dec.write(b"")
    dec.end()
    assert dec.finished and not dec.destroyed
    assert b"".join(chunks) == b"B" * 500, "blob payload re-delivered"
    assert keys == [f"k{i}" for i in range(30)] + ["after"]


@pytest.mark.parametrize("n_head", [30, 2])  # bulk path / streaming path
def test_blob_raise_on_final_chunk_still_ends_blob(route, n_head):
    head = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": f"k{i}", "change": i, "from": 0, "to": 1,
        "value": b"v" * 80})) for i in range(n_head))
    wire = head + frame(TYPE_BLOB, b"B" * 500)
    dec = _decode(route)
    chunks, boom, ended = [], [True], []
    dec.change(lambda ch, done: done())

    def on_blob(blob, done):
        def on_data(chunk):
            chunks.append(bytes(chunk))
            if boom:
                boom.clear()
                raise ValueError("blob handler bug")

        blob.on_data(on_data)
        blob.on_end(lambda: (ended.append(True), done()))

    dec.blob(on_blob)
    with pytest.raises(ValueError, match="blob handler bug"):
        dec.write(wire)
    dec.write(b"")
    dec.end()
    assert ended, "on_end never fired for the fully delivered blob"
    assert dec.finished and not dec.destroyed
    assert b"".join(chunks) == b"B" * 500


@pytest.mark.parametrize("n_head", [30, 2])  # bulk path / streaming path
def test_zero_length_blob_handler_raise_still_ends_blob(route, n_head):
    head = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": f"k{i}", "change": i, "from": 0, "to": 1,
        "value": b"v" * 80})) for i in range(n_head))
    wire = head + frame(TYPE_BLOB, b"")
    dec = _decode(route)
    boom, ended = [True], []
    dec.change(lambda ch, done: done())

    def on_blob(blob, done):
        blob.on_end(lambda: (ended.append(True), done()))
        if boom:
            boom.clear()
            raise ValueError("blob handler bug")

    dec.blob(on_blob)
    with pytest.raises(ValueError, match="blob handler bug"):
        dec.write(wire)
    dec.write(b"")
    dec.end()
    assert ended, "zero-length blob never ended after the handler raise"
    assert dec.finished and not dec.destroyed


def test_randomized_ack_schedule_soak(route):
    """Randomized sync / cross-thread / double / late acks; a lost ack
    hangs the session and trips the deadline."""
    for seed in range(6):
        rng = random.Random(seed)
        wire = _wire(n=120, blob_every=11)
        dec = _decode(route)
        seen = []
        threads = []
        late = []

        def on_change(ch, done):
            seen.append(ch.key)
            mode = rng.random()
            if mode < 0.4:
                done()
                if rng.random() < 0.2:
                    done()
            elif mode < 0.85:
                t = threading.Thread(target=lambda d=done: (d(), d()))
                t.start()
                threads.append(t)
            else:
                late.append(done)

        dec.change(on_change)
        dec.blob(lambda b, done: b.collect(lambda _d: done()))
        for off in range(0, len(wire), 4096):
            deadline = time.time() + 15
            while (not dec.writable() and not dec.finished
                   and not dec.destroyed):
                if late:
                    late.pop(0)()
                assert time.time() < deadline, f"stalled, seed {seed}"
                time.sleep(0.0005)
            dec.write(wire[off:off + 4096])
        dec.end()
        deadline = time.time() + 15
        while not dec.finished:
            if late:
                late.pop(0)()
            assert time.time() < deadline, f"finalize hang, seed {seed}"
            time.sleep(0.0005)
        for t in threads:
            t.join(timeout=5)
        assert seen == [f"key-{i}" for i in range(120)], f"seed {seed}"


def test_streaming_raise_then_resume_preserves_chunk_tail(route):
    def mkch(k):
        return frame(TYPE_CHANGE, encode_change(
            {"key": k, "change": 1, "from": 0, "to": 1}))

    wire = mkch("before") + frame(TYPE_BLOB, b"B" * 50) + mkch("after")
    assert len(wire) < 2048, "must ride the streaming scanner"
    dec = _decode(route)
    keys, chunks, boom, ended = [], [], [True], []
    dec.change(lambda ch, done: (keys.append(ch.key), done()))

    def on_blob(blob, done):
        def on_data(c):
            chunks.append(bytes(c))
            if boom:
                boom.clear()
                raise ValueError("reader bug")

        blob.on_data(on_data)
        blob.on_end(lambda: (ended.append(True), done()))

    dec.blob(on_blob)
    with pytest.raises(ValueError, match="reader bug"):
        dec.write(wire)
    dec.write(b"")
    dec.end()
    assert keys == ["before", "after"], f"tail frame lost: {keys}"
    assert b"".join(chunks) == b"B" * 50 and ended
    assert dec.finished and not dec.destroyed

    dec = _decode(route)
    keys, boom = [], [True]

    def handler(ch, done):
        keys.append(ch.key)
        done()
        if boom:
            boom.clear()
            raise ValueError("app bug")

    dec.change(handler)
    with pytest.raises(ValueError, match="app bug"):
        dec.write(mkch("a") + mkch("b") + mkch("c"))
    dec.write(b"")
    dec.end()
    assert keys == ["a", "b", "c"], f"tail frames lost: {keys}"
    assert dec.finished and not dec.destroyed

    dec = _decode(route)
    keys, got, boom, ended = [], [], [True], []
    dec.change(lambda ch, done: (keys.append(ch.key), done()))

    def on_blob2(blob, done):
        blob.on_data(lambda c: got.append(bytes(c)))
        blob.on_end(lambda: (ended.append(True), done()))
        if boom:
            boom.clear()
            raise ValueError("open bug")

    dec.blob(on_blob2)
    with pytest.raises(ValueError, match="open bug"):
        dec.write(frame(TYPE_BLOB, b"PAY") + mkch("tail"))
    dec.write(b"")
    dec.end()
    assert b"".join(got) == b"PAY" and keys == ["tail"] and ended
    assert dec.finished and not dec.destroyed


# -- beyond the JAX package's cases -----------------------------------------

def _bad_wires():
    good = [frame(TYPE_CHANGE, encode_change({
        "key": f"e{i}", "change": i, "from": 0, "to": 1, "value": b"x" * 40}))
        for i in range(60)]
    head = b"".join(good[:30])
    tail = b"".join(good[30:])
    bad_utf8 = frame(TYPE_CHANGE, bytes([0x12, 0x02, 0xC3, 0x28, 0x18, 0x01,
                                         0x20, 0x00, 0x28, 0x01]))
    bad_subset = frame(TYPE_CHANGE, bytes([0x0A, 0x01, 0xFF, 0x12, 0x01,
                                           0x6B, 0x18, 0x01, 0x20, 0x00,
                                           0x28, 0x01]))
    return {
        "wire-type": head + frame(TYPE_CHANGE, bytes([0x12, 0x01, 0x6B,
                                                      0x0C])) + tail,
        "missing-field": head + frame(TYPE_CHANGE, bytes([0x12, 0x01,
                                                          0x6B])) + tail,
        "truncated-field": head + frame(TYPE_CHANGE, bytes([0x12, 0x09,
                                                            0x6B])) + tail,
        "varint-64": head + frame(TYPE_CHANGE, bytes([0x18] + [0xFF] * 9
                                                     + [0x7F])) + tail,
        "key-not-utf8": head + bad_utf8 + tail,
        "subset-not-utf8": head + bad_subset + tail,
        "header-varint": head + bytes([0xFF] * 9 + [0x7F, 0x01]) + tail,
        "header-too-long": head + bytes([0x80] * 12) + tail,
        "zero-length": head + bytes([0x00, 0x01]) + tail,
        "unknown-type": head + bytes([0x02, 0x09, 0x00]) + tail,
    }


def _errors(dec, wire, step):
    errs, seen = [], []
    dec.on_error(errs.append)
    dec.change(lambda ch, done: (seen.append(ch.key), done()))
    for off in range(0, len(wire), step):
        if dec.destroyed:
            break
        dec.write(wire[off:off + step])
    assert len(errs) == 1
    e = errs[0]
    return (seen, str(e), e.frame, e.offset, type(e.cause).__name__,
            str(e.cause))


@pytest.mark.parametrize("name", sorted(_bad_wires()))
def test_errors_match_the_streaming_route_and_the_jax_decoder(name,
                                                              monkeypatch):
    """Type, message, frame, byte offset and cause of a wire error in the
    middle of a bulk buffer equal the streaming route's at any chunking,
    and the JAX package's Python route's."""
    wire = _bad_wires()[name]
    for step in (len(wire), 4096, 333):
        want = _errors(_jax_decode("jax-python", monkeypatch), wire, step)
        assert _errors(_decode("native"), wire, step) == want, step
        assert _errors(_decode("python"), wire, step) == want, step


def _ckpt(c):
    return (c.wire_offset, c.frame, c.row, c.blob_offset, dict(c.digest))


def test_checkpoint_while_an_index_is_parked(route, monkeypatch):
    """Every ack is held; after each release the checkpoint equals the
    streaming route's and the JAX package's at the same point."""

    def run(dec):
        pending, out = [], []
        dec.change(lambda ch, done: pending.append(done))
        dec.blob(lambda blob, done: blob.collect(lambda _d: done()))
        dec.write(_wire(n=90, blob_every=6))
        out.append(_ckpt(dec.checkpoint()))
        while pending:
            pending.pop(0)()
            out.append(_ckpt(dec.checkpoint()))
        dec.end()
        assert dec.finished
        return out

    got = run(_decode(route))
    assert got == run(_decode("python"))
    for r in JAX_ROUTES:
        assert got == run(_jax_decode(r, monkeypatch))


def _blake(b):
    return hashlib.blake2b(bytes(b), digest_size=32).digest()


@pytest.mark.parametrize("raise_at", [None, 7, 150])
def test_digest_decoder_keeps_submit_order_on_both_routes(route, raise_at):
    """``CudaDecoder`` on the CPU: change and blob digests arrive in seq
    order, each equal to hashlib, including when a handler raises in the
    middle of a C run (the run's payloads are owed and submitted)."""
    wire = _wire(n=200, blob_every=13)
    dec = CudaDecoder(pipeline=DigestPipeline(device="cpu", max_batch=64),
                      device="cpu", native=route == "native")
    got = []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    boom = {raise_at}

    def handler(ch, done):
        done()
        if ch.change in boom:
            boom.clear()
            raise ValueError("app bug")

    dec.change(handler)
    try:
        dec.write(wire)
    except ValueError:
        dec.write(b"")
    dec.end()
    assert dec.finished
    changes = [(s, d) for k, s, d in got if k == "change"]
    blobs = [(s, d) for k, s, d in got if k == "blob"]
    assert [s for s, _ in changes] == list(range(200))
    want = [_blake(encode_change({
        "key": f"key-{i}", "change": i, "from": i, "to": i + 1,
        "value": b"v" * (i % 90), "subset": "s" if i % 3 else None}))
        for i in range(200)]
    assert [d for _, d in changes] == want
    assert [d for _, d in blobs] == [
        _blake(bytes([i & 255]) * (i % 300)) for i in range(200)
        if i % 13 == 0]


@pytest.fixture
def lit():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    tracing.SPANS.clear()
    wirecost.WIRECOST.reset_for_tests()
    metrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        tracing.SPANS.clear()
        wirecost.WIRECOST.reset_for_tests()


def test_one_run_instant_per_c_run_and_the_wire_cost_sums(lit):
    """The native route tags a C run with one ``decoder.frame.run``
    covering its wire range; the streaming route tags each frame.  Both
    charge the wire cost ledger every byte of the transport and count
    every change."""
    wire = b"".join(frame(TYPE_CHANGE, encode_change({
        "key": f"r{i}", "change": i, "from": 0, "to": 1,
        "value": b"w" * (i % 200)})) for i in range(300))
    for route_ in ROUTES:
        tracing.SPANS.clear()
        wirecost.WIRECOST.reset_for_tests()
        metrics.REGISTRY.reset()
        dec = _decode(route_)
        dec.cost_link = f"bulk-{route_}"
        dec.change(lambda ch, done: done())
        dec.write(wire)
        dec.end()
        runs = tracing.SPANS.spans("decoder.frame.run")
        frames = tracing.SPANS.spans("decoder.frame")
        if route_ == "native":
            assert [(r["fields"]["offset"], r["fields"]["wire_len"],
                     r["fields"]["frames"]) for r in runs] == [
                (0, len(wire), 300)]
            assert frames == []
        else:
            assert runs == [] and len(frames) == 300
        rec = wirecost.WIRECOST.snapshot()["links"][f"bulk-{route_}|rx"]
        c = rec["classes"]["change"]
        assert c["payload"] + c["framing"] == len(wire)
        assert c["frames"] == 300
        assert metrics.snapshot()["counters"]["decoder.changes"] == 300


def test_size_gate_before_the_merge(route):
    """Below ``_NATIVE_MIN`` queued bytes nothing is merged or indexed,
    and a stalled decoder does not re-copy its backlog at each write."""
    dec = _decode(route)
    pending = []
    dec.change(lambda ch, done: pending.append(done))
    one = frame(TYPE_CHANGE, encode_change({"key": "g", "change": 1,
                                            "from": 0, "to": 1}))
    dec.write(one)  # stalls on the held ack
    chunks = [one * 30 for _ in range(20)]
    for c in chunks:
        dec.write(c)
    # held behind the ack, the queue is the writes themselves, unmerged
    assert len(dec._overflow) == 20 and dec._bulk is None
    assert dec._overflow_bytes == sum(len(c) for c in chunks)
    while pending:
        pending.pop(0)()
    assert dec.changes == 1 + 20 * 30
    assert dec._overflow_bytes == 0 and not dec._overflow


def test_wire_offsets_stay_exact_across_a_parked_run(route):
    """``_parsed`` (the watermark's parse frontier) ends at the wire's
    length on both routes, and a parked index resumes without
    re-indexing (one index for the whole buffer)."""
    wire = _wire(n=80, blob_every=1 << 30)
    dec = _decode(route)
    pending = []
    dec.change(lambda ch, done: pending.append(done))
    indexed = []
    if route == "native":
        real = dec._install_index

        def spy(*a, **k):
            indexed.append(1)
            return real(*a, **k)

        dec._install_index = spy
    dec.write(wire)
    while pending:
        pending.pop(0)()
    dec.end()
    assert dec.finished and dec._parsed == dec.bytes == len(wire)
    assert indexed == ([1] if route == "native" else [])


def test_native_and_python_routes_share_no_state():
    """The route is the instance's: a Python-route decoder never indexes
    and never builds an AckBoard, whatever other decoders do."""
    wire = _wire(n=60, blob_every=1 << 30)
    a, b = _decode("native"), _decode("python")
    for d in (a, b):
        d.change(lambda ch, done: done())
        d.write(wire)
        d.end()
    assert a._ack_board is not None and b._ack_board is None
    assert a.changes == b.changes == 60
