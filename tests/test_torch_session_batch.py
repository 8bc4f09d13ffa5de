"""Negotiated ``ChangeBatch`` sessions: the port against the JAX package.

The same submissions go through both packages' encoders: with
``CAP_CHANGE_BATCH`` negotiated the wires must be byte-identical for
every flush policy, and with ``peer_caps=0`` the wire must stay the
reference's.  Both decoders must deliver the same rows in the same
order, whole columns to a ``change_batch`` handler or row by row with
async acks stalling and resuming; a corrupt batch must destroy both with
a ``ProtocolError`` at the same frame and byte.  The digest sessions
(``CudaEncoder`` / ``decode(backend="cuda", device="cpu")``) must give
the same digest stream for batch and per-record wires, equal to the JAX
package's and to ``hashlib``.  Every comparison is exact.
"""

import hashlib

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    CudaDecoder,
    CudaEncoder,
)
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.session import (
    encoder as encoder_module,
)
from dat_replication_protocol_tpu_torch.wire import batch_codec
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)
from dat_replication_protocol_tpu_torch.wire.framing import (
    CAP_CHANGE_BATCH,
    LOCAL_CAPS,
    TYPE_BLOB,
    TYPE_CHANGE,
    TYPE_CHANGE_BATCH,
    ProtocolError,
    frame,
)

PACKAGES = {"port": protocol, "jax": jax_protocol}


def _drain(e) -> bytes:
    out = bytearray()
    while (c := e.read()) not in (None, b""):
        out += c
    return bytes(out)


def _records(n, seed=0, keyspace=16):
    rng = np.random.default_rng(seed)
    return [{"key": f"key-{int(rng.integers(0, keyspace)):05d}",
             "change": i, "from": i, "to": i + 1,
             "value": (rng.bytes(int(rng.integers(0, 40))) if i % 5
                       else None),
             "subset": "s" if i % 3 else None}
            for i in range(n)]


def _expected(records):
    return [{**r, "value": r["value"] or b"", "subset": r["subset"] or ""}
            for r in records]


def _ids(wire) -> list[int]:
    return replay.split_frames(np.frombuffer(wire, np.uint8)).ids.tolist()


def _batch_rows(wire) -> list[int]:
    """Rows of each ChangeBatch frame of ``wire``, in order."""
    idx = replay.split_frames(np.frombuffer(wire, np.uint8))
    return [len(batch_codec.decode_change_batch(wire[s:s + n]))
            for s, n, t in zip(idx.starts.tolist(), idx.lens.tolist(),
                               idx.ids.tolist()) if t == TYPE_CHANGE_BATCH]


def _script(p, name, records):
    """One submission script on package ``p``; returns the wire."""
    policies = {"default": None,
                "rows-64": p.BatchPolicy(max_rows=64),
                "bytes-500": p.BatchPolicy(max_bytes=500),
                "delay-0": p.BatchPolicy(max_delay=0.0)}
    if name == "no-caps":
        e = p.encode()
    elif name == "negotiate":
        e = p.encode()
        e.negotiate(p.CAP_CHANGE_BATCH)
    else:
        e = p.encode(peer_caps=p.CAP_CHANGE_BATCH,
                     batch_policy=policies.get(name))
    third = len(records) // 3
    for r in records[:third]:
        e.change(r)
    b = e.blob(5)  # rows before it flush first
    e.change(records[third])  # parked behind the open blob
    b.end(b"hello")
    e.change_many(records[third + 1:2 * third])
    if name == "read-uncork":
        _drain(e)
    for r in records[2 * third:]:
        e.change(r)
    if name == "revoke":
        e.negotiate(0)  # pending rows re-frame per record
        e.change(records[0])
    e.finalize()
    return _drain(e)


SCRIPTS = ["no-caps", "default", "rows-64", "bytes-500", "delay-0",
           "negotiate", "read-uncork", "revoke"]


@pytest.mark.parametrize("name", SCRIPTS)
def test_encoder_wire_matches_jax(name):
    records = _records(300, 1)
    wire = _script(protocol, name, records)
    assert wire == _script(jax_protocol, name, records)
    ids = _ids(wire)
    if name == "no-caps":
        assert TYPE_CHANGE_BATCH not in ids
    else:
        assert TYPE_CHANGE_BATCH in ids
    if name == "revoke":
        assert ids[-2:] == [TYPE_CHANGE, TYPE_CHANGE]


def test_capability_less_wire_is_the_reference_wire():
    e = protocol.encode()
    e.change({"key": "key", "from": 0, "to": 1, "change": 1,
              "value": b"hello"})
    b = e.blob(11)
    b.write(b"hello ")
    b.write(b"world")
    b.end()
    payload = bytes.fromhex("12036b6579180120002801320568656c6c6f")
    assert _drain(e) == (bytes([0x13, 0x01]) + payload
                         + bytes([0x0C, 0x02]) + b"hello world")
    records = _records(40, 2)
    e = protocol.encode()
    e.change_many(records)
    e.finalize()
    assert _drain(e) == b"".join(frame(TYPE_CHANGE, encode_change(r))
                                 for r in records)


@pytest.mark.parametrize("name", ["default", "rows-64", "read-uncork",
                                  "revoke"])
@pytest.mark.parametrize("size", [1, 7, 4096, 1 << 20])
def test_decoders_deliver_the_same_rows_in_order(name, size):
    wire = _script(protocol, name, _records(120, 3))
    got = {}
    for key, p in PACKAGES.items():
        d = p.decode()
        events = []
        d.change(lambda c, done: (events.append(c.to_dict()), done()))
        d.blob(lambda bl, done: bl.collect(
            lambda data: (events.append(data), done())))
        for off in range(0, len(wire), size):
            d.write(wire[off:off + size])
        d.end()
        assert d.finished
        got[key] = (events, d.changes, d.blobs)
    assert got["port"] == got["jax"]


def test_change_batch_handler_gets_whole_columns():
    records = _records(200, 4)
    wire = _script(protocol, "rows-64", records)
    for p in PACKAGES.values():
        d = p.decode()
        batches, rows = [], []
        d.change_batch(lambda cols, done: (batches.append(cols), done()))
        d.change(lambda c, done: (rows.append(c.to_dict()), done()))
        d.write(wire)
        d.end()
        assert d.finished and d.changes == 200
        assert [len(b) for b in batches] == _batch_rows(wire)
        assert len(batches) >= 4 and len(rows) >= 1
        delivered = [b.row(i).to_dict() for b in batches
                     for i in range(len(b))]
        if p is protocol:
            port = (delivered, rows)
    assert port == (delivered, rows)
    assert sorted(r["change"] for r in delivered + rows) == list(range(200))


def test_change_batch_handler_async_ack_stalls_the_next_frame():
    wire = _script(protocol, "rows-64", _records(100, 5))
    sizes = _batch_rows(wire)
    d = protocol.decode()
    held, seen = [], []
    d.change_batch(lambda cols, done: (seen.append(len(cols)),
                                       held.append(done)))
    d.change(lambda c, done: (seen.append(-1), done()))
    assert not d.write(wire)
    assert seen == sizes[:1] and not d.writable()
    d.end()
    while held:
        assert not d.finished
        held.pop()()
    assert d.finished
    assert [n for n in seen if n >= 0] == sizes
    assert sum(sizes) + seen.count(-1) == 100


def test_per_row_async_ack_stalls_and_resumes_in_order():
    wire = _script(protocol, "default", _records(30, 6))
    for p in PACKAGES.values():
        d = p.decode()
        rows, pend = [], []

        def handler(c, done, rows=rows, pend=pend):
            rows.append(c.change)
            if c.change in (10, 25):
                pend.append(done)
            else:
                done()

        d.change(handler)
        d.blob(lambda bl, done: bl.collect(lambda _x: done()))
        assert not d.write(wire)
        assert rows == list(range(11)) and not d.writable()
        d.end()
        assert not d.finished
        pend.pop()()
        assert rows[-1] == 25 and not d.finished
        pend.pop()()
        assert d.finished and sorted(rows) == list(range(30))
        if p is protocol:
            port_rows = rows
    assert port_rows == rows


@pytest.mark.parametrize("name", ["no-caps", "default"])
def test_handler_raise_consumes_its_row_and_resumes_at_the_next(name):
    """A handler that raises before ``done`` consumes its change: a
    caught raise then ``write(b"")`` goes on with the next row, per
    record and mid-batch, as in the JAX package."""
    records = _records(20, 7)
    e = protocol.encode(peer_caps=0 if name == "no-caps"
                        else CAP_CHANGE_BATCH)
    e.change_many(records)
    e.finalize()
    wire = _drain(e)
    for p in PACKAGES.values():
        d = p.decode()
        rows = []

        def handler(c, done, rows=rows):
            rows.append(c.change)
            if c.change == 5 and rows.count(5) == 1:
                raise RuntimeError("app hiccup")
            done()

        d.change(handler)
        with pytest.raises(RuntimeError):
            d.write(wire)
        assert rows == list(range(6))
        d.write(b"")
        d.end()
        assert d.finished and rows == list(range(20))


def test_flush_policy_max_rows_sizes_frames():
    e = protocol.encode(peer_caps=CAP_CHANGE_BATCH,
                        batch_policy=protocol.BatchPolicy(max_rows=100))
    for r in _records(250, 8):
        e.change(r)
    e.finalize()
    assert _ids(_drain(e)) == [TYPE_CHANGE_BATCH] * 3  # 100, 100, 50


def test_blob_flushes_pending_rows_first():
    e = protocol.encode(peer_caps=CAP_CHANGE_BATCH)
    e.change({"key": "before", "change": 1, "from": 0, "to": 1})
    e.blob(3).end(b"xyz")
    e.change({"key": "after", "change": 2, "from": 1, "to": 2})
    e.finalize()
    wire = _drain(e)
    assert _ids(wire) == [TYPE_CHANGE_BATCH, TYPE_BLOB, TYPE_CHANGE_BATCH]
    d = protocol.decode()
    events = []
    d.change(lambda c, done: (events.append(c.key), done()))
    d.blob(lambda bl, done: bl.collect(
        lambda data: (events.append(data), done())))
    d.write(wire)
    d.end()
    assert events == ["before", b"xyz", "after"]


def test_read_uncorks_and_max_delay_flushes_on_the_next_submit(monkeypatch):
    e = protocol.encode(peer_caps=CAP_CHANGE_BATCH)
    e.change({"key": "k", "change": 1, "from": 0, "to": 1})
    assert e.bytes == 0
    data = e.read()
    assert data and data[1] == TYPE_CHANGE_BATCH
    clock = [100.0]
    monkeypatch.setattr(encoder_module, "_now", lambda: clock[0])
    e = protocol.encode(peer_caps=CAP_CHANGE_BATCH,
                        batch_policy=protocol.BatchPolicy(max_delay=1.0))
    for i, t in enumerate((100.0, 100.5, 101.0, 101.2)):
        clock[0] = t
        e.change({"key": "a", "change": i, "from": 0, "to": 1})
        # the third submit is 1 s after the first pending row
        assert (e.bytes > 0) == (i >= 2)
    assert _batch_rows(_drain(e)) == [3, 1]


def test_revocation_reframes_pending_rows_per_record():
    e = protocol.encode()
    e.negotiate(CAP_CHANGE_BATCH)
    fired = []
    a = {"key": "a", "change": 1, "from": 0, "to": 1, "value": b"x",
         "subset": "s"}
    b = {"key": "b", "change": 2, "from": 1, "to": 2}
    e.change(a, on_flush=lambda: fired.append(1))
    e.negotiate(0)
    e.change(b)
    e.finalize()
    assert _drain(e) == (frame(TYPE_CHANGE, encode_change(a))
                         + frame(TYPE_CHANGE, encode_change(b)))
    assert fired == [1]


def test_flush_callbacks_high_water_and_submit_time_validation():
    e = protocol.encode(peer_caps=CAP_CHANGE_BATCH)
    fired = []
    e.change({"key": "a", "change": 1, "from": 0, "to": 1},
             on_flush=lambda: fired.append("a"))
    e.change({"key": "b", "change": 2, "from": 1, "to": 2},
             on_flush=lambda: fired.append("b"))
    assert fired == []
    with pytest.raises(ValueError):
        e.change({"key": "k", "change": -1, "from": 0, "to": 1})
    with pytest.raises(KeyError):
        e.change({"key": "k", "change": 1, "to": 1})
    e.finalize()
    _drain(e)
    assert fired == ["a", "b"] and e.changes == 2
    e = protocol.encode(high_water=256, peer_caps=CAP_CHANGE_BATCH,
                        batch_policy=protocol.BatchPolicy(
                            max_rows=1 << 30, max_bytes=1 << 30))
    ok = [e.change({"key": f"k-{i}", "change": i, "from": i, "to": i + 1})
          for i in range(40)]
    assert ok[0] and not ok[-1] and not e.writable()


def test_corrupt_batch_is_a_protocol_error_at_the_same_frame():
    rows = [(b"k%d" % i, i, 0, 1, None, None) for i in range(10)]
    bad = bytearray(frame(TYPE_CHANGE_BATCH, batch_codec.encode_rows(rows)))
    bad[3] = 0xEE  # a width byte: structurally corrupt
    wire = frame(TYPE_CHANGE, encode_change(_records(1)[0])) + bytes(bad)
    errs = {}
    for key, p in PACKAGES.items():
        d = p.decode()
        seen = []
        d.on_error(seen.append)
        d.change(lambda c, done: done())
        d.write(wire)
        assert d.destroyed and len(seen) == 1
        errs[key] = (type(seen[0]).__name__, seen[0].frame, seen[0].offset)
    assert errs["port"] == errs["jax"] == ("ProtocolError", 1, len(wire))
    assert isinstance(seen[0], Exception)


def test_capabilities_advertise_only_the_batch_frame():
    # the batch frame's bit among the negotiated frames the port parses
    # (reconcile and snapshot since they were ported): the same mask as
    # the JAX package's, and any other type id is still an error
    assert protocol.Decoder.capabilities() == LOCAL_CAPS \
        == jax_protocol.Decoder.capabilities()
    assert LOCAL_CAPS & CAP_CHANGE_BATCH
    d = protocol.decode()
    errs = []
    d.on_error(errs.append)
    d.write(frame(6, b"unknown"))
    assert isinstance(errs[0], ProtocolError)
    assert "unknown type: 6" in str(errs[0])


def _h(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _digests(dec, wire, batch_handler=False):
    out = []
    dec.on_digest(lambda kind, seq, d: out.append((kind, seq, d)))
    if batch_handler:
        dec.change_batch(lambda cols, done: done())
    dec.change(lambda c, done: done())
    dec.blob(lambda b, done: b.collect(lambda _x: done()))
    for off in range(0, len(wire), 1000):
        dec.write(wire[off:off + 1000])
    dec.end()
    assert dec.finished
    return out


def test_digest_streams_match_for_batch_and_per_record_wires():
    records = _records(150, 9, keyspace=40)
    per_record = _script(protocol, "no-caps", records)
    batched = _script(protocol, "rows-64", records)
    want = _digests(jax_protocol.decode(backend="tpu"), per_record)
    assert want == _digests(jax_protocol.decode(backend="tpu"), batched)
    for wire in (per_record, batched):
        for whole in (False, True):
            assert _digests(protocol.decode(backend="cuda", device="cpu"),
                            wire, whole) == want
    cols, frames = replay.replay_log(np.frombuffer(per_record, np.uint8))
    payloads = [per_record[s:s + n]
                for s, n, t in zip(frames.starts, frames.lens, frames.ids)]
    assert [d for _, _, d in want] == [_h(p) for p in payloads]


def test_encoder_digest_streams_survive_negotiation():
    records = _records(90, 10)

    def encoder_digests(p, **kw):
        if p is protocol:
            e = CudaEncoder(device="cpu", **kw)
        else:
            e = p.encode(backend="tpu", **kw)
        out = []
        e.on_digest(lambda kind, seq, d: out.append((kind, seq, d)))
        e.change_many(records[:40])
        e.blob(4).end(b"data")
        for r in records[40:]:
            e.change(r)
        e.finalize()
        if p is jax_protocol:
            # its finalize flushes the pipeline before the last batch
            e.digest_pipeline.flush()
        # the port's digests are all in at finalize, the last batch's too
        return out

    plain = encoder_digests(protocol)
    assert len(plain) == 91
    assert plain == encoder_digests(protocol, peer_caps=CAP_CHANGE_BATCH,
                                    batch_policy=protocol.BatchPolicy(
                                        max_rows=16))
    assert plain == encoder_digests(jax_protocol,
                                    peer_caps=CAP_CHANGE_BATCH)
    changes = [d for kind, _, d in plain if kind == "change"]
    assert changes == [_h(encode_change(r)) for r in records]
    # the JAX package's per-record change_many submits no digests: the
    # port digests every row whatever the framing (ROADMAP.md, section C)
    assert len(encoder_digests(jax_protocol)) == 51


def test_digest_decoder_without_subscribers_keeps_seq():
    wire = _script(protocol, "rows-64", _records(70, 11))
    d = CudaDecoder(device="cpu")
    rows = []
    d.change(lambda c, done: (rows.append(c.change), done()))
    d.write(wire)
    d.end()
    assert d.finished and len(rows) == 70 and d._change_seq == 70
