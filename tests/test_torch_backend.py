"""The whole slice on the CPU: the digest session and the sidecar.

A seeded session is encoded once and decoded twice, by the port's
``decode(backend="cuda", device="cpu")`` and by the JAX package's
``decode(backend="tpu")``: the digest streams must be identical, in the
same order, and every digest must be ``hashlib``'s.  The pipeline probes
(flush-before-finalize, byte and item caps, bounded in-flight batches,
readback prefetch) and the sidecar's reply frames run on the port alone.
"""

import hashlib
import io

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch import entry, sidecar
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    CudaDecoder,
    DigestPipeline,
    _HostStream,
)
from dat_replication_protocol_tpu_torch.ops import merkle


def _h(data) -> bytes:
    return hashlib.blake2b(data, digest_size=32).digest()


def _session(seed, n=30, max_blob=6000):
    """(wire, change payloads, blobs) of a seeded mixed session."""
    rng = np.random.default_rng(seed)
    e = protocol.encode()
    payloads, blobs = [], []
    for i in range(n):
        if rng.random() < 0.3:
            blob = rng.bytes(int(rng.integers(1, max_blob)))
            blobs.append(blob)
            w = e.blob(len(blob))
            w.write(blob[:len(blob) // 2])
            w.end(blob[len(blob) // 2:])
        else:
            c = {"key": f"k{i}", "change": i, "from": 0, "to": 1,
                 "value": rng.bytes(int(rng.integers(40, 201)))}
            payloads.append(protocol.encode_change(c))
            e.change(c)
    e.finalize()
    wire = bytearray()
    while (chunk := e.read()) is not None:
        wire += chunk
    return bytes(wire), payloads, blobs


def _digests(dec, wire, chunking):
    got, at_finalize = [], []
    dec.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    dec.change(lambda c, done: done())
    dec.blob(lambda b, done: b.collect(lambda _x: done()))
    dec.finalize(lambda done: (at_finalize.append(len(got)), done()))
    for off in range(0, len(wire), chunking):
        dec.write(wire[off:off + chunking])
    dec.end()
    assert dec.finished and not dec.destroyed
    assert at_finalize == [len(got)]  # every digest before finalize
    return got


@pytest.mark.parametrize("chunking", [97, 4096, 1 << 20])
@pytest.mark.parametrize("seed", [0, 1])
def test_digest_stream_matches_jax_backend(seed, chunking):
    wire, payloads, blobs = _session(seed)
    ours = _digests(protocol.decode(backend="cuda", device="cpu"), wire,
                    chunking)
    assert ours == _digests(jax_protocol.decode(backend="tpu"), wire,
                            chunking)
    assert [d for k, _, d in ours if k == "change"] == [_h(p)
                                                        for p in payloads]
    assert [d for k, _, d in ours if k == "blob"] == [_h(b) for b in blobs]


@pytest.mark.parametrize("max_batch,max_batch_bytes", [(3, 1 << 30),
                                                       (1000, 5000)])
def test_caps_autodispatch_inside_a_session(max_batch, max_batch_bytes):
    wire, payloads, blobs = _session(2)
    pipeline = DigestPipeline(max_batch=max_batch,
                              max_batch_bytes=max_batch_bytes, device="cpu")
    dec = CudaDecoder(pipeline=pipeline, device="cpu")
    got = _digests(dec, wire, 512)
    assert pipeline.dispatches > 1
    assert pipeline.batched == len(got) and pipeline.streamed == 0
    assert sorted(d for _, _, d in got) == sorted(
        [_h(p) for p in payloads] + [_h(b) for b in blobs])


def test_large_blobs_stream_through_host_hash():
    wire, payloads, blobs = _session(3)
    dec = protocol.decode(backend="cuda", device="cpu", stream_threshold=2000)
    got = _digests(dec, wire, 700)
    big = sum(len(b) >= 2000 for b in blobs)
    assert big and dec.digest_pipeline.streamed == big
    assert [d for k, _, d in got if k == "blob"] == [_h(b) for b in blobs]


def test_encoder_digests_match_hashlib_and_wire_is_unchanged():
    enc = protocol.encode(backend="cuda", device="cpu")
    got = []
    enc.on_digest(lambda kind, seq, d: got.append((kind, seq, d)))
    plain = protocol.encode()
    c = {"key": "a", "change": 1, "from": 0, "to": 1, "value": b"xyz"}
    for e in (enc, plain):
        e.change(c)
        w = e.blob(10)
        w.write(b"01234")
        w.end(b"56789")
        e.change(dict(c, change=2))
    assert got == []  # nothing delivered before the finalize flush
    enc.finalize()
    plain.finalize()
    assert enc.read() == plain.read()
    assert got == [("change", 0, _h(protocol.encode_change(c))),
                   ("blob", 0, _h(b"0123456789")),
                   ("change", 1, _h(protocol.encode_change(dict(c,
                                                                change=2))))]


def test_pipeline_byte_cap_autodispatches():
    pl = DigestPipeline(max_batch=1000, max_batch_bytes=100, device="cpu")
    got = []
    pl.submit(b"z" * 60, got.append)
    assert pl.dispatches == 0
    pl.submit(b"z" * 60, got.append)
    assert pl.dispatches == 1
    pl.flush()
    assert got == [_h(b"z" * 60)] * 2


def test_pipeline_item_cap_counts_streams_and_keeps_order():
    pl = DigestPipeline(max_batch=2, device="cpu")
    got = []
    pl.submit(b"aa", lambda d: got.append(("p0", d)))
    pl.submit_stream(_HostStream().update(b"s" * 300),
                     lambda d: got.append(("s1", d)))
    assert pl.dispatches == 1
    pl.submit(b"bb", lambda tag, d: got.append((tag, d)), tag="p2")
    pl.flush()
    assert got == [("p0", _h(b"aa")), ("s1", _h(b"s" * 300)),
                   ("p2", _h(b"bb"))]
    assert pl.hashed_bytes == 304 and (pl.batched, pl.streamed) == (2, 1)


def test_pipeline_bounds_inflight_and_prefetches_readback():
    events = []

    def begin(payloads):
        n = len(events)
        events.append(("dispatch", n))

        def collect():
            events.append(("collect", n))
            return [_h(p) for p in payloads]

        collect.start_d2h = lambda: events.append(("d2h", n))
        return collect

    pl = DigestPipeline(hash_begin=begin, max_batch=2, max_inflight=2)
    got = []
    for i in range(8):
        pl.submit(b"%d" % i, got.append)
    dispatched = [e for e in events if e[0] == "dispatch"]
    assert len(dispatched) == 4 and pl.inflight == 2
    assert got == [_h(b"%d" % i) for i in range(4)]
    # each batch's readback starts before it is collected
    for kind, n in events:
        if kind == "collect":
            assert events.index(("d2h", n)) < events.index(("collect", n))
    pl.flush()
    assert got == [_h(b"%d" % i) for i in range(8)] and pl.inflight == 0


def test_pipeline_rejects_a_short_digest_list():
    pl = DigestPipeline(hash_begin=lambda payloads: (lambda: []))
    pl.submit(b"x", lambda d: None)
    with pytest.raises(RuntimeError, match="0 digests for 1 payloads"):
        pl.flush()


def _sidecar_wire():
    e = protocol.encode()
    changes = [{"key": f"k{i}", "change": i, "from": 0, "to": 1,
                "value": bytes([i]) * 50} for i in range(5)]
    e.change(changes[0])
    e.blob(3).end(b"abc")
    for c in changes[1:]:
        e.change(c)
    e.blob(70000).end(b"q" * 70000)
    e.finalize()
    wire = bytearray()
    while (chunk := e.read()) is not None:
        wire += chunk
    return bytes(wire), changes


def test_sidecar_replies_carry_hashlib_digests():
    wire, changes = _sidecar_wire()
    reply = bytearray()
    closed = []
    out = sidecar.run_session(io.BytesIO(wire).read, reply.extend,
                              close_write=lambda: closed.append(1),
                              device="cpu", chunk_size=1000)
    assert out == {"changes": 5, "blobs": 2, "bytes": len(wire),
                   "digests": 7, "ok": True}
    assert closed == [1]
    dec = protocol.decode()
    got = []
    dec.change(lambda c, done: (got.append(c.to_dict()), done()))
    dec.write(bytes(reply))
    dec.end()
    assert dec.finished
    want = [("change", i, _h(protocol.encode_change(c)))
            for i, c in enumerate(changes)]
    want += [("blob", 0, _h(b"abc")), ("blob", 1, _h(b"q" * 70000))]
    rows = {(r["subset"], r["key"], r["change"], r["value"]) for r in got}
    assert rows == {(f"digest:{k}", f"{k}-{s}", s, d) for k, s, d in want}
    assert all(r["from"] == 0 and r["to"] == 1 for r in got)


def test_sidecar_garbage_ends_both_directions():
    reply = bytearray()
    closed = []
    out = sidecar.run_session(io.BytesIO(b"\xff" * 64).read, reply.extend,
                              close_write=lambda: closed.append(1),
                              device="cpu")
    assert out["ok"] is False and closed == [1]


def test_sidecar_cli_requires_stdio():
    with pytest.raises(SystemExit):
        sidecar.main([])


def test_entry_root_matches_root_host():
    fn, args = entry.entry(device="cpu")
    payloads = [b"change-%02d" % i * (i + 1) for i in range(8)]
    root = merkle.digests_from_device(*fn(*args))[0]
    assert root == merkle.root_host([_h(p) for p in payloads])


def test_entry_on_custom_payloads():
    payloads = [bytes([i]) * (37 * i) for i in range(16)]
    fn, args = entry.entry(device="cpu", payloads=payloads)
    root = merkle.digests_from_device(*fn(*args))[0]
    assert root == merkle.root_host([_h(p) for p in payloads])
