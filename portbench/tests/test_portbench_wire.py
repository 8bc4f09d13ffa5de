"""The benchmark's plain wire writer against the port's host decoder."""

import numpy as np

from portbench.gen import files, seeded
from portbench.gen import wire as wire_gen

SPEC = {"blobs": 5, "blob_bytes": 4096, "changes_per_blob": 3,
        "value_bytes": [40, 200]}


def test_wire_decodes_with_the_port_into_the_same_records():
    import dat_replication_protocol_tpu_torch as protocol

    w = wire_gen.make_session(SPEC, seed=2**31 + 17)
    dec = protocol.decode(backend="host")
    changes, blobs = [], []
    dec.change(lambda c, done: (changes.append(c), done()))
    dec.blob(lambda b, done: b.collect(lambda d: (blobs.append(d), done())))
    ended = []
    dec.finalize(lambda done: (ended.append(True), done()))
    mv = memoryview(w.buf)
    for at in range(0, w.nbytes, 1000):
        dec.write(mv[at:at + 1000])
    dec.end()
    assert ended and dec.finished and not dec.destroyed
    n = SPEC["blobs"] * SPEC["changes_per_blob"]
    assert len(changes) == n and len(blobs) == SPEC["blobs"]
    cs, ce = w.of_kind(wire_gen.KIND_CHANGE)
    for i, c in enumerate(changes):
        assert (c.key, c.change, c.from_, c.to) == (f"row-{i}", i + 1, 0, 1)
        assert 40 <= len(c.value) <= 200
        assert protocol.encode_change(
            {"key": c.key, "change": c.change, "from": c.from_, "to": c.to,
             "value": c.value}) == w.buf[cs[i]:ce[i]].tobytes()
    bs, be = w.of_kind(wire_gen.KIND_BLOB)
    assert [bytes(b) for b in blobs] == [w.buf[s:e].tobytes()
                                         for s, e in zip(bs, be)]


def test_wire_equals_the_port_encoders_wire():
    import dat_replication_protocol_tpu_torch as protocol

    w = wire_gen.make_session(SPEC, seed=5)
    enc = protocol.encode()
    dec_bytes = bytearray()
    dec = protocol.decode(backend="host")
    dec.write = (lambda data, *a: dec_bytes.extend(data) or True)
    protocol.pipe(enc, dec)
    cs, ce = w.of_kind(wire_gen.KIND_CHANGE)
    bs, be = w.of_kind(wire_gen.KIND_BLOB)
    per = SPEC["changes_per_blob"]
    for b in range(SPEC["blobs"]):
        for i in range(b * per, (b + 1) * per):
            c = protocol.decode_change(w.buf[cs[i]:ce[i]].tobytes())
            enc.change({"key": c.key, "change": c.change, "from": c.from_,
                        "to": c.to, "value": c.value})
        enc.blob(SPEC["blob_bytes"]).end(w.buf[bs[b]:be[b]].tobytes())
    enc.finalize()
    assert bytes(dec_bytes) == w.buf.tobytes()


def test_seeded_bytes_do_not_depend_on_the_split(monkeypatch):
    a = seeded.random_bytes(3 << 20 | 5, seed=9, stream=2)
    monkeypatch.setattr(seeded, "PIECE", 1 << 16)
    b = seeded.random_bytes(3 << 20 | 5, seed=9, stream=2)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, seeded.random_bytes(len(a), 10, 2))


def test_every_seed_gets_the_same_file_sizes_in_its_own_order():
    traffic = {"count": 4, "min_bytes": 1000, "max_bytes": 6000}
    sz = files.sizes(traffic)
    assert sz == sorted(sz) and 1000 <= sz[0] and sz[-1] <= 6000
    for seed in (1, 2, -3, 2**40 + 1):
        got = files.make_files(traffic, seed)
        assert sorted(len(f) for f in got) == sz
