"""The port's resume layer against the JAX package's.

* ``WireJournal``: the same seeded sequence of ``append``, ``seek``,
  ``attach_reader``, ``detach_reader``, ``ack`` and ``read_from`` gives
  the same bytes, ``start``, ``end`` and ``ResumeError`` cases in both.
* ``Encoder.attach_journal``: both encoders' journals hold the same
  bytes, at the same absolute offsets, for a session of changes, a
  negotiated ``ChangeBatch`` run and blobs, including an attach after
  the first ``read``.
* ``Decoder.checkpoint``: at every write boundary of that wire, with
  writes of 1, 7 and all bytes, the port decoder's checkpoint equals the
  JAX ``Decoder``'s (its streaming scanner: ``DAT_NATIVE_DISABLE=1``) in
  ``wire_offset``, ``frame``, ``row`` and ``blob_offset``; the port
  ``CudaDecoder``'s ``digest`` field counts the digests owed so far.
"""

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.session import resume as jresume
from dat_replication_protocol_tpu_torch.backend.cuda_backend import (
    DigestPipeline,
)
from dat_replication_protocol_tpu_torch.session import resume as presume

PACKAGES = {"port": (protocol, presume), "jax": (jax_protocol, jresume)}


def _journal_script(mod, seed: int) -> list:
    rng = np.random.default_rng(seed)
    j = mod.WireJournal()
    trace = []
    readers = []
    if rng.integers(0, 2):
        j.seek(int(rng.integers(0, 1000)))
        trace.append(("seek", j.start, j.end))
    for step in range(120):
        op = int(rng.integers(0, 7))
        try:
            if op <= 1:
                j.append(rng.bytes(int(rng.integers(0, 300))))
                trace.append(("append", j.start, j.end))
            elif op == 2:
                key = f"r{step}"
                off = (None if rng.integers(0, 3) == 0
                       else int(rng.integers(j.start - 20, j.end + 20)))
                j.attach_reader(key, off)
                readers.append(key)
                trace.append(("attach", key, off))
            elif op == 3 and readers:
                key = readers[int(rng.integers(0, len(readers)))]
                if rng.integers(0, 2):
                    j.detach_reader(key)
                    readers.remove(key)
                    trace.append(("detach", key, j.start))
                else:
                    off = int(rng.integers(j.start, j.end + 2))
                    j.ack(off, reader=key)
                    trace.append(("ack-reader", key, off, j.start))
            elif op == 4:
                off = int(rng.integers(j.start - 5, j.end + 2))
                j.ack(off)
                trace.append(("ack", off, j.start))
            elif op == 5:
                off = int(rng.integers(j.start - 10, j.end + 10))
                trace.append(("read", off, j.read_from(off)))
            else:
                j.seek(5)
                trace.append(("seek", j.start))
        except Exception as e:  # noqa: BLE001 — the error IS the trace
            trace.append(("error", type(e).__name__, str(e),
                          getattr(e, "offset", None)))
        trace.append(("state", j.start, j.end, len(j)))
    return trace


@pytest.mark.parametrize("seed", range(12))
def test_journal_sequences_match(seed):
    got = _journal_script(presume, seed)
    assert got == _journal_script(jresume, seed)
    kinds = {t[1] for t in got if t[0] == "error"}
    assert "ResumeError" in kinds or seed % 3  # refusals are exercised


def test_journal_refusals_are_structured():
    for mod in (presume, jresume):
        j = mod.WireJournal()
        j.append(b"x" * 100)
        j.ack(60)
        with pytest.raises(mod.ResumeError, match=r"\[60, 100\)") as e:
            j.read_from(10)
        assert e.value.offset == 10
        with pytest.raises(mod.ResumeError, match="ahead of everything"):
            j.read_from(101)
        with pytest.raises(ValueError, match="beyond journal end"):
            j.ack(101)
        with pytest.raises(ValueError, match="non-empty"):
            j.seek(0)
    assert issubclass(presume.ResumeError, protocol.ProtocolError)


def _records(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"key": f"k-{i:05d}", "change": i, "from": i, "to": i + 1,
             "value": rng.bytes(int(rng.integers(0, 60))) if i % 4 else None,
             "subset": "s" if i % 3 else None} for i in range(n)]


def _session(p, journal_mod, attach_after_first_read: bool):
    """Changes, a negotiated batch run and blobs, read out in 1,000-byte
    pieces; returns (the pieces read, the journal)."""
    recs = _records(120, 3)
    e = p.encode(peer_caps=p.CAP_CHANGE_BATCH)
    j = journal_mod.WireJournal()
    if not attach_after_first_read:
        e.attach_journal(j)
    for r in recs[:30]:
        e.change(r)
    first = e.read(1000)
    if attach_after_first_read:
        e.attach_journal(j)
    e.change_many(recs[30:90])
    b = e.blob(3000)
    e.change(recs[90])  # parked behind the open blob
    b.write(b"a" * 1000)
    b.end(b"b" * 2000)
    e.blob(5).end(b"tail!")
    for r in recs[91:]:
        e.change(r)
    e.finalize()
    pieces = [first]
    while (c := e.read(1000)) is not None:
        pieces.append(c)
    return b"".join(pieces), j


@pytest.mark.parametrize("late", [False, True], ids=["attach-first",
                                                     "attach-after-read"])
def test_attach_journal_matches_jax(late):
    wire, pj = _session(protocol, presume, late)
    jwire, jj = _session(jax_protocol, jresume, late)
    assert wire == jwire
    assert (pj.start, pj.end) == (jj.start, jj.end)
    assert pj.end == len(wire)
    assert pj.read_from(pj.start) == jj.read_from(jj.start)
    assert pj.read_from(pj.start) == wire[pj.start:]
    assert (pj.start > 0) == late


def test_attach_journal_after_read_needs_a_seekable_journal():
    for p in (protocol, jax_protocol):
        e = p.encode()
        e.change({"key": "k", "change": 1, "from": 0, "to": 1})
        e.read()
        with pytest.raises(RuntimeError, match="cannot seek"):
            e.attach_journal(type("Sink", (), {"append": lambda s, d: None})())


def _checkpoints(dec, wire: bytes, size: int) -> list:
    out = []
    for i in range(0, len(wire), size):
        dec.write(wire[i:i + size])
        out.append(dec.checkpoint().as_dict())
    dec.end()
    out.append(dec.checkpoint().as_dict())
    assert dec.finished and not dec.destroyed
    return out


FIELDS = ("wire_offset", "frame", "row", "blob_offset")


@pytest.mark.parametrize("size", [1, 7, None], ids=["1", "7", "whole"])
def test_checkpoints_match_jax_at_every_write(size, monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    wire, _ = _session(protocol, presume, False)
    size = size or len(wire)
    dec = protocol.decode()
    jdec = jax_protocol.decode()
    for d in (dec, jdec):
        d.change(lambda c, done: done())
        d.change_batch(lambda cols, done: done())
    got = _checkpoints(dec, wire, size)
    want = _checkpoints(jdec, wire, size)
    assert [{k: c[k] for k in FIELDS} for c in got] == \
        [{k: c[k] for k in FIELDS} for c in want]
    assert got[-1]["wire_offset"] == len(wire)
    assert all(c["digest"] == {} for c in got)
    assert any(c["blob_offset"] for c in got) == (size < 3000)


@pytest.mark.parametrize("size", [1, 7, None], ids=["1", "7", "whole"])
def test_cuda_decoder_checkpoint_digest_counts_owed_digests(size):
    wire, _ = _session(protocol, presume, False)
    size = size or len(wire)
    pipe = DigestPipeline(device="cpu", max_batch=1, max_inflight=1)
    dec = protocol.decode(backend="cuda", pipeline=pipe)
    emitted = {"change": 0, "blob": 0}
    dec.on_digest(lambda kind, seq, d: emitted.__setitem__(
        kind, emitted[kind] + 1))
    for i in range(0, len(wire), size):
        dec.write(wire[i:i + size])
        ck = dec.checkpoint()
        pipe.flush()
        open_blob = dec._current_blob is not None
        assert ck.digest == {"change_seq": emitted["change"],
                             "blob_seq": emitted["blob"] + open_blob}
        assert ck.digest["change_seq"] == ck.row
    dec.end()
    assert dec.checkpoint().digest == {"change_seq": 120, "blob_seq": 2}
    assert emitted == {"change": 120, "blob": 2}
