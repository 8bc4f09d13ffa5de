"""The port's TYPE_SNAPSHOT payload codec against the JAX package's.

Every message kind (BEGIN's manifest, weighted SYMBOLS, the three WANT
modes, CHUNKS, DONE with its assembly ranks, FAIL), made from a numpy
seed, must encode to the JAX encoder's bytes and decode, in both
packages, to equal messages; every truncation and a seeded set of bit
flips must give the same outcome in both decoders, and through a
session decoder the same ``ProtocolError``.  Byte-exact throughout.
"""

import numpy as np
import pytest

from dat_replication_protocol_tpu.session.decoder import Decoder as JaxDecoder
from dat_replication_protocol_tpu.wire import snapshot_codec as jsn
from dat_replication_protocol_tpu_torch.session.decoder import Decoder
from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_SNAPSHOT, ProtocolError, frame)


def _rng(seed):
    return np.random.default_rng(seed)


def _manifest(mod, **kw):
    fields = dict(n_positions=1000, n_chunks=990, total_bytes=8 << 20,
                  root=bytes(_rng(1).integers(0, 256, 32, dtype=np.uint8)),
                  wire_offset=123_456, avg_bits=13, min_size=2048,
                  max_size=32768)
    fields.update(kw)
    return mod.SnapshotManifest(**fields)


def _cells(k, seed):
    return _rng(seed).integers(0, 1 << 32, (k, sn.WSYMBOL_WORDS),
                               dtype=np.uint64).astype(np.uint32)


def _digests(k, seed):
    return _rng(seed).integers(0, 256, (k, 32), dtype=np.uint8)


def _chunks(k, seed):
    rng = _rng(seed)
    return [(bytes(_digests(1, seed + i)[0]),
             rng.bytes(int(rng.integers(0, 300))))
            for i in range(k)]


def _ranks(k, seed):
    return _rng(seed).integers(0, 1 << 20, k)


MESSAGES = {
    "begin": lambda m: m.encode_begin(_manifest(m)),
    "begin-empty": lambda m: m.encode_begin(_manifest(
        m, n_positions=0, n_chunks=0, total_bytes=0, wire_offset=0)),
    "symbols-empty": lambda m: m.encode_symbols(0, _cells(0, 2)),
    "symbols-4-at-64": lambda m: m.encode_symbols(64, _cells(4, 3)),
    "want-more": lambda m: m.encode_want_more(512),
    "want-digests": lambda m: m.encode_want_digests(_digests(3, 4)),
    "want-digests-none": lambda m: m.encode_want_digests(_digests(0, 4)),
    "want-all": lambda m: m.encode_want_all(),
    "chunks": lambda m: m.encode_chunks(_chunks(4, 5)),
    "chunks-none": lambda m: m.encode_chunks([]),
    "done": lambda m: m.encode_done(256, _ranks(40, 6)),
    "done-tail": lambda m: m.encode_done(0, tail=m.encode_done_tail(
        _ranks(9, 7))),
    "fail": lambda m: m.encode_fail(3, "chunk digest mismatch — ça"),
}


def _fields(msg) -> tuple:
    arr = lambda a: None if a is None else (a.shape, a.tobytes())  # noqa: E731
    man = None if msg.manifest is None else tuple(
        getattr(msg.manifest, f) for f in (
            "n_positions", "n_chunks", "total_bytes", "root", "wire_offset",
            "avg_bits", "min_size", "max_size"))
    chunks = None if msg.chunks is None else [(bytes(d), bytes(c))
                                              for d, c in msg.chunks]
    return (msg.kind, msg.kind_name, msg.mode_name, man, msg.n, msg.start,
            msg.mode, arr(msg.cells), arr(msg.digests), chunks,
            arr(msg.ranks), msg.reason)


def _outcome(decode, payload):
    try:
        return ("ok", _fields(decode(payload)))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_every_message_encodes_to_the_jax_bytes_and_decodes_alike(name):
    payload = MESSAGES[name](sn)
    assert payload == MESSAGES[name](jsn)
    assert _fields(sn.decode_snapshot(payload)) \
        == _fields(jsn.decode_snapshot(payload))


def test_done_tail_is_the_done_payload_less_its_prefix():
    ranks = _ranks(100, 8)
    assert sn.encode_done(5, ranks) == sn.encode_done(
        5, tail=sn.encode_done_tail(ranks)) == jsn.encode_done(5, ranks)


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_every_truncation_fails_where_jax_fails(name):
    payload = MESSAGES[name](sn)
    for cut in range(len(payload)):
        assert _outcome(sn.decode_snapshot, payload[:cut]) \
            == _outcome(jsn.decode_snapshot, payload[:cut]), cut


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_bit_flips_fail_where_jax_fails(name):
    payload = MESSAGES[name](sn)
    rng = np.random.default_rng(len(payload))
    for at in rng.integers(0, len(payload), 24).tolist() + [0, 1]:
        if at >= len(payload):
            continue
        for bit in (0, 4, 7):
            bad = bytearray(payload)
            bad[at] ^= 1 << bit
            assert _outcome(sn.decode_snapshot, bytes(bad)) \
                == _outcome(jsn.decode_snapshot, bytes(bad)), (at, bit)


def test_encoders_refuse_what_jax_refuses():
    for mod in (sn, jsn):
        with pytest.raises(ValueError, match="root must be"):
            mod.encode_begin(_manifest(mod, root=b"short"))
        with pytest.raises(ValueError, match="avg_bits"):
            mod.encode_begin(_manifest(mod, avg_bits=0))
        with pytest.raises(ValueError, match="cells must be"):
            mod.encode_symbols(0, np.zeros((1, 11), np.uint32))
        with pytest.raises(ValueError, match="chunk digest"):
            mod.encode_chunks([(b"x" * 31, b"")])
        with pytest.raises(ValueError, match="ranks must be"):
            mod.encode_done_tail(np.array([1, -1]))


def test_a_byzantine_rank_count_fails_before_allocating():
    # a DONE claiming 2^40 positions in a few bytes fails structured
    payload = bytes((sn.SN_DONE, 0)) + b"\x80\x80\x80\x80\x80\x20" + b"\x01"
    assert _outcome(sn.decode_snapshot, payload) \
        == _outcome(jsn.decode_snapshot, payload)
    assert _outcome(sn.decode_snapshot, payload)[0] == "error"


def _session_error(dec_cls, wire):
    dec = dec_cls()
    errs = []
    dec.snapshot(lambda msg, done: done())
    dec.on_error(errs.append)
    dec.write(wire)
    return errs


@pytest.mark.parametrize("name", ["begin", "chunks", "done", "want-digests"])
def test_a_torn_payload_is_one_protocol_error_in_both_decoders(name):
    payload = MESSAGES[name](sn)
    good = frame(TYPE_SNAPSHOT, MESSAGES["want-all"](sn))
    for cut in (1, len(payload) // 2, len(payload) - 1):
        wire = good + frame(TYPE_SNAPSHOT, payload[:cut])
        got = _session_error(Decoder, wire)
        want = _session_error(JaxDecoder, wire)
        assert len(got) == len(want) == 1
        assert isinstance(got[0], ProtocolError)
        assert (got[0].frame, got[0].offset) == (want[0].frame,
                                                  want[0].offset)
        assert str(got[0]) == str(want[0])
