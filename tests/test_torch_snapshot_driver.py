"""The port's snapshot driver against the JAX package's.

Datasets of 64 KiB to 4 MiB made from a numpy seed are materialized by
both packages (the port's ``content_digests`` runs B6's and B1's plain
versions on the CPU): the manifest, assembly ranks, unique set, DONE
payload and cold-log bytes must be equal; ``snapshot_local`` for cold,
2%-stale and identical joiners must give the same chunks, symbols and
wire bytes; live sessions port against JAX, both ways, assemble the
same dataset; torn and flipped frames and a WANT naming an unknown
chunk each give one ``ProtocolError`` and no dataset.  The JAX side runs
its host engine.  Every wait is bounded.
"""

import dataclasses
import socket
import threading

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import snapshot_driver as J
from dat_replication_protocol_tpu.wire.framing import \
    ProtocolError as JaxProtocolError
from dat_replication_protocol_tpu_torch.runtime import snapshot_driver as P
from dat_replication_protocol_tpu_torch.wire import snapshot_codec as sn
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_SNAPSHOT, ProtocolError, iter_frames)

WAIT = 30.0
ERRORS = (ProtocolError, JaxProtocolError)
SIZES = [64 << 10, 256 << 10, 1 << 20, 4 << 20]
_CACHE = {}


def _data(nbytes, seed=5):
    return np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)


def _sources(nbytes):
    if nbytes not in _CACHE:
        data = _data(nbytes)
        _CACHE[nbytes] = (data, P.SnapshotSource(data, device="cpu"),
                          J.SnapshotSource(data, wire_offset=0))
    return _CACHE[nbytes]


def _stale(data, src, share=0.02, seed=9):
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(src.offs), size=max(1, int(len(src.offs) * share)),
                      replace=False)
    have = data.copy()
    have[src.offs[pick]] ^= 0x5A
    return have


@pytest.mark.parametrize("nbytes", SIZES)
def test_source_state_equals_jax(nbytes):
    _data_, p, j = _sources(nbytes)
    assert dataclasses.astuple(p.manifest) == dataclasses.astuple(j.manifest)
    for f in ("offs", "lens", "digests", "ranks", "uniq_digests",
              "uniq_offs", "uniq_lens"):
        assert np.array_equal(getattr(p, f), getattr(j, f)), f
    assert p.done_payload(17) == j.done_payload(17)
    pl, jl = p.cold_log(), j.cold_log()
    assert (pl.start, pl.end, pl.sealed) == (jl.start, jl.end, jl.sealed)
    assert pl.read_from(pl.start) == jl.read_from(jl.start)
    # the weighted symbol prefix is the same cells
    assert np.array_equal(p.weighted_symbols().extend(64),
                          j.weighted_symbols().extend(64))


def test_a_source_with_repeated_chunks_ranks_positions_as_jax_does():
    block = _data(40 << 10, seed=3)
    data = np.concatenate([block, block, _data(9 << 10, seed=4), block])
    p, j = P.SnapshotSource(data, device="cpu"), J.SnapshotSource(data)
    assert p.manifest.n_chunks < p.manifest.n_positions
    assert np.array_equal(p.ranks, j.ranks)
    assert p.cold_log().read_from(0) == j.cold_log().read_from(0)


@pytest.mark.parametrize("joiner", ["cold", "stale", "identical"])
def test_snapshot_local_equals_jax(joiner):
    data, p, j = _sources(1 << 20)
    have = {"cold": None, "stale": _stale(data, p),
            "identical": data}[joiner]
    got = P.snapshot_local(p, have, device="cpu")
    want = J.snapshot_local(j, have, engine="host")
    assert got["data"] == want["data"] == data.tobytes()
    for f in ("wire_s2j", "wire_j2s", "wire_bytes", "chunks_sent", "cold",
              "responder_symbols", "symbols", "rounds", "chunks_received",
              "chunks_reused", "bytes_received", "wire_offset"):
        assert got[f] == want[f], f
    if joiner == "stale":
        assert got["wire_bytes"] < 0.1 * len(data)


def _serve(responder, src, sock):
    out = {}

    def run():
        try:
            out["resp"] = responder(src, sock.recv, sock.sendall,
                                    lambda: sock.shutdown(socket.SHUT_WR))
        except ERRORS as e:
            out["resp_err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, out


def _join(joiner, sock, have, read=None, write=None):
    kw = {"device": "cpu"} if joiner is P.run_snapshot_joiner \
        else {"engine": "host"}
    try:
        return joiner(read or sock.recv, write or sock.sendall,
                      lambda: sock.shutdown(socket.SHUT_WR), have=have, **kw)
    except ERRORS as e:
        return e


def _live(responder, src, joiner, have, **io):
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    t, out = _serve(responder, src, s2)
    res = _join(joiner, s1, have, **io)
    if isinstance(res, ERRORS):
        s1.close()
    t.join(WAIT)
    assert not t.is_alive()
    s1.close()
    s2.close()
    return res, out


@pytest.mark.parametrize("who", ["port-responder", "port-joiner"])
@pytest.mark.parametrize("joiner", ["cold", "stale"])
def test_live_sessions_against_jax_assemble_the_dataset(who, joiner):
    data, p, j = _sources(1 << 20)
    have = None if joiner == "cold" else _stale(data, p)
    if who == "port-responder":
        res, out = _live(P.run_snapshot_responder, p, J.run_snapshot_joiner,
                         have)
    else:
        res, out = _live(J.run_snapshot_responder, j, P.run_snapshot_joiner,
                         have)
    want = J.snapshot_local(j, have, engine="host")
    assert res["data"] == data.tobytes()
    for f in ("chunks_received", "chunks_reused", "bytes_received",
              "symbols", "rounds"):
        assert res[f] == want[f], f
    assert out["resp"]["ok"] and out["resp"]["cold"] == (joiner == "cold")


def _first_chunks_frame(src):
    raw = src.cold_log().read_from(0)
    for start, tid, p0, end in iter_frames(raw):
        if tid == TYPE_SNAPSHOT and raw[p0] == sn.SN_CHUNKS:
            return start, p0, end
    raise AssertionError("no CHUNKS frame")


@pytest.mark.parametrize("who", ["port-responder", "port-joiner"])
def test_a_stream_torn_mid_chunks_is_one_protocol_error(who):
    data, p, j = _sources(256 << 10)
    begin = len(sn.encode_begin(p.manifest)) + 2
    start, p0, end = _first_chunks_frame(p)
    cut = begin + (p0 + end) // 2
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    got = bytearray()

    def read(n):
        left = cut - len(got)
        if left <= 0:
            return b""
        d = s1.recv(min(n, left))
        got.extend(d)
        return d

    resp, joiner, src = ((P.run_snapshot_responder, J.run_snapshot_joiner, p)
                         if who == "port-responder" else
                         (J.run_snapshot_responder, P.run_snapshot_joiner, j))
    t, _out = _serve(resp, src, s2)
    res = _join(joiner, s1, None, read=read)
    s1.close()
    t.join(WAIT)
    s2.close()
    assert not t.is_alive()
    assert isinstance(res, ERRORS)
    assert "ended before assembly" in str(res)


@pytest.mark.parametrize("where", ["chunk-body", "chunk-digest"])
def test_a_flipped_chunk_fails_verification_and_assembles_nothing(where):
    data, p, _j = _sources(256 << 10)
    _start, p0, _end = _first_chunks_frame(p)
    # BEGIN frame, then the CHUNKS payload: subtype, count varint, the
    # first chunk's digest, its length varint, its bytes
    begin = len(sn.encode_begin(p.manifest)) + 2
    count_len = len(sn.encode_chunks([])) - 1
    off = begin + p0 + 1 + count_len + (40 if where == "chunk-body" else 3)
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    got = bytearray()

    def read(n):
        d = bytearray(s1.recv(n))
        if len(got) <= off < len(got) + len(d):
            d[off - len(got)] ^= 0x10
        got.extend(d)
        return bytes(d)

    t, out = _serve(P.run_snapshot_responder, p, s2)
    res = _join(P.run_snapshot_joiner, s1, None, read=read)
    s1.close()
    t.join(WAIT)
    s2.close()
    assert isinstance(res, ProtocolError)
    assert "chunk digest mismatch at chunk 0" in str(res)


def test_a_want_naming_an_unknown_chunk_is_one_protocol_error():
    data, p, j = _sources(64 << 10)
    for resp_cls, src in ((P.SnapshotResponder, p),
                          (J.SnapshotResponder, j)):
        resp = resp_cls(src)
        resp.begin_payloads()
        bogus = np.full((1, 32), 7, np.uint8)
        replies = resp.handle(sn.decode_snapshot(sn.encode_want_digests(
            np.concatenate([src.uniq_digests[:2], bogus]))))
        msg = sn.decode_snapshot(replies[-1])
        assert msg.kind == sn.SN_FAIL and "outside the manifest" in msg.reason
        assert isinstance(resp.failed, ERRORS)
    # over the wire: the joiner receives the FAIL and raises once
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    t, out = _serve(P.run_snapshot_responder, p, s2)
    enc_bogus = sn.encode_want_digests(np.full((1, 32), 7, np.uint8))
    from dat_replication_protocol_tpu_torch.session.decoder import Decoder
    from dat_replication_protocol_tpu_torch.session.encoder import Encoder
    from dat_replication_protocol_tpu_torch.session.transport import (
        recv_over, send_over)
    from dat_replication_protocol_tpu_torch.wire.framing import CAP_SNAPSHOT

    enc, dec = Encoder(peer_caps=CAP_SNAPSHOT), Decoder()
    kinds = []
    dec.snapshot(lambda m, done: (kinds.append(m.kind), done()))
    enc.snapshot_frame(enc_bogus)
    enc.finalize()
    send_over(enc, s1.sendall, lambda: s1.shutdown(socket.SHUT_WR))
    recv_over(dec, s1.recv)
    t.join(WAIT)
    s1.close()
    s2.close()
    assert kinds == [sn.SN_BEGIN, sn.SN_FAIL]
    assert isinstance(out["resp_err"], ProtocolError)


def test_the_joiner_core_refuses_what_jax_refuses():
    data, p, j = _sources(64 << 10)
    man = sn.encode_begin(p.manifest)
    for msgs in ([sn.encode_chunks([])],
                 [man, man],
                 [man, sn.encode_want_all()],
                 [sn.encode_done(0, np.arange(3))]):
        pj, jj = P.SnapshotJoiner(device="cpu"), J.SnapshotJoiner(
            engine="host")
        for m in msgs:
            assert pj.handle(sn.decode_snapshot(m)) \
                == jj.handle(sn.decode_snapshot(m))
        with pytest.raises(ProtocolError) as pe:
            pj.result()
        with pytest.raises(JaxProtocolError) as je:
            jj.result()
        assert str(pe.value) == str(je.value)


def test_symbol_cap_and_the_responder_budget_match_jax():
    for n in (0, 10, 1000, 1 << 20):
        assert P.symbol_cap(n) == J.symbol_cap(n)
    data, p, j = _sources(64 << 10)
    for resp in (P.SnapshotResponder(p, chunk_budget=100),
                 J.SnapshotResponder(j, chunk_budget=100)):
        replies = resp.handle(sn.decode_snapshot(sn.encode_want_all()))
        assert sn.decode_snapshot(replies[0]).kind == sn.SN_FAIL
