"""The port's rateless reconcile driver against the JAX package's.

Numpy-seeded change logs (per-record and ChangeBatch wires) become
replicas in both packages: the port's canonical digests (B1's plain
version on the CPU) must equal the JAX replica's (``hashlib``), and
``reconcile_local`` must give the same differences, symbols, rounds and
metered wire bytes, for n of 2,000 and 20,000 and k in {0, 1, 10, 100}.
Live sessions over a socketpair, port initiator against JAX responder
and JAX initiator against port responder, give the same records; the
reference's failure cases each raise one ``ProtocolError``.  The JAX
side runs its host engine (``engine="host"``), byte-identical to its
device engine.  Every wait is bounded.
"""

import socket
import threading

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import reconcile_driver as J
from dat_replication_protocol_tpu.runtime import replay as jreplay
from dat_replication_protocol_tpu.wire.framing import \
    ProtocolError as JaxProtocolError
from dat_replication_protocol_tpu_torch.runtime import reconcile_driver as P
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.wire import reconcile_codec as rc
from dat_replication_protocol_tpu_torch.wire.framing import (
    TYPE_RECONCILE, ProtocolError, frame, frame_wire_len)

WAIT = 30.0
ERRORS = (ProtocolError, JaxProtocolError)
EXTRA = 100  # rows only in B, at most


def _records(n, seed=11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 120, n)
    buf = rng.bytes(int(lens.sum()))
    ends = np.cumsum(lens)
    return [{"key": f"row-{i:06d}", "change": int(i), "from": int(i % 7),
             "to": int(i + 1),
             "value": None if i % 5 == 0 else buf[e - ln:e],
             "subset": None if i % 3 == 0 else f"s{i % 4}"}
            for i, ln, e in zip(range(n), lens.tolist(), ends.tolist())]


_CACHE = {}


def _wire(records, kind):
    if kind == "record":
        return replay.encode_change_log(records)
    cols, _ = replay.replay_log(replay.encode_change_log(records))
    return replay.encode_batch_frames(cols, 997)


def _pair(n, k, kind):
    """Replicas A (rows [0, n)) and B (A less k // 2 rows, plus k - k // 2
    own), in both packages."""
    key = (n, k, kind)
    if key not in _CACHE:
        rows = _records(n + EXTRA)
        a_rows = rows[:n]
        b_rows = rows[k // 2:n] + rows[n:n + k - k // 2]
        wa, wb = _wire(a_rows, kind), _wire(b_rows, kind)
        if ("A", n, kind) not in _CACHE:
            _CACHE[("A", n, kind)] = (P.RatelessReplica(wa, device="cpu"),
                                      J.RatelessReplica(wa))
        pa, ja = _CACHE[("A", n, kind)]
        _CACHE[key] = (pa, P.RatelessReplica(wb, device="cpu"), ja,
                       J.RatelessReplica(wb))
    return _CACHE[key]


@pytest.mark.parametrize("kind", ["record", "batch"])
@pytest.mark.parametrize("n", [2000, 20000])
@pytest.mark.parametrize("k", [0, 1, 10, 100])
def test_reconcile_local_equals_jax(n, k, kind):
    pa, pb, ja, jb = _pair(n, k, kind)
    assert np.array_equal(pa.digests, ja.digests)
    assert np.array_equal(pb.digests, jb.digests)
    got = P.reconcile_local(pa, pb)
    want = J.reconcile_local(ja, jb, engine="host")
    for f in ("symbols", "rounds", "wire_a2b", "wire_b2a", "wire_bytes"):
        assert got[f] == want[f], f
    for f in ("a_rows", "b_rows"):
        assert np.array_equal(np.sort(got[f]), np.sort(want[f])), f
    assert len(got["a_rows"]) == k // 2 and len(got["b_rows"]) == k - k // 2
    for f in ("a_cols", "b_cols"):
        assert replay.encode_change_columns(got[f]) \
            == jreplay.encode_change_columns(want[f])


def test_replica_sources_agree():
    rows = _records(300)
    wire = replay.encode_change_log(rows)
    cols, _ = replay.replay_log(wire)
    want = J.RatelessReplica(wire).digests
    for source in (wire, np.frombuffer(wire, np.uint8), cols, rows):
        assert np.array_equal(P.RatelessReplica(source, device="cpu").digests,
                              want)


def test_duplicate_records_dedupe_as_jax_does():
    rows = _records(200)
    wire = replay.encode_change_log(rows + rows[:50])
    p, j = P.RatelessReplica(wire, device="cpu"), J.RatelessReplica(wire)
    assert p.n == j.n == 200
    assert np.array_equal(p.digests, j.digests)
    assert np.array_equal(p._digest_rows, j._digest_rows)
    q = np.concatenate([j.digests[::7], np.zeros((2, 32), np.uint8)])
    assert np.array_equal(p.rows_for_digests(q), j.rows_for_digests(q))


def _received(records):
    return sorted((c.key, c.change, c.from_, c.to, c.value or b"",
                   c.subset or "") for c in records)


def _live(initiator, responder, ra, rb, flip=None, cut_after=None):
    s1, s2 = socket.socketpair()
    s1.settimeout(WAIT)
    s2.settimeout(WAIT)
    out = {}

    def serve():
        kw = {"engine": "host"} if responder is J.run_responder else {}
        try:
            out["resp"] = responder(rb, s2.recv, s2.sendall,
                                    lambda: s2.shutdown(socket.SHUT_WR), **kw)
        except ERRORS as e:
            out["resp_err"] = e

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    sent = bytearray()

    def write(data):
        if flip is not None and len(sent) <= flip < len(sent) + len(data):
            data = bytearray(data)
            data[flip - len(sent)] ^= 0x01
            data = bytes(data)
        sent.extend(data)
        if cut_after is not None and len(sent) > cut_after:
            s1.shutdown(socket.SHUT_RDWR)
            raise BrokenPipeError("cut")
        s1.sendall(data)

    kw = {"engine": "host"} if initiator is J.run_initiator else {}
    try:
        out["init"] = initiator(ra, s1.recv, write,
                                lambda: s1.shutdown(socket.SHUT_WR), **kw)
    except ERRORS as e:
        out["init_err"] = e
    t.join(WAIT)
    assert not t.is_alive()
    s1.close()
    s2.close()
    return out


@pytest.mark.parametrize("who", ["port-initiator", "port-responder"])
def test_live_sessions_against_jax_give_the_same_records(who):
    pa, pb, ja, jb = _pair(2000, 100, "record")
    if who == "port-initiator":
        got = _live(P.run_initiator, J.run_responder, pa, jb)
    else:
        got = _live(J.run_initiator, P.run_responder, ja, pb)
    want = _live(J.run_initiator, J.run_responder, ja, jb)
    for side in ("init", "resp"):
        for f in ("ok", "symbols", "rounds", "records_sent"):
            assert got[side][f] == want[side][f], (side, f)
        assert _received(got[side]["received"]) \
            == _received(want[side]["received"])
    local = P.reconcile_local(pa, pb)
    assert got["init"]["records_sent"] == len(local["a_rows"]) == 50


def test_port_against_port_ships_the_metered_bytes():
    pa, pb, _ja, _jb = _pair(2000, 10, "batch")
    counts = {}
    s1, s2 = socket.socketpair()
    s1.settimeout(WAIT)
    s2.settimeout(WAIT)
    res = {}
    t = threading.Thread(target=lambda: res.setdefault("r", P.run_responder(
        pb, s2.recv, s2.sendall, lambda: s2.shutdown(socket.SHUT_WR))),
        daemon=True)
    t.start()

    def rd(n):
        d = s1.recv(n)
        counts["rx"] = counts.get("rx", 0) + len(d)
        return d

    def wr(d):
        counts["tx"] = counts.get("tx", 0) + len(d)
        s1.sendall(d)

    P.run_initiator(pa, rd, wr, lambda: s1.shutdown(socket.SHUT_WR))
    t.join(WAIT)
    s1.close()
    s2.close()
    local = P.reconcile_local(pa, pb)
    assert (counts["tx"], counts["rx"]) == (local["wire_a2b"],
                                            local["wire_b2a"])


@pytest.mark.parametrize("who", ["port-initiator", "port-responder"])
def test_corrupt_symbols_are_one_protocol_error(who):
    pa, pb, ja, jb = _pair(2000, 10, "record")
    # the first SYMBOLS frame's start index: after the BEGIN frame, the
    # SYMBOLS header and its subtype byte
    first = rc.encode_symbols(0, np.zeros((P.DEFAULT_BATCH0, 11), np.uint32))
    at = (len(frame(TYPE_RECONCILE, rc.encode_begin(pa.n)))
          + frame_wire_len(len(first)) - len(first) + 1)
    if who == "port-initiator":
        out = _live(P.run_initiator, J.run_responder, pa, jb, flip=at)
    else:
        out = _live(J.run_initiator, P.run_responder, ja, pb, flip=at)
    assert isinstance(out["init_err"], ERRORS)
    assert isinstance(out["resp_err"], ERRORS)
    assert "init" not in out and "resp" not in out
    assert "starts at 1" in str(out["resp_err"])


@pytest.mark.parametrize("word", [0, 1, 3], ids=["count", "checksum", "sum"])
@pytest.mark.parametrize("who", ["port-initiator", "port-responder"])
def test_a_corrupt_symbol_body_never_yields_a_wrong_record_set(who, word):
    """A bit flipped in the first SYMBOLS frame's first cell (its count,
    checksum or key sum) leaves a cell that never peels: the session ends
    as the JAX pair's does, one ProtocolError a side at the symbol cap,
    and neither side takes a record."""
    pa, pb, ja, jb = _pair(2000, 10, "record")
    first = rc.encode_symbols(0, np.zeros((P.DEFAULT_BATCH0, 11), np.uint32))
    at = (len(frame(TYPE_RECONCILE, rc.encode_begin(pa.n)))
          + frame_wire_len(len(first)) - len(first)
          + len(first) - P.DEFAULT_BATCH0 * rc.SYMBOL_BYTES + 4 * word)
    if who == "port-initiator":
        out = _live(P.run_initiator, J.run_responder, pa, jb, flip=at)
    else:
        out = _live(J.run_initiator, P.run_responder, ja, pb, flip=at)
    want = _live(J.run_initiator, J.run_responder, ja, jb, flip=at)
    assert set(out) == set(want) == {"init_err", "resp_err"}
    for side in ("init_err", "resp_err"):
        assert isinstance(out[side], ERRORS)
        assert str(out[side]) == str(want[side])
    assert "no decode after" in str(out["resp_err"])


def test_a_symbol_budget_past_max_symbols_fails_structured():
    pa, pb, ja, jb = _pair(2000, 100, "record")
    for state, mod in ((P.ResponderState(pb, max_symbols=100), P),
                       (J.ResponderState(jb, engine="host", max_symbols=100),
                        J)):
        syms = (pa if mod is P else ja).coded_symbols(
            *(() if mod is P else ("host",)))
        state.handle(rc.decode_reconcile(rc.encode_begin(pa.n)))
        replies = state.handle(rc.decode_reconcile(
            rc.encode_symbols(0, syms.extend(64))))
        assert rc.decode_reconcile(replies[0]).kind == rc.RC_MORE
        replies = state.handle(rc.decode_reconcile(
            rc.encode_symbols(64, syms.extend(128)[64:])))
        msg = rc.decode_reconcile(replies[0])
        assert msg.kind == rc.RC_FAIL and "no decode after 128" in msg.reason
        with pytest.raises(ERRORS, match="no decode after 128"):
            state.result()


@pytest.mark.parametrize("who", ["port-initiator", "port-responder"])
def test_a_peer_gone_mid_stream_is_one_protocol_error(who):
    pa, pb, ja, jb = _pair(2000, 100, "record")
    if who == "port-initiator":
        out = _live(P.run_initiator, J.run_responder, pa, jb, cut_after=100)
    else:
        out = _live(J.run_initiator, P.run_responder, ja, pb, cut_after=100)
    assert isinstance(out.get("resp_err"), ERRORS)
    assert "ended before decode completed" in str(out["resp_err"])
    assert "resp" not in out


def test_responder_state_refuses_what_jax_refuses():
    _pa, pb, _ja, jb = _pair(2000, 0, "record")
    cases = [[rc.encode_symbols(0, np.zeros((1, 11), np.uint32))],
             [rc.encode_begin(5), rc.encode_begin(5)],
             [rc.encode_begin(5), rc.encode_more(3)]]
    for msgs in cases:
        p = P.ResponderState(pb)
        j = J.ResponderState(jb, engine="host")
        for m in msgs:
            got = p.handle(rc.decode_reconcile(m))
            want = j.handle(rc.decode_reconcile(m))
            assert got == want
        with pytest.raises(ProtocolError) as pe:
            p.result()
        with pytest.raises(JaxProtocolError) as je:
            j.result()
        assert str(pe.value) == str(je.value)
