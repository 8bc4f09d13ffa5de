"""Anti-entropy state carried across with ``weights.py``.

``replica_from_numpy`` and ``snapshot_source_from_numpy`` build the
port's ``RatelessReplica`` and ``SnapshotSource`` from a JAX replica's
columns and digests and a JAX source's arrays, without hashing or
chunking again: the state must round-trip exactly, and a port responder
built from it must answer a JAX initiator or joiner exactly as the JAX
responder does.  Every wait is bounded.
"""

import dataclasses
import socket
import threading

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import reconcile_driver as J
from dat_replication_protocol_tpu.runtime import replay as jreplay
from dat_replication_protocol_tpu.runtime import snapshot_driver as JS
from dat_replication_protocol_tpu_torch import weights
from dat_replication_protocol_tpu_torch.runtime import reconcile_driver as P
from dat_replication_protocol_tpu_torch.runtime import snapshot_driver as PS

WAIT = 30.0


def _records(n, lo=0, seed=8):
    rng = np.random.default_rng(seed)
    return [{"key": f"w{i:05d}", "change": i, "from": i % 3, "to": i + 1,
             "value": None if i % 6 == 0 else rng.bytes(int(
                 rng.integers(0, 90))),
             "subset": None if i % 2 else "sub"} for i in range(lo, lo + n)]


def _jax_replica(records):
    return J.RatelessReplica(jreplay.encode_change_log(records))


@pytest.mark.parametrize("dups", [False, True])
def test_replica_from_numpy_round_trips_a_jax_replica(dups):
    rows = _records(400)
    j = _jax_replica(rows + (rows[:30] if dups else []))
    p = weights.replica_from_numpy(j.cols, j.digests, rows=j._digest_rows,
                                   device="cpu")
    assert np.array_equal(p.digests, j.digests)
    q = np.concatenate([j.digests[::5], np.full((3, 32), 9, np.uint8)])
    assert np.array_equal(p.rows_for_digests(q), j.rows_for_digests(q))
    assert weights.columns_to_numpy(p.cols).keys() \
        == weights.columns_to_numpy(j.cols).keys()
    # per-row digests alone (no rows=): deduplicated here
    if not dups:
        p2 = weights.replica_from_numpy(weights.columns_to_numpy(j.cols),
                                        j.digests, device="cpu")
        assert np.array_equal(p2.digests, j.digests)
    with pytest.raises(ValueError, match="rows="):
        weights.replica_from_numpy(j.cols, j.digests[:-1], device="cpu")


def _reconcile(initiator, ja, responder, rb):
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    out = {}
    kw = {"engine": "host"} if responder is J.run_responder else {}
    t = threading.Thread(target=lambda: out.setdefault("r", responder(
        rb, s2.recv, s2.sendall, lambda: s2.shutdown(socket.SHUT_WR), **kw)),
        daemon=True)
    t.start()
    res = initiator(ja, s1.recv, s1.sendall,
                    lambda: s1.shutdown(socket.SHUT_WR), engine="host")
    t.join(WAIT)
    s1.close()
    s2.close()
    return res, out["r"]


def test_a_port_responder_from_jax_state_answers_as_jax_does():
    rows = _records(800)
    ja = _jax_replica(rows[:780] + _records(15, 9000))
    jb = _jax_replica(rows[20:])
    pb = weights.replica_from_numpy(jb.cols, jb.digests,
                                    rows=jb._digest_rows, device="cpu")
    got_i, got_r = _reconcile(J.run_initiator, ja, P.run_responder, pb)
    want_i, want_r = _reconcile(J.run_initiator, ja, J.run_responder, jb)
    for f in ("ok", "symbols", "rounds", "records_sent"):
        assert got_i[f] == want_i[f] and got_r[f] == want_r[f], f
    key = lambda c: (c.key, c.value or b"", c.subset or "")  # noqa: E731
    assert sorted(map(key, got_i["received"])) \
        == sorted(map(key, want_i["received"]))
    assert sorted(map(key, got_r["received"])) \
        == sorted(map(key, want_r["received"]))


def _jax_source(nbytes=200_000, seed=2, wire_offset=0):
    data = np.random.default_rng(seed).integers(0, 256, nbytes,
                                                dtype=np.uint8)
    return data, JS.SnapshotSource(data, wire_offset=wire_offset)


def test_snapshot_source_from_numpy_round_trips_a_jax_source():
    data, j = _jax_source(wire_offset=42)
    p = weights.snapshot_source_from_numpy(data, j.offs + j.lens, j.digests,
                                           wire_offset=42, device="cpu")
    assert dataclasses.astuple(p.manifest) == dataclasses.astuple(j.manifest)
    assert np.array_equal(p.ranks, j.ranks)
    assert p.done_payload(3) == j.done_payload(3)
    assert p.cold_log().read_from(0) == j.cold_log().read_from(0)
    with pytest.raises(ValueError, match="digests must be"):
        weights.snapshot_source_from_numpy(data, j.offs + j.lens,
                                           j.digests[:-1], device="cpu")


@pytest.mark.parametrize("stale", [False, True])
def test_a_port_snapshot_responder_from_jax_state_serves_a_jax_joiner(stale):
    data, j = _jax_source()
    p = weights.snapshot_source_from_numpy(data, j.offs + j.lens, j.digests,
                                           device="cpu")
    have = None
    if stale:
        have = data.copy()
        have[j.offs[::20]] ^= 0x5A
    results = []
    for responder, src in ((PS.run_snapshot_responder, p),
                           (JS.run_snapshot_responder, j)):
        s1, s2 = socket.socketpair()
        for s in (s1, s2):
            s.settimeout(WAIT)
        t = threading.Thread(target=lambda r=responder, x=src: r(
            x, s2.recv, s2.sendall, lambda: s2.shutdown(socket.SHUT_WR)),
            daemon=True)
        t.start()
        results.append(JS.run_snapshot_joiner(
            s1.recv, s1.sendall, lambda: s1.shutdown(socket.SHUT_WR),
            have=have, engine="host"))
        t.join(WAIT)
        s1.close()
        s2.close()
    got, want = results
    assert got == want and got["data"] == data.tobytes()
