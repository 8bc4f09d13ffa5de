"""Telemetry of the anti-entropy path, the port's against the JAX
package's, on the CPU.

The same seeded live reconcile session (initiator and responder in one
process over a socketpair) and the same snapshot exchanges run with each
package's obs gate on: the reconcile, snapshot, frame and transport
counters and gauges of the reference's catalog must be equal, the
``reconcile.decoded`` and ``snapshot.assembled`` events alike, and the
source's materialize must be a ``snapshot.materialize`` span.  With the
gate off nothing is recorded.
"""

import socket
import threading

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import events as jevents
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.obs import tracing as jtracing
from dat_replication_protocol_tpu.runtime import reconcile_driver as J
from dat_replication_protocol_tpu.runtime import snapshot_driver as JS
from dat_replication_protocol_tpu_torch.obs import events, metrics, tracing
from dat_replication_protocol_tpu_torch.runtime import reconcile_driver as P
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.runtime import snapshot_driver as PS

WAIT = 30.0
RECONCILE_COUNTERS = ("reconcile.rounds", "reconcile.records",
                      "reconcile.frames", "reconcile.wire_bytes",
                      "decoder.reconcile.frames", "decoder.batch.frames",
                      "wire.batch.frames", "wire.batch.rows")
RECONCILE_GAUGES = ("reconcile.symbols.seen", "reconcile.decoded.diff")
SNAPSHOT_COUNTERS = ("snapshot.sessions", "snapshot.chunks.sent",
                     "snapshot.chunks.sent_bytes", "snapshot.cold.bytes",
                     "snapshot.chunks.verified", "snapshot.chunks.reused",
                     "snapshot.chunks.duplicate")
SNAPSHOT_GAUGES = ("snapshot.symbols.seen", "snapshot.decoded.missing")


@pytest.fixture
def both_obs():
    state = (metrics.OBS.on, jmetrics.OBS.on)

    def reset():
        for m, e, t in ((metrics, events, tracing),
                        (jmetrics, jevents, jtracing)):
            m.REGISTRY.reset()
            e.EVENTS.clear()
            t.SPANS.clear()

    reset()
    metrics.enable()
    jmetrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on, jmetrics.OBS.on = state
        reset()


def _records(n, lo=0, seed=21):
    rng = np.random.default_rng(seed)
    return [{"key": f"o{i:05d}", "change": i, "from": 0, "to": i + 1,
             "value": rng.bytes(int(rng.integers(1, 80))),
             "subset": f"s{i % 3}"} for i in range(lo, lo + n)]


def _session(initiator, responder, ra, rb, kw):
    s1, s2 = socket.socketpair()
    for s in (s1, s2):
        s.settimeout(WAIT)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault("r", responder(
        rb, s2.recv, s2.sendall, lambda: s2.shutdown(socket.SHUT_WR), **kw)),
        daemon=True)
    t.start()
    res = initiator(ra, s1.recv, s1.sendall,
                    lambda: s1.shutdown(socket.SHUT_WR), **kw)
    t.join(WAIT)
    s1.close()
    s2.close()
    return res, out["r"]


def _pick(snap, counters, gauges):
    return ({k: snap["counters"].get(k, 0) for k in counters},
            {k: snap["gauges"].get(k, 0) for k in gauges})


def test_a_live_reconcile_counts_as_jax_counts(both_obs):
    rows = _records(3000)
    wa = replay.encode_change_log(rows[:2950] + _records(40, 9000))
    wb = replay.encode_change_log(rows[60:])
    _session(P.run_initiator, P.run_responder,
             P.RatelessReplica(wa, device="cpu"),
             P.RatelessReplica(wb, device="cpu"), {})
    _session(J.run_initiator, J.run_responder, J.RatelessReplica(wa),
             J.RatelessReplica(wb), {"engine": "host"})
    got = _pick(metrics.snapshot(), RECONCILE_COUNTERS, RECONCILE_GAUGES)
    want = _pick(jmetrics.snapshot(), RECONCILE_COUNTERS, RECONCILE_GAUGES)
    assert got == want
    # A holds rows [0, 2950) and 40 own, B rows [60, 3000): A ships 100,
    # B ships 50, and B counts the 100 it receives
    assert got[0]["reconcile.records"] == 100 + 50 + 100
    assert got[1]["reconcile.decoded.diff"] == 150
    (p,), (j,) = (events.EVENTS.events("reconcile.decoded"),
                  jevents.EVENTS.events("reconcile.decoded"))
    assert p["fields"] == j["fields"]
    wakes = metrics.snapshot()["counters"]
    assert all(wakes.get(f"transport.{d}.wake.{w}", 0) >= 0
               for d in ("send", "recv") for w in ("event", "poll"))
    assert any(r.get("span") == "reconcile.digest"
               for r in tracing.SPANS.events())


def test_snapshot_exchanges_count_as_jax_counts(both_obs):
    data = np.random.default_rng(6).integers(0, 256, 400_000,
                                             dtype=np.uint8)
    p, j = PS.SnapshotSource(data, device="cpu"), JS.SnapshotSource(data)
    assert any(r.get("span") == "snapshot.materialize"
               for r in tracing.SPANS.events())
    have = data.copy()
    have[p.offs[::15]] ^= 0x5A
    for h in (None, have, data):
        PS.snapshot_local(p, h, device="cpu")
        JS.snapshot_local(j, h, engine="host")
    got = _pick(metrics.snapshot(), SNAPSHOT_COUNTERS, SNAPSHOT_GAUGES)
    want = _pick(jmetrics.snapshot(), SNAPSHOT_COUNTERS, SNAPSHOT_GAUGES)
    assert got == want
    assert got[0]["snapshot.sessions"] == 3
    for name in ("snapshot.begin", "snapshot.done", "snapshot.assembled",
                 "snapshot.decoded"):
        assert [e["fields"] for e in events.EVENTS.events(name)] \
            == [e["fields"] for e in jevents.EVENTS.events(name)], name


def test_the_gate_off_records_nothing():
    was = metrics.OBS.on
    metrics.OBS.on = False
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    try:
        rows = _records(300)
        a = P.RatelessReplica(replay.encode_change_log(rows[:290]),
                              device="cpu")
        b = P.RatelessReplica(replay.encode_change_log(rows[5:]),
                              device="cpu")
        _session(P.run_initiator, P.run_responder, a, b, {})
        PS.snapshot_local(np.zeros(30_000, np.uint8), None, device="cpu")
        snap = metrics.snapshot()
        assert not any(snap["counters"].values())
        assert events.EVENTS.events() == []
    finally:
        metrics.OBS.on = was
