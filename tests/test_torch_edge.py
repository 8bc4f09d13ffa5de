"""The port's event-driven edge against the JAX package's.

The JAX package's twelve cases of ``test_edge.py`` each run against the
JAX ``EdgeLoop`` and the port's over the same wires
(``test_wire_fixtures.SESSION_1``, ``SESSION_4``, broadcast and
reconcile legs): the raw reply bytes, the ``sidecar.session`` records
(peer ports masked), the ``HubBusy`` rejection record, ``snapshot()``
and ``admission_state()`` are equal.  Both loops run their batched pump
arm (the JAX one with ``DAT_PUMP`` unset), the route the port's loop
takes; the port's hubs run B1's plain version on the CPU.

Then the port alone:

* its ``EdgeLoop`` against its threaded ``serve_tcp`` on the same four
  wires: equal records;
* the mixed table: one hub, two broadcast groups, a reconcile leg (2,000
  records a side, k = 20, exact differences against a ``hashlib``
  oracle) and a snapshot leg (a 1 MiB dataset assembled byte-exact),
  every fd in the table non-blocking;
* flush-before-finalize: every digest in submit order even when the
  hub's ``linger_s`` holds the flush past the client's EOF;
* the shed: a client that reads nothing is shed ``parked-budget``
  through the sweep, its neighbours finish byte-exact, and the edge's
  shed count equals the hub's;
* the source claim: a probe gives it back, a hub-rejected claimant gives
  it back at once, a subscriber that sends bytes is refused
  ``not_source``;
* the ``--tcp --edge --device cpu`` sidecar subprocess: 4 concurrent
  clients against ``hashlib``, ``--stats-fd`` records whose ``edge``
  section names the live sessions by class and kind, ``/healthz`` with
  its ``loop_lag`` stage; ``--edge --stdio`` is refused.
"""

import hashlib
import json
import os
import re
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import dat_replication_protocol_tpu as jax_protocol
from dat_replication_protocol_tpu import edge as jax_edge
from dat_replication_protocol_tpu import sidecar as jax_sidecar
from dat_replication_protocol_tpu.fanout import FanoutServer as JaxFanout
from dat_replication_protocol_tpu.hub import ReplicationHub as JaxHub
from dat_replication_protocol_tpu.obs import events as jevents
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.obs import watermarks as jwatermarks
from dat_replication_protocol_tpu.runtime import replay as jreplay
from dat_replication_protocol_tpu.runtime.reconcile_driver import (
    RatelessReplica as JaxReplica, run_initiator as jax_run_initiator)
from dat_replication_protocol_tpu_torch import decode, encode, sidecar
from dat_replication_protocol_tpu_torch.edge import (
    QOS_PRESETS, EdgeLoop, serve_edge)
from dat_replication_protocol_tpu_torch.fanout import FanoutServer
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.obs import events, metrics, wirecost
from dat_replication_protocol_tpu_torch.obs.watermarks import WATERMARKS
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
    RatelessReplica, run_initiator)
from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
    SnapshotSource, run_snapshot_joiner)
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change)

from test_wire_fixtures import CHANGE_PAYLOAD, SESSION_1, SESSION_4

REPO = Path(__file__).resolve().parent.parent
WAIT = 30.0


@pytest.fixture(autouse=True)
def _native_arm(monkeypatch):
    # the JAX loop's batched pump arm: the route the port's loop runs
    monkeypatch.delenv("DAT_PUMP", raising=False)


@pytest.fixture
def both_obs():
    """Both gates on, with clean registries, event rings and boards."""
    state = (metrics.OBS.on, jmetrics.OBS.on)

    def reset():
        for m, e, w in ((metrics, events, WATERMARKS),
                        (jmetrics, jevents, jwatermarks.WATERMARKS)):
            m.REGISTRY.reset()
            e.EVENTS.clear()
            w.reset_for_tests()
        wirecost.WIRECOST.reset_for_tests()

    reset()
    metrics.enable()
    jmetrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on, jmetrics.OBS.on = state
        reset()


JAX = SimpleNamespace(
    name="jax", EdgeLoop=jax_edge.EdgeLoop, decode=jax_protocol.decode,
    hub=lambda **kw: JaxHub(**kw), fanout=lambda **kw: JaxFanout(**kw),
    sidecar=jax_sidecar, EVENTS=jevents.EVENTS, REGISTRY=jmetrics.REGISTRY,
    load_replica=jax_sidecar.load_reconcile_replica,
    replica=lambda src: JaxReplica(src), run_initiator=jax_run_initiator,
    encode_change_log=jreplay.encode_change_log)
PORT = SimpleNamespace(
    name="port", EdgeLoop=EdgeLoop, decode=decode,
    hub=lambda **kw: ReplicationHub(device="cpu", **kw),
    fanout=lambda **kw: FanoutServer(**kw),
    sidecar=sidecar, EVENTS=events.EVENTS, REGISTRY=metrics.REGISTRY,
    load_replica=lambda p: sidecar.load_reconcile_replica(p, device="cpu"),
    replica=lambda src: RatelessReplica(src, device="cpu"),
    run_initiator=run_initiator,
    encode_change_log=replay.encode_change_log)


def _h(p: bytes) -> bytes:
    return hashlib.blake2b(p, digest_size=32).digest()


def _decode_reply(raw: bytes) -> list:
    out = []
    dec = decode()
    dec.change(lambda ch, done: (out.append(ch), done()))
    dec.write(raw)
    dec.end()
    assert dec.finished
    return out


def _recv_all(sock: socket.socket) -> bytes:
    parts = []
    while True:
        try:
            d = sock.recv(65536)
        except OSError:
            return b"".join(parts)
        if not d:
            return b"".join(parts)
        parts.append(d)


_SERVING: list = []  # (loop, thread) of every loop a test started


@pytest.fixture(autouse=True)
def _no_loop_outlives_its_test():
    """A test that fails mid-way leaves its loop serving; stop it, so its
    turns do not land in the next test's telemetry."""
    yield
    while _SERVING:
        loop, t = _SERVING.pop()
        if t.is_alive():
            loop.close()
            t.join(10)


def _start(loop, **kw) -> tuple:
    port = loop.bind("127.0.0.1", 0)
    t = threading.Thread(target=loop.serve, kwargs=kw, daemon=True)
    t.start()
    _SERVING.append((loop, t))
    return port, t


def _mask(v):
    return re.sub(r":\d+$", ":PORT", v) if isinstance(v, str) else v


def _records(impl) -> list:
    """The ``sidecar.session`` records so far, peer ports masked."""
    out = []
    for e in impl.EVENTS.events("sidecar.session"):
        f = dict(e["fields"])
        for k in ("session", "fanout_peer", "peer"):
            if k in f:
                f[k] = _mask(f[k])
        out.append(f)
    return out


def _sorted(recs: list) -> list:
    return sorted(recs, key=lambda r: json.dumps(r, sort_keys=True))


def _session(addr, wire: bytes, timeout: float = 15) -> bytes:
    c = socket.create_connection(addr, timeout=10)
    c.settimeout(timeout)
    c.sendall(wire)
    c.shutdown(socket.SHUT_WR)
    raw = _recv_all(c)
    c.close()
    return raw


def _refused(addr, wire: bytes) -> bytes:
    """A client the loop turns away at admission: it may close before
    the client's bytes or EOF reach it, so a failed send is expected."""
    c = socket.create_connection(addr, timeout=10)
    c.settimeout(15)
    try:
        c.sendall(wire)
        c.shutdown(socket.SHUT_WR)
    except OSError:
        pass
    raw = _recv_all(c)
    c.close()
    return raw


def _wait_for(pred, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


# -- the JAX package's twelve cases, on both ------------------------------------


def _one_session(impl, wire: bytes) -> dict:
    hub = impl.hub(linger_s=0.002)
    loop = impl.EdgeLoop(hub, max_sessions=1)
    try:
        port, t = _start(loop)
        raw = _session(("127.0.0.1", port), wire)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        hub.close()
    return {"reply": raw, "records": _records(impl)}


def test_edge_serves_reference_transcript_session_1(both_obs):
    got, want = _one_session(PORT, SESSION_1), _one_session(JAX, SESSION_1)
    assert got == want
    reply = _decode_reply(got["reply"])
    assert len(reply) == 1
    ch = reply[0]
    assert ch.key == "change-0" and ch.subset == "digest:change"
    assert ch.value == _h(CHANGE_PAYLOAD)
    assert got["records"] == [{"changes": 1, "blobs": 0, "bytes": 20,
                               "digests": 1, "ok": True,
                               "session": "c1:127.0.0.1:PORT",
                               "shed": None}]


def test_edge_blob_and_change_session_4(both_obs):
    got, want = _one_session(PORT, SESSION_4), _one_session(JAX, SESSION_4)
    assert got == want
    by_key = {ch.key: ch for ch in _decode_reply(got["reply"])}
    assert set(by_key) == {"blob-0", "change-0"}
    assert by_key["blob-0"].value == _h(b"hello world")
    assert by_key["blob-0"].subset == "digest:blob"
    assert by_key["change-0"].value == _h(CHANGE_PAYLOAD)


def _protocol_error(impl) -> dict:
    hub = impl.hub(linger_s=0.002)
    loop = impl.EdgeLoop(hub, max_sessions=2)
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        bad = _session(addr, b"\xff" * 64)  # a hostile length varint
        good = _session(addr, SESSION_1)     # the loop lives on
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        hub.close()
    return {"bad": bad, "good": good, "records": _records(impl)}


def test_edge_protocol_error_closes_connection(both_obs):
    got, want = _protocol_error(PORT), _protocol_error(JAX)
    assert got == want
    assert got["bad"] == b""
    reply = _decode_reply(got["good"])
    assert len(reply) == 1 and reply[0].key == "change-0"
    assert got["records"][0]["ok"] is False


def _no_loop(d: dict) -> dict:
    return {k: v for k, v in d.items() if k != "loop"}


def _hub_busy(impl) -> dict:
    hub = impl.hub(max_sessions=1)
    held = hub.register("occupant")
    loop = impl.EdgeLoop(hub, max_sessions=2, name="busy")
    try:
        port, t = _start(loop)
        eof = _refused(("127.0.0.1", port), SESSION_1)
        _wait_for(lambda: loop.admission_state()["rejected"] >= 1,
                  "the rejection")
        snap = _no_loop(loop.snapshot())
        counters = {k: v for k, v in
                    impl.REGISTRY.snapshot()["counters"].items()
                    if k.startswith("edge.") and "{loop=" in k}
        state = loop.admission_state()
        held.close()
        loop.close()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        hub.close()
    return {"eof": eof, "snapshot": snap, "counters": counters,
            "admission": state, "records": _records(impl)}


def test_edge_hub_busy_rejection_is_structured(both_obs):
    got, want = _hub_busy(PORT), _hub_busy(JAX)
    assert got == want
    assert got["eof"] == b""
    assert got["snapshot"]["rejected"] == 1
    assert got["snapshot"]["admitted"] == 0
    assert got["records"][-1] == {
        "changes": 0, "blobs": 0, "bytes": 0, "digests": 0, "ok": False,
        "rejected": True, "sessions": 1, "parked_bytes": 0}
    assert got["counters"] == {"edge.rejected{loop=busy}": 1,
                               "edge.served{loop=busy}": 1,
                               "edge.admitted{loop=busy}": 0,
                               "edge.shed{loop=busy}": 0}
    assert got["admission"]["rejected"] == 1
    assert got["admission"]["shed"] == 0


def _concurrent(impl, n: int = 8) -> dict:
    hub = impl.hub(linger_s=0.002)
    qos_of = lambda n, peer, mode: \
        "latency" if n % 2 else "throughput"  # noqa: E731
    loop = impl.EdgeLoop(hub, qos_of=qos_of, max_sessions=n)
    hold = threading.Event()
    results = {}
    out = {}

    def client(i):
        c = socket.create_connection(("127.0.0.1", port), timeout=10)
        half = len(SESSION_4) // 2
        c.sendall(SESSION_4[:half])
        hold.wait(10)  # every session parked in the table at once
        c.sendall(SESSION_4[half:])
        c.shutdown(socket.SHUT_WR)
        results[i] = _recv_all(c)
        c.close()

    try:
        port, t = _start(loop)
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(n)]
        for th in threads:
            th.start()
        _wait_for(lambda: loop.snapshot()["sessions"] == n, "the cohort")
        snap = loop.snapshot()
        out["snapshot"] = {k: snap[k] for k in ("sessions", "by_class",
                                                "by_kind", "pump_route")}
        gauges = impl.REGISTRY.snapshot()["gauges"]
        out["gauges"] = {k: v for k, v in gauges.items()
                         if k.startswith("edge.sessions")}
        adm = loop.admission_state()
        out["admission"] = (adm["stage"], adm["open"],
                            adm["hub"]["sessions"])
        hold.set()
        for th in threads:
            th.join(15)
            assert not th.is_alive(), "client HANG"
        t.join(timeout=10)
    finally:
        hold.set()
        hub.close()
    out["replies"] = sorted(results.values())
    out["records"] = _sorted(_records(impl))
    return out


def test_edge_concurrent_sessions_one_loop(both_obs):
    n = 8
    got, want = _concurrent(PORT, n), _concurrent(JAX, n)
    assert got == want
    assert got["snapshot"]["by_class"] == {"latency": n // 2,
                                           "throughput": n // 2}
    assert got["snapshot"]["by_kind"] == {"hub": n}
    assert got["gauges"]["edge.sessions"] == float(n)
    assert got["gauges"]["edge.sessions{class=latency}"] == n // 2
    assert got["admission"] == ("edge", True, n)
    for raw in got["replies"]:
        by_key = {ch.key: ch for ch in _decode_reply(raw)}
        assert set(by_key) == {"blob-0", "change-0"}
        assert by_key["blob-0"].value == _h(b"hello world")


def _broadcast(impl) -> dict:
    hub = impl.hub(linger_s=0.002)
    fanout = impl.fanout(stall_timeout=10.0)
    loop = impl.EdgeLoop(hub, fanouts={"main": fanout}, max_sessions=3)
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        src = socket.create_connection(addr, timeout=10)
        half = len(SESSION_4) // 2
        src.sendall(SESSION_4[:half])
        _wait_for(lambda: loop.snapshot()["sessions"] == 1, "the claim")
        sub1 = socket.create_connection(addr, timeout=10)
        _wait_for(lambda: loop.snapshot()["sessions"] == 2, "subscriber 1")
        src.sendall(SESSION_4[half:])
        src.shutdown(socket.SHUT_WR)
        reply = _recv_all(src)
        src.close()
        sub2 = socket.create_connection(addr, timeout=10)  # a late joiner
        got1, got2 = _recv_all(sub1), _recv_all(sub2)
        sub1.close()
        sub2.close()
        t.join(timeout=10)
    finally:
        fanout.close()
        hub.close()
    return {"reply": reply, "subs": (got1, got2),
            "records": _sorted(_records(impl))}


def test_edge_fanout_broadcasts_source_wire_to_subscribers(both_obs):
    got, want = _broadcast(PORT), _broadcast(JAX)
    assert got == want
    assert {ch.key for ch in _decode_reply(got["reply"])} == {"blob-0",
                                                              "change-0"}
    assert got["subs"] == (SESSION_4, SESSION_4)


def _two_groups(impl) -> dict:
    hub = impl.hub(linger_s=0.002)
    f_a = impl.fanout(stall_timeout=10.0)
    f_b = impl.fanout(stall_timeout=10.0)
    group_of = lambda n, peer: "a" if n in (1, 3) else "b"  # noqa: E731
    loop = impl.EdgeLoop(hub, fanouts={"a": f_a, "b": f_b},
                         group_of=group_of, max_sessions=4)
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        socks = []
        for k in range(4):
            socks.append(socket.create_connection(addr, timeout=10))
            _wait_for(lambda k=k: loop.snapshot()["served"] == k + 1,
                      f"connection {k + 1}")
        src_a, src_b, sub_a, sub_b = socks
        src_a.sendall(SESSION_1)
        src_a.shutdown(socket.SHUT_WR)
        src_b.sendall(SESSION_4)
        src_b.shutdown(socket.SHUT_WR)
        out = {"replies": (_recv_all(src_a), _recv_all(src_b)),
               "subs": (_recv_all(sub_a), _recv_all(sub_b))}
        for s in socks:
            s.close()
        t.join(timeout=10)
    finally:
        f_a.close()
        f_b.close()
        hub.close()
    out["records"] = _sorted(_records(impl))
    return out


def test_edge_one_hub_serves_n_broadcast_groups(both_obs):
    got, want = _two_groups(PORT), _two_groups(JAX)
    assert got == want
    assert got["subs"] == (SESSION_1, SESSION_4)
    assert {ch.key for ch in _decode_reply(got["replies"][0])} == {
        "change-0"}
    assert {ch.key for ch in _decode_reply(got["replies"][1])} == {
        "blob-0", "change-0"}


def _log_records(keys) -> list:
    return [{"key": k, "change": i, "from": i, "to": i + 1,
             "value": b"v:" + k.encode()} for i, k in enumerate(keys)]


def _reconcile_leg(impl, tmp_path) -> dict:
    keys = [f"key-{i:05d}" for i in range(200)]
    logfile = tmp_path / f"{impl.name}_srv_log.bin"
    logfile.write_bytes(impl.encode_change_log(
        _log_records(keys + ["srv-only-1", "srv-only-2"])))
    client = impl.replica(impl.encode_change_log(
        _log_records(keys + ["cli-only"])))
    replica = impl.load_replica(str(logfile))
    loop = impl.EdgeLoop(reconcile_replica=replica, max_sessions=2)
    outs = []
    port, t = _start(loop)
    for _ in range(2):  # a second session against the same replica
        c = socket.create_connection(("127.0.0.1", port), timeout=10)
        out = impl.run_initiator(
            client, c.recv, c.sendall,
            close_write=lambda c=c: c.shutdown(socket.SHUT_WR))
        c.close()
        outs.append((out["ok"], out["records_sent"],
                     sorted(ch.key for ch in out["received"])))
    t.join(timeout=10)
    assert not t.is_alive()
    return {"initiator": outs, "records": _records(impl)}


def test_edge_reconcile_leg_exchanges_exact_diff(both_obs, tmp_path):
    got, want = _reconcile_leg(PORT, tmp_path), _reconcile_leg(JAX, tmp_path)
    assert got == want
    assert got["initiator"] == [(True, 1, ["srv-only-1", "srv-only-2"])] * 2
    assert all(r["reconcile"] and r["ok"] for r in got["records"])


def _mixed_modes(impl, tmp_path) -> dict:
    logfile = tmp_path / f"{impl.name}_log.bin"
    logfile.write_bytes(impl.encode_change_log(
        [{"key": "srv-only", "change": 0, "from": 0, "to": 1,
          "value": b"v"}]))
    replica = impl.load_replica(str(logfile))
    client = impl.replica([])
    hub = impl.hub(linger_s=0.002)
    mode_of = lambda n, peer: "hub" if n == 1 else "reconcile"  # noqa: E731
    loop = impl.EdgeLoop(hub, reconcile_replica=replica, mode_of=mode_of,
                         max_sessions=2)
    box = {}
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        hub_c = socket.create_connection(addr, timeout=10)
        half = len(SESSION_4) // 2
        hub_c.sendall(SESSION_4[:half])  # the hub session parks mid-wire
        _wait_for(lambda: loop.snapshot()["served"] == 1, "the hub session")

        def reconcile_leg():
            c = socket.create_connection(addr, timeout=10)
            box["out"] = impl.run_initiator(
                client, c.recv, c.sendall,
                close_write=lambda: c.shutdown(socket.SHUT_WR))
            c.close()

        tr = threading.Thread(target=reconcile_leg, daemon=True)
        tr.start()
        tr.join(15)
        assert not tr.is_alive(), "reconcile starved by the hub session"
        hub_c.sendall(SESSION_4[half:])
        hub_c.shutdown(socket.SHUT_WR)
        reply = _recv_all(hub_c)
        hub_c.close()
        t.join(timeout=10)
    finally:
        hub.close()
    out = box["out"]
    return {"reconcile": (out["ok"], [ch.key for ch in out["received"]]),
            "reply": reply, "records": _sorted(_records(impl))}


def test_edge_mixed_modes_share_one_session_table(both_obs, tmp_path):
    got, want = _mixed_modes(PORT, tmp_path), _mixed_modes(JAX, tmp_path)
    assert got == want
    assert got["reconcile"] == (True, ["srv-only"])
    assert {ch.key for ch in _decode_reply(got["reply"])} == {"blob-0",
                                                              "change-0"}


def test_edge_qos_presets_map_onto_hub_weights():
    assert QOS_PRESETS == jax_edge.QOS_PRESETS
    assert QOS_PRESETS["latency"]["weight"] > \
        QOS_PRESETS["throughput"]["weight"]
    assert QOS_PRESETS["latency"]["recv_cap"] < \
        QOS_PRESETS["throughput"]["recv_cap"]


def test_serve_edge_ready_cb_and_close():
    for impl in (PORT, JAX):
        hub = impl.hub(linger_s=0.002)
        ready = threading.Event()
        box = {}
        loop = impl.EdgeLoop(hub, tick=0.02)
        loop.bind("127.0.0.1", 0)
        t = threading.Thread(
            target=loop.serve,
            kwargs=dict(ready_cb=lambda p: (box.__setitem__("p", p),
                                            ready.set())),
            daemon=True)
        t.start()
        try:
            assert ready.wait(10)
            assert box["p"] == loop.port
            loop.close()
            t.join(10)
            assert not t.is_alive(), f"{impl.name}: close() did not stop"
            if impl is PORT:
                # a close() after the loop ended writes to no stale fd
                assert loop._wake_r == loop._wake_w == -1
                loop.close()
        finally:
            hub.close()
    # serve_edge binds, calls ready_cb and serves max_sessions
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    ready = threading.Event()
    box = {}
    t = threading.Thread(target=serve_edge, args=("127.0.0.1", 0),
                         kwargs=dict(hub=hub, max_sessions=1,
                                     ready_cb=lambda p: (
                                         box.__setitem__("p", p),
                                         ready.set())),
                         daemon=True)
    t.start()
    try:
        assert ready.wait(10)
        raw = _session(("127.0.0.1", box["p"]), SESSION_1)
        t.join(10)
        assert not t.is_alive()
        assert [ch.key for ch in _decode_reply(raw)] == ["change-0"]
    finally:
        hub.close()


def _stats_edge(impl) -> dict:
    hub = impl.hub(linger_s=0.002)
    loop = impl.EdgeLoop(hub, name="stats")
    impl.sidecar.set_active_edge(loop)
    impl.sidecar.set_active_hub(hub)
    try:
        snap = impl.sidecar.snapshot_stats()
        adm = snap["healthz"]["stages"]["admission"]
        return {"edge": snap["edge"], "admission": adm}
    finally:
        impl.sidecar.set_active_hub(None)
        impl.sidecar.set_active_edge(None)
        hub.close()


def test_edge_stats_fd_snapshot_carries_edge_aggregate(both_obs):
    got, want = _stats_edge(PORT), _stats_edge(JAX)
    assert got == want
    assert got["edge"]["sessions"] == 0 and got["edge"]["by_class"] == {}
    assert got["edge"]["pump_route"] == "native"
    assert got["edge"]["loop"]["name"] == "stats"
    assert got["admission"]["stage"] == "edge"
    assert got["admission"]["ok"] is True


# -- the port's edge against its threaded serve_tcp ------------------------------


def _blob_and_change() -> bytes:
    e = encode()
    e.change({"key": "a", "change": 1, "from": 0, "to": 1,
              "value": b"x" * 300})
    e.blob(5000).end(bytes(range(200)) * 25)
    e.change({"key": "b", "change": 2, "from": 1, "to": 2,
              "value": b"y" * 17})
    e.finalize()
    return _drain_encoder(e)


def _drain_encoder(e) -> bytes:
    out = bytearray()
    while (c := e.read(1 << 20)) is not None:
        out += c
    return bytes(out)


# B1's plain version walks an item's blocks one at a time, about 3.5 ms a
# block on the CPU: a 1 MiB blob would take 30 s here, so 64 KiB
BIG_BLOB = 64 << 10


def _big_blob() -> bytes:
    e = encode()
    e.blob(BIG_BLOB).end(np.random.default_rng(7).integers(
        0, 256, BIG_BLOB, dtype=np.uint8).tobytes())
    e.finalize()
    return _drain_encoder(e)


def test_edge_records_equal_the_threaded_serve_tcp(both_obs):
    wires = [SESSION_1, SESSION_4, _blob_and_change(), _big_blob()]
    results = {}
    for how in ("threaded", "edge"):
        events.EVENTS.clear()
        hub = ReplicationHub(device="cpu", linger_s=0.002)
        ready = threading.Event()
        box = {}
        if how == "edge":
            loop = EdgeLoop(hub, max_sessions=len(wires))
            box["p"] = loop.bind("127.0.0.1", 0)
            t = threading.Thread(target=loop.serve, daemon=True)
            _SERVING.append((loop, t))
            ready.set()
        else:
            t = threading.Thread(
                target=sidecar.serve_tcp, args=("127.0.0.1", 0),
                kwargs=dict(max_sessions=len(wires), hub=hub, device="cpu",
                            ready_cb=lambda p: (box.__setitem__("p", p),
                                                ready.set())),
                daemon=True)
        t.start()
        assert ready.wait(10)
        replies = [_session(("127.0.0.1", box["p"]), w) for w in wires]
        _wait_for(lambda: len(events.EVENTS.events("sidecar.session"))
                  == len(wires), "the session records")
        t.join(10)
        hub.close()
        results[how] = (replies, _records(PORT))
    assert results["edge"] == results["threaded"]
    replies, recs = results["edge"]
    assert all(r["ok"] for r in recs)
    big = _decode_reply(replies[3])
    assert [ch.key for ch in big] == ["blob-0"]


# -- the mixed table -------------------------------------------------------------


def _ae_records(lo: int, hi: int) -> list:
    return [{"key": f"r{i:06d}", "change": i, "from": i, "to": i + 1,
             "value": hashlib.sha256(b"%d" % i).digest()[:8 + i % 40]}
            for i in range(lo, hi)]


def _fanout_wire(tag: int) -> bytes:
    e = encode()
    for i in range(30):
        e.change({"key": f"g{tag}-{i}", "change": i, "from": 0, "to": 1,
                  "value": bytes([tag, i]) * 20})
    e.blob(3000 + tag).end(bytes([tag]) * (3000 + tag))
    e.finalize()
    return _drain_encoder(e)


def _fanout_digests(tag: int) -> list:
    return [_h(encode_change({"key": f"g{tag}-{i}", "change": i, "from": 0,
                              "to": 1, "value": bytes([tag, i]) * 20}))
            for i in range(30)] + [_h(bytes([tag]) * (3000 + tag))]


def test_mixed_table_hub_groups_reconcile_and_snapshot(both_obs):
    # the reconcile pair: 1,990 shared records, 10 own on each side
    shared = _ae_records(0, 1990)
    srv_own, cli_own = _ae_records(5000, 5010), _ae_records(9000, 9010)
    replica = RatelessReplica(replay.encode_change_log(shared + srv_own),
                              device="cpu")
    client = RatelessReplica(replay.encode_change_log(shared + cli_own),
                             device="cpu")
    data = np.random.default_rng(13).integers(0, 256, 1 << 20,
                                              dtype=np.uint8)
    source = SnapshotSource(data.tobytes(), device="cpu")
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    fans = {"a": FanoutServer(stall_timeout=10.0),
            "b": FanoutServer(stall_timeout=10.0)}
    modes = {1: "hub", 2: "fanout", 3: "fanout", 4: "fanout", 5: "fanout",
             6: "reconcile", 7: "snapshot"}
    groups = {2: "a", 3: "b", 4: "a", 5: "b"}
    loop = EdgeLoop(hub, fanouts=fans, reconcile_replica=replica,
                    snapshot_source=source,
                    mode_of=lambda n, peer: modes[n],
                    group_of=lambda n, peer: groups[n],
                    qos_of=lambda n, peer, mode: (
                        "latency" if mode == "hub" else "throughput"),
                    max_sessions=len(modes))
    wires = {"hub": SESSION_4, "a": _fanout_wire(1), "b": _fanout_wire(2)}
    want = {"hub": [_h(b"hello world"), _h(CHANGE_PAYLOAD)],
            "a": _fanout_digests(1), "b": _fanout_digests(2)}
    out = {}
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        socks = {}
        for n in range(1, 6):
            socks[n] = socket.create_connection(addr, timeout=10)
            socks[n].settimeout(WAIT)
            if n in (1, 2, 3):
                w = wires["hub" if n == 1 else groups[n]]
                socks[n].sendall(w[:len(w) // 2])  # park mid-wire
            _wait_for(lambda n=n: loop.snapshot()["sessions"] == n,
                      f"connection {n}")
        results = {}

        def reconcile_leg():
            c = socket.create_connection(addr, timeout=10)
            results["reconcile"] = run_initiator(
                client, c.recv, c.sendall,
                close_write=lambda: c.shutdown(socket.SHUT_WR))
            c.close()

        tr = threading.Thread(target=reconcile_leg, daemon=True)
        tr.start()
        _wait_for(lambda: loop.snapshot()["served"] == 6, "the initiator")
        tr.join(WAIT)
        assert not tr.is_alive()
        j = socket.create_connection(addr, timeout=10)
        j.settimeout(WAIT)
        _wait_for(lambda: loop.snapshot()["served"] == 7, "the joiner")
        # every fd in the table is non-blocking (the fan-out's dup shares
        # the open file description, so the subscribers' flags show it)
        table = list(loop._table.values())
        kinds = {s.kind for s in table}
        assert {"hub", "subscriber"} <= kinds
        assert all(not os.get_blocking(s.fd) for s in table)
        out["snapshot"] = {k: v for k, v in loop.snapshot().items()
                           if k in ("by_kind", "by_class")}
        results["snapshot"] = run_snapshot_joiner(
            j.recv, j.sendall, close_write=lambda: j.shutdown(socket.SHUT_WR),
            device="cpu")
        j.close()
        for n in (1, 2, 3):
            w = wires["hub" if n == 1 else groups[n]]
            socks[n].sendall(w[len(w) // 2:])
            socks[n].shutdown(socket.SHUT_WR)
        replies = {n: _recv_all(socks[n]) for n in (1, 2, 3)}
        subs = {n: _recv_all(socks[n]) for n in (4, 5)}
        for s in socks.values():
            s.close()
        t.join(timeout=WAIT)
        assert not t.is_alive()
    finally:
        for f in fans.values():
            f.close()
        hub.close()
    assert out["snapshot"]["by_kind"] in (
        {"hub": 3, "subscriber": 2, "snapshot": 1},
        {"hub": 3, "subscriber": 2, "snapshot": 1, "reconcile": 1})
    # hub and sources: every digest against hashlib, in submit order
    for n, key in ((1, "hub"), (2, "a"), (3, "b")):
        got = [bytes(ch.value) for ch in _decode_reply(replies[n])]
        assert got == want[key], n
    assert subs == {4: wires["a"], 5: wires["b"]}
    # reconcile: exactly the other side's own records, by hashlib digest
    rec = results["reconcile"]
    assert rec["ok"] and rec["records_sent"] == len(cli_own)
    # a record shipped in a ChangeBatch comes back with subset "" for an
    # absent one: the oracle compares the fields the log holds
    got = sorted(_h(encode_change({k: v for k, v in ch.to_dict().items()
                                   if k != "subset"}))
                 for ch in rec["received"])
    assert got == sorted(_h(encode_change(r)) for r in srv_own)
    snap = results["snapshot"]
    assert snap["ok"] and snap["data"] == data.tobytes()
    recs = _records(PORT)
    assert [r for r in recs if r.get("reconcile")] == [{
        "reconcile": True, "ok": True, "symbols": rec["symbols"],
        "rounds": rec["rounds"], "records_sent": len(srv_own),
        "records_received": len(cli_own)}]
    assert [r["ok"] for r in recs if r.get("snapshot")] == [True]
    assert sum(1 for r in recs if r.get("fanout_peer")) == 2
    assert all(r["ok"] for r in recs)


def test_a_reply_longer_than_one_send_turn_completes():
    """A snapshot leg over 1 MiB needs more than one send turn's 8
    encoder pulls: the port's loop keeps ``EVENT_WRITE`` after a turn
    that moved bytes and serves it whole; the JAX package's loop parks
    the reply (no write interest, no read pending) until the peer sends
    again, so its joiner times out."""
    from dat_replication_protocol_tpu.runtime.snapshot_driver import (
        SnapshotSource as JaxSource)
    from dat_replication_protocol_tpu_torch import weights

    data = np.random.default_rng(13).integers(0, 256, 1 << 20,
                                              dtype=np.uint8)
    j = JaxSource(data)
    p = weights.snapshot_source_from_numpy(data, j.offs + j.lens, j.digests,
                                           device="cpu")
    got = {}
    for impl, src, timeout in ((PORT, p, WAIT), (JAX, j, 2.0)):
        loop = impl.EdgeLoop(snapshot_source=src, max_sessions=1)
        port, t = _start(loop)
        sock = socket.create_connection(("127.0.0.1", port), timeout=10)
        sock.settimeout(timeout)
        try:
            got[impl.name] = run_snapshot_joiner(
                sock.recv, sock.sendall,
                close_write=lambda: sock.shutdown(socket.SHUT_WR),
                device="cpu")
        except TimeoutError:
            got[impl.name] = None
        finally:
            sock.close()
            loop.close()
            t.join(10)
    assert got["port"]["ok"] and got["port"]["data"] == data.tobytes()
    assert got["jax"] is None


# -- flush-before-finalize, the shed and the source claim ------------------------


def test_reply_carries_every_digest_when_linger_outlasts_the_eof(both_obs):
    e = encode()
    records = [{"key": f"k{i}", "change": i, "from": 0, "to": 1,
                "value": bytes([i]) * (i + 3)} for i in range(50)]
    for r in records[:25]:
        e.change(r)
    e.blob(777).end(b"\x42" * 777)
    for r in records[25:]:
        e.change(r)
    e.finalize()
    wire = _drain_encoder(e)
    want = ([_h(encode_change(r)) for r in records[:25]]
            + [_h(b"\x42" * 777)]
            + [_h(encode_change(r)) for r in records[25:]])
    # the hub holds a batch open far past the client's EOF
    hub = ReplicationHub(device="cpu", linger_s=0.3, max_batch=1 << 16)
    loop = EdgeLoop(hub, max_sessions=1)
    try:
        port, t = _start(loop)
        raw = _session(("127.0.0.1", port), wire)
        t.join(10)
    finally:
        hub.close()
    reply = _decode_reply(raw)
    assert [bytes(ch.value) for ch in reply] == want
    assert [ch.key for ch in reply] == (
        [f"change-{i}" for i in range(25)] + ["blob-0"]
        + [f"change-{i}" for i in range(25, 50)])
    assert _records(PORT)[-1]["digests"] == 51


def test_a_client_that_reads_nothing_is_shed_and_neighbours_finish(both_obs):
    # windows wider than the budget: only the shed can stop the flood
    hub = ReplicationHub(device="cpu", linger_s=0.002,
                         parked_budget=2 << 20, window_items=1 << 20,
                         window_bytes=1 << 30)
    loop = EdgeLoop(hub, max_sessions=3, drain_timeout=None)
    e = encode()
    for i in range(20_000):  # 1 KB values: each parks 1 KB, replies 80 B
        e.change({"key": f"f{i}", "change": i, "from": 0, "to": 1,
                  "value": i.to_bytes(4, "big") * 250})
    e.finalize()
    flood = _drain_encoder(e)
    try:
        port = loop.bind("127.0.0.1", 0)
        # accepted sockets inherit the listener's small send buffer, so
        # the reply that nobody reads backs up into the encoder at once
        loop._srv.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
        t = threading.Thread(target=loop.serve, daemon=True)
        t.start()
        _SERVING.append((loop, t))
        addr = ("127.0.0.1", port)
        half = len(SESSION_4) // 2
        neighbours = []
        for _ in range(2):
            c = socket.create_connection(addr, timeout=10)
            c.settimeout(WAIT)
            c.sendall(SESSION_4[:half])
            neighbours.append(c)
        _wait_for(lambda: loop.snapshot()["sessions"] == 2, "neighbours")
        v = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        v.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        v.settimeout(WAIT)
        v.connect(addr)

        def flood_it():
            try:
                v.sendall(flood)
            except OSError:
                pass  # torn down once shed

        ft = threading.Thread(target=flood_it, daemon=True)
        ft.start()
        _wait_for(lambda: loop.snapshot()["shed"] == 1, "the shed",
                  timeout=WAIT)
        for c in neighbours:
            c.sendall(SESSION_4[half:])
            c.shutdown(socket.SHUT_WR)
        replies = [_recv_all(c) for c in neighbours]
        for c in neighbours:
            c.close()
        v.close()
        ft.join(WAIT)
        t.join(WAIT)
        assert not t.is_alive()
        hub_shed = metrics.snapshot()["counters"]["hub.shed"]
    finally:
        hub.close()
    for raw in replies:
        by_key = {ch.key: ch for ch in _decode_reply(raw)}
        assert by_key["blob-0"].value == _h(b"hello world")
        assert by_key["change-0"].value == _h(CHANGE_PAYLOAD)
    recs = _records(PORT)
    shed = [r for r in recs if r.get("shed") is not None]
    assert [r["shed"] for r in shed] == ["parked-budget"]
    assert shed[0]["ok"] is False
    assert sum(r["ok"] for r in recs) == 2
    assert loop.snapshot()["shed"] == hub_shed == 1
    reasons = [ev["fields"]["reason"] for ev in events.EVENTS.events(
        "hub.shed")]
    assert reasons == ["parked-budget"]


def test_source_claim_released_refused_and_given_back(both_obs):
    hub = ReplicationHub(device="cpu", linger_s=0.002, max_sessions=1)
    held = hub.register("occupant")
    fanout = FanoutServer(stall_timeout=10.0)
    loop = EdgeLoop(hub, fanouts={"main": fanout}, max_sessions=5)
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        # 1: the claimant the full hub rejects gives the claim back at once
        assert _refused(addr, SESSION_4) == b""
        _wait_for(lambda: loop.snapshot()["rejected"] == 1
                  and loop.snapshot()["served"] == 1, "the rejection")
        _wait_for(lambda: loop._src_claims["main"] is False, "the release")
        assert loop.snapshot()["sessions"] == 0
        held.close()
        # 2: a probe that publishes nothing gives it back at teardown
        probe = socket.create_connection(addr, timeout=10)
        _wait_for(lambda: loop.snapshot()["sessions"] == 1, "the probe")
        assert loop._src_claims["main"] is True
        probe.shutdown(socket.SHUT_WR)
        assert _recv_all(probe) == b""  # no frame, so no reply
        probe.close()
        _wait_for(lambda: loop.snapshot()["sessions"] == 0, "the probe's end")
        assert loop._src_claims["main"] is False
        # 3: the real source claims it
        src = socket.create_connection(addr, timeout=10)
        src.settimeout(WAIT)
        _wait_for(lambda: loop.snapshot()["sessions"] == 1, "the source")
        # 4: a subscriber that sends bytes is a misrouted source: refused
        bad = socket.create_connection(addr, timeout=10)
        bad.settimeout(WAIT)
        _wait_for(lambda: loop.snapshot()["served"] == 4, "the misroute")
        bad.sendall(b"\x01\x02")
        refusal = _recv_all(bad)
        bad.close()
        # 5: a subscriber proper reads the wire
        sub = socket.create_connection(addr, timeout=10)
        _wait_for(lambda: loop.snapshot()["served"] == 5, "the subscriber")
        src.sendall(SESSION_4)
        src.shutdown(socket.SHUT_WR)
        reply = _recv_all(src)
        src.close()
        got = _recv_all(sub)
        sub.close()
        t.join(WAIT)
        assert not t.is_alive()
    finally:
        fanout.close()
        hub.close()
    rec = json.loads(refusal.decode().strip())
    assert rec["not_source"] is True and rec["ok"] is False
    assert got == SESSION_4
    assert {ch.key for ch in _decode_reply(reply)} == {"blob-0", "change-0"}
    recs = _records(PORT)
    assert [r.get("not_source") for r in recs
            if "fanout_peer" in r] == [True, None]


def test_replica_mode_is_refused_at_admission(both_obs):
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    loop = EdgeLoop(hub, mode_of=lambda n, peer: "replica" if n == 1
                    else "hub", max_sessions=2)
    try:
        port, t = _start(loop)
        addr = ("127.0.0.1", port)
        assert _refused(addr, SESSION_1) == b""
        raw = _session(addr, SESSION_1)  # the loop serves on
        t.join(10)
    finally:
        hub.close()
    assert [ch.key for ch in _decode_reply(raw)] == ["change-0"]
    errors = [e["fields"]["error"] for e in events.EVENTS.events(
        "edge.error")]
    assert len(errors) == 1 and "cluster" in errors[0]


# -- the --tcp --edge sidecar subprocess -----------------------------------------


def _stats_lines(fd, buf: bytearray, timeout: float) -> list:
    deadline = time.monotonic() + timeout
    while b"\n" not in buf:
        left = deadline - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            return []
        chunk = os.read(fd, 1 << 16)
        if not chunk:
            return []
        buf += chunk
    *lines, rest = bytes(buf).split(b"\n")
    buf[:] = rest
    return [json.loads(x) for x in lines]


def _kick_until(proc, fd, buf: bytearray, ok) -> dict:
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        proc.send_signal(signal.SIGUSR1)
        for rec in _stats_lines(fd, buf, 2.0):
            if ok(rec):
                return rec
    pytest.fail("no stats record satisfied the check")


def _client_wire(i: int) -> tuple:
    e = encode()
    records = [{"key": f"c{i}-{k}", "change": k, "from": 0, "to": 1,
                "value": bytes([i, k]) * (k + 1)} for k in range(20)]
    for r in records:
        e.change(r)
    e.blob(4096 + i).end(bytes([i]) * (4096 + i))
    e.finalize()
    return (_drain_encoder(e),
            [_h(encode_change(r)) for r in records]
            + [_h(bytes([i]) * (4096 + i))])


def test_tcp_edge_sidecar_subprocess_serves_and_reports():
    r, w = os.pipe()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
         "--tcp", "127.0.0.1:0", "--edge", "--device", "cpu",
         "--stats-fd", str(w), "--stats-interval", "3600",
         "--obs-http", "0"],
        pass_fds=(w,), env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    os.close(w)
    buf = bytearray()
    clients = []
    try:
        url = None
        while True:
            line = proc.stderr.readline()
            assert line, "the sidecar exited before listening"
            if "obs endpoint on" in line:
                url = line.split("obs endpoint on", 1)[1].strip()
            if "edge listening on" in line:
                port = int(line.rsplit(":", 1)[1])
                break
        assert url is not None
        wires = [_client_wire(i) for i in range(4)]
        for wire, _ in wires:
            s = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
            s.settimeout(WAIT)
            s.sendall(wire[:len(wire) // 2])
            clients.append(s)
        rec = _kick_until(proc, r, buf,
                          lambda x: x.get("edge", {}).get("sessions") == 4)
        assert rec["edge"]["by_kind"] == {"hub": 4}
        assert rec["edge"]["by_class"] == {"throughput": 4}
        assert rec["edge"]["pump_route"] == "native"
        assert rec["edge"]["loop"]["name"].startswith("edge:127.0.0.1:")
        assert len(rec["sessions"]) == 4  # the hub's breakdown
        assert rec["healthz"]["stages"]["admission"]["stage"] == "edge"
        with urllib.request.urlopen(url + "/healthz", timeout=WAIT) as resp:
            assert resp.status == 200
            hz = json.loads(resp.read())
        assert "loop_lag" in hz["stages"] and hz["stages"]["loop_lag"]["ok"]
        loops = list(hz["stages"]["loop_lag"]["lag_s"])
        assert loops == [rec["edge"]["loop"]["name"]]
        for s, (wire, _) in zip(clients, wires):
            s.sendall(wire[len(wire) // 2:])
            s.shutdown(socket.SHUT_WR)
        for s, (_, want) in zip(clients, wires):
            got = [bytes(ch.value) for ch in _decode_reply(_recv_all(s))]
            assert got == want
        logs = [proc.stderr.readline() for _ in range(4)]
        assert sum("'ok': True" in x for x in logs) == 4, logs
        rec = _kick_until(proc, r, buf,
                          lambda x: x.get("edge", {}).get("sessions") == 0)
        assert rec["edge"]["served"] == rec["edge"]["admitted"] == 4
        assert rec["edge"]["loop"]["turns"] > 0
        assert rec["metrics"]["counters"]["hub.dispatch.items"] == 4 * 21
        proc.send_signal(signal.SIGINT)
        proc.wait(WAIT)
    finally:
        for s in clients:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        os.close(r)


def test_edge_and_stdio_are_refused(capsys):
    with pytest.raises(SystemExit) as ei:
        sidecar.main(["--stdio", "--edge"])
    assert ei.value.code == 2
    assert "--edge is the event-driven TCP front" in capsys.readouterr().err
