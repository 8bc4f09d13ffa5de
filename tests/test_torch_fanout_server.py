"""The port's fan-out server: the JAX package's server cases on the
port, and the port held against the JAX ``FanoutServer`` (its
``os.writev`` route, ``DAT_PUMP=python``) driven by one script.

The cases: admission, byte-exact delivery to sink and ``socketpair`` fd
peers, a late joiner at a retained offset, the window stall, the stall,
byzantine-ack, disconnect and retention sheds, explicit acks, retention
with no peers, the snapshot hint, one faulty peer among eight (the
per-session fault axis), the three-second stall and hash once with the
gate on.
"""

import socket
import threading
import time

import pytest

import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.fanout import server as jserver
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu_torch.fanout import (
    FanoutBusy,
    FanoutServer,
    PeerShed,
    SnapshotNeeded,
)
from dat_replication_protocol_tpu_torch.fanout import server as pserver
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.session.faults import FaultPlan

WIRE = bytes(range(256)) * 300  # 76,800 bytes, content position-coded


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()


def _counting_sink(buf: bytearray, bite: int = 1 << 30):
    def sink(views):
        n = 0
        for v in views:
            take = min(len(v), bite - n)
            buf.extend(bytes(v[:take]))
            n += take
            if n >= bite:
                break
        return n
    return sink


def _until(cond, timeout: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


# -- the server cases -----------------------------------------------------------


def test_admission_is_stage_one_of_the_overload_contract():
    srv = FanoutServer(max_peers=2, stall_timeout=5.0)
    try:
        srv.attach_peer("a", sink=lambda vs: 0)
        srv.attach_peer("b", sink=lambda vs: 0)
        with pytest.raises(FanoutBusy) as ei:
            srv.attach_peer("c", sink=lambda vs: 0)
        assert ei.value.peers == 2 and ei.value.max_peers == 2
        with pytest.raises(ValueError, match="already attached"):
            srv.attach_peer("a", sink=lambda vs: 0)
        with pytest.raises(ValueError):
            srv.attach_peer("bad{key}", sink=lambda vs: 0)
        with pytest.raises(ValueError):
            srv.attach_peer(None, sink=lambda vs: 0)
        with pytest.raises(ValueError, match="exactly one"):
            srv.attach_peer("x", sink=lambda vs: 0, fd=1)
        assert srv.admission_state() == {"open": False, "peers": 2,
                                         "max_peers": 2, "sealed": False}
    finally:
        srv.close()


def test_delivers_byte_exact_to_sink_and_fd_peers():
    srv = FanoutServer(stall_timeout=10.0)
    a, b = socket.socketpair()
    try:
        got = bytearray()
        p_sink = srv.attach_peer("sink", sink=_counting_sink(got))
        recv = bytearray()

        def reader():
            while d := b.recv(65536):
                recv.extend(d)

        t = threading.Thread(target=reader, daemon=True)
        t.start()
        p_fd = srv.attach_peer("fd", fd=a.fileno())
        for off in range(0, len(WIRE), 4321):
            srv.publish(WIRE[off:off + 4321])
        srv.seal()
        assert srv.drain(15)
        assert p_sink.wait_done(5) and p_fd.wait_done(5)
        a.shutdown(socket.SHUT_WR)
        t.join(5)
        assert not t.is_alive()
        assert bytes(got) == WIRE and bytes(recv) == WIRE
        st = p_sink.stats()
        assert st["sent_bytes"] == len(WIRE) and st["done"]
    finally:
        srv.close()
        a.close()
        b.close()


def test_late_joiner_attaches_mid_stream_at_retained_offset():
    srv = FanoutServer(stall_timeout=10.0)
    try:
        srv.publish(WIRE[:30000])
        tail = bytearray()
        p = srv.attach_peer("late", sink=_counting_sink(tail), offset=30000)
        srv.publish(WIRE[30000:])
        srv.seal()
        assert srv.drain(10) and p.wait_done(5)
        assert bytes(tail) == WIRE[30000:]
    finally:
        srv.close()


def test_window_stall_bounds_only_the_slow_peer():
    srv = FanoutServer(stall_timeout=30.0)
    try:
        fast, slow = bytearray(), bytearray()
        gate = threading.Event()
        slow_sink = _counting_sink(slow)
        p_fast = srv.attach_peer("fast", sink=_counting_sink(fast))
        p_slow = srv.attach_peer(
            "slow", sink=lambda vs: slow_sink(vs) if gate.is_set() else 0)
        t0 = time.monotonic()
        for off in range(0, len(WIRE), 8192):
            srv.publish(WIRE[off:off + 8192])
        srv.seal()
        assert p_fast.wait_done(10)
        assert time.monotonic() - t0 < 5.0
        assert bytes(fast) == WIRE and not p_slow.stats()["done"]
        gate.set()
        assert p_slow.wait_done(10) and bytes(slow) == WIRE
    finally:
        srv.close()


def test_sheds_stalled_peer_and_neighbours_never_notice():
    srv = FanoutServer(stall_timeout=0.25)
    try:
        healthy = bytearray()
        p_ok = srv.attach_peer("ok", sink=_counting_sink(healthy))
        p_stuck = srv.attach_peer("stuck", sink=lambda vs: 0)
        for off in range(0, len(WIRE), 8192):
            srv.publish(WIRE[off:off + 8192])
        srv.seal()
        assert p_ok.wait_done(10)
        assert _until(lambda: p_stuck.shed_reason is not None)
        assert p_stuck.shed_reason == "stall"
        with pytest.raises(PeerShed) as ei:
            p_stuck.raise_if_shed()
        assert ei.value.key == "stuck" and ei.value.reason == "stall"
        assert bytes(healthy) == WIRE
    finally:
        srv.close()


def test_sheds_byzantine_acker_with_structured_error():
    srv = FanoutServer(stall_timeout=10.0)
    try:
        p = srv.attach_peer("byz", sink=_counting_sink(bytearray()),
                            explicit_ack=True)
        srv.publish(b"n" * 2000)
        assert _until(lambda: p.sent >= 2000)
        with pytest.raises(PeerShed) as ei:
            p.ack(99999)  # bytes never sent
        assert ei.value.reason == "byzantine" and p.shed_reason == "byzantine"
    finally:
        srv.close()


def test_sheds_disconnected_fd_peer():
    srv = FanoutServer(stall_timeout=10.0)
    a, b = socket.socketpair()
    try:
        p = srv.attach_peer("gone", fd=a.fileno())
        b.close()  # the peer vanishes
        srv.publish(b"w" * 70000)
        srv.publish(b"w" * 70000)  # EPIPE surfaces on a later writev
        assert _until(lambda: p.shed_reason is not None)
        assert p.shed_reason == "disconnect"
    finally:
        srv.close()
        a.close()


def test_sheds_budget_trimmed_laggard_as_retention():
    srv = FanoutServer(retention_budget=4096, stall_timeout=30.0)
    try:
        drained = bytearray()
        lag = srv.attach_peer("lag", sink=lambda vs: 0)
        ok = srv.attach_peer("ok", sink=_counting_sink(drained))
        for _ in range(8):
            srv.publish(b"r" * 2000)
        assert _until(lambda: lag.shed_reason is not None)
        assert lag.shed_reason == "retention"
        srv.seal()
        assert ok.wait_done(10) and len(drained) == 16000
    finally:
        srv.close()


def test_explicit_ack_window_closes_and_reopens():
    srv = FanoutServer(stall_timeout=30.0)
    try:
        got = bytearray()
        p = srv.attach_peer("wan", sink=_counting_sink(got),
                            window_bytes=1024, explicit_ack=True)
        srv.publish(b"h" * 10000)
        assert _until(lambda: len(got) >= 1024)
        time.sleep(0.1)  # room for the dispatcher to overshoot
        assert len(got) == 1024
        p.ack(1024)
        assert _until(lambda: len(got) >= 2048)
        assert len(got) == 2048
        srv.seal()
        deadline = time.monotonic() + 10
        while len(got) < 10000 and time.monotonic() < deadline:
            p.ack(p.sent)
            time.sleep(0.01)
        assert bytes(got) == b"h" * 10000
    finally:
        srv.close()


def test_peer_latency_stats_populate():
    srv = FanoutServer(stall_timeout=10.0)
    try:
        p = srv.attach_peer("lat", sink=_counting_sink(bytearray()))
        for off in range(0, len(WIRE), 8192):
            srv.publish(WIRE[off:off + 8192])
        srv.seal()
        assert p.wait_done(10)
        st = p.stats()
        assert st["lat_p99_ms"] >= st["lat_p50_ms"] >= 0
    finally:
        srv.close()


def test_retention_enforced_with_zero_peers_attached():
    srv = FanoutServer(retention_budget=4096, stall_timeout=30.0)
    try:
        for _ in range(16):
            srv.publish(b"g" * 1024)
        assert _until(lambda: srv.log.retained_bytes <= 4096)
        assert srv.log.end == 16384
    finally:
        srv.close()


def test_invalidated_laggard_honest_ack_sheds_as_retention():
    srv = FanoutServer(retention_budget=2048, stall_timeout=30.0)
    try:
        lag = srv.attach_peer("lag", sink=_counting_sink(bytearray()),
                              explicit_ack=True)
        for _ in range(8):
            srv.publish(b"w" * 1024)
        assert _until(lambda: srv.log.start > 0)
        assert _until(lambda: lag.sent >= 4096)
        with pytest.raises(PeerShed) as ei:
            lag.ack(lag.sent)  # honest: the bytes were delivered
        assert ei.value.reason == "retention"
    finally:
        srv.close()


def test_attach_past_retention_carries_snapshot_hint():
    hint = {"port": 4711, "cap": 4}
    for kw, want in (({"snapshot_hint": hint}, hint), ({}, None)):
        srv = FanoutServer(retention_budget=64, **kw)
        try:
            srv.publish(b"x" * 400)
            srv.log.enforce_retention()
            with pytest.raises(SnapshotNeeded) as ei:
                srv.attach_peer("late", sink=lambda vs: 0, offset=0)
            assert ei.value.hint == want
            assert ei.value.retained == (400 - 64, 400)
        finally:
            srv.close()


def test_shed_peer_slot_is_released_for_a_replacement():
    srv = FanoutServer(max_peers=2, stall_timeout=0.1,
                       retention_budget=1 << 24)
    try:
        ok_buf, fresh_buf = bytearray(), bytearray()
        p_ok = srv.attach_peer("ok", sink=_counting_sink(ok_buf))
        p_bad = srv.attach_peer("bad", sink=lambda vs: 0)
        srv.publish(WIRE[:8192])
        assert _until(lambda: p_bad.shed_reason == "stall")
        p_bad.close()
        p_fresh = srv.attach_peer("fresh", sink=_counting_sink(fresh_buf),
                                  offset=0)
        srv.publish(WIRE[8192:16384])
        srv.seal()
        assert p_ok.wait_done(10) and p_fresh.wait_done(10)
        assert bytes(ok_buf) == bytes(fresh_buf) == WIRE[:16384]
    finally:
        srv.close()


# -- one faulty peer among eight --------------------------------------------------

N_PEERS = 8
_SHED_FOR = {"stall": "stall", "truncate": "disconnect", "flip": "byzantine"}


class _FaultySink:
    """Stalls for good at ``stall_at`` or dies with EPIPE at ``die_at``
    (enforced inside a call: one turn can cover the whole wire)."""

    def __init__(self, stall_at=None, die_at=None):
        self.buf = bytearray()
        self.at = stall_at if stall_at is not None else die_at
        self.dies = die_at is not None

    def __call__(self, views) -> int:
        budget = (1 << 60 if self.at is None else self.at) - len(self.buf)
        if budget <= 0:
            if self.dies:
                raise OSError(32, "Broken pipe (injected)")
            return 0
        return _counting_sink(self.buf, budget)(views)


@pytest.mark.parametrize("seed", range(10))
def test_one_faulty_peer_cannot_hurt_the_broadcast(seed, port_obs):
    faulty = FaultPlan.faulty_session(seed, N_PEERS)
    scenario = FaultPlan.session_scenario(seed, N_PEERS)
    srv = FanoutServer(stall_timeout=0.15, retention_budget=1 << 24)
    bufs, peers, byz = {}, {}, None
    try:
        for i in range(N_PEERS):
            plan = FaultPlan.for_sweep(seed, len(WIRE), attempt=0,
                                       session=i, n_sessions=N_PEERS)
            key = f"seed{seed}-p{i}"
            if i != faulty:
                bufs[i] = bytearray()
                sink = _counting_sink(bufs[i],
                                      max(512, plan.max_segment or 1 << 20))
                peers[i] = srv.attach_peer(key, sink=sink)
            elif scenario == "flip":
                peers[i] = srv.attach_peer(key, sink=_FaultySink(),
                                           explicit_ack=True)

                def drive(p=peers[i], at=plan.flip_at):
                    _until(lambda: p.sent >= at, 10)
                    try:
                        p.ack(p.sent + 1 + plan.flip_mask)
                    except PeerShed:
                        pass

                byz = threading.Thread(target=drive, daemon=True)
                byz.start()
            else:
                sink = (_FaultySink(stall_at=plan.stall_at)
                        if scenario == "stall"
                        else _FaultySink(die_at=plan.truncate_at))
                peers[i] = srv.attach_peer(key, sink=sink)
        for off in range(0, len(WIRE), 1024):
            srv.publish(WIRE[off:off + 1024])
        srv.seal()
        for i in bufs:
            assert peers[i].wait_done(10), f"healthy peer {i} hung"
        assert _until(lambda: peers[faulty].shed_reason is not None, 10)
        if byz is not None:
            byz.join(10)
            assert not byz.is_alive()
        for i in bufs:
            assert bytes(bufs[i]) == WIRE
            st = peers[i].stats()
            assert st["shed"] is None and st["done"]
            assert st["lat_p99_ms"] < 500.0
        assert peers[faulty].shed_reason == _SHED_FOR[scenario]
        sheds = events.EVENTS.events("fanout.shed")
        assert sheds and all(
            ev["fields"]["key"] == f"seed{seed}-p{faulty}"
            and ev["fields"]["reason"] == _SHED_FOR[scenario]
            for ev in sheds)
    finally:
        srv.close()


def test_three_second_stall_leaves_healthy_p99_flat():
    srv = FanoutServer(stall_timeout=10.0, retention_budget=1 << 24)
    try:
        stalled = bytearray()
        gate_t = []

        def stall_sink(views):
            if not gate_t:
                gate_t.append(time.monotonic() + 3.0)
            if time.monotonic() < gate_t[0]:
                budget = len(WIRE) // 2 - len(stalled)
                if budget <= 0:
                    return 0
                return _counting_sink(stalled, budget)(views)
            return _counting_sink(stalled)(views)

        healthy = [bytearray() for _ in range(N_PEERS - 1)]
        p_stall = srv.attach_peer("staller", sink=stall_sink)
        ps = [srv.attach_peer(f"h{i}", sink=_counting_sink(healthy[i]))
              for i in range(N_PEERS - 1)]
        t0 = time.monotonic()
        for off in range(0, len(WIRE), 2048):
            srv.publish(WIRE[off:off + 2048])
        srv.seal()
        for p in ps:
            assert p.wait_done(10)
        assert time.monotonic() - t0 < 1.5
        for i, p in enumerate(ps):
            assert bytes(healthy[i]) == WIRE
            assert p.stats()["lat_p99_ms"] < 500.0
        assert p_stall.wait_done(10)
        assert time.monotonic() - t0 >= 3.0
        assert bytes(stalled) == WIRE
    finally:
        srv.close()


# -- hash once, with the gate on ----------------------------------------------------


def _session_wire() -> bytes:
    e = protocol.encode()
    for j in range(50):
        e.change({"key": f"k{j}", "change": j, "from": j, "to": j + 1,
                  "value": b"v" * 32})
    e.blob(5000).end(b"b" * 5000)
    e.finalize()
    out = bytearray()
    while (d := e.read(4096)) is not None:
        out += d
    return bytes(out)


@pytest.mark.parametrize("n_peers", [1, 4])
def test_hash_once_with_the_gate_on(n_peers, port_obs):
    wire = _session_wire()
    srv = FanoutServer(stall_timeout=10.0)
    try:
        bufs = [bytearray() for _ in range(n_peers)]
        for i in range(n_peers):
            srv.attach_peer(f"p{i}", sink=_counting_sink(bufs[i]))
        dec = protocol.decode(backend="cuda", device="cpu")
        digs = []
        dec.on_digest(lambda kind, seq, d: digs.append(d))
        for off in range(0, len(wire), 1024):
            chunk = wire[off:off + 1024]
            srv.publish(chunk)  # the fan-out moves bytes only
            dec.write(chunk)  # the digest work, once
        dec.end()
        srv.seal()
        assert srv.drain(10)
        assert dec.finished and len(digs) == 51
        assert all(bytes(b) == wire for b in bufs)
        c = metrics.snapshot()["counters"]
        assert c["fanout.append.bytes"] == len(wire)
        assert c["fanout.sent.bytes"] == n_peers * len(wire)
        # the digest work does not grow with the peers
        assert c["device.submit.items"] == 51
        assert c["device.submit.bytes"] == sum(
            len(protocol.encode_change({"key": f"k{j}", "change": j,
                                        "from": j, "to": j + 1,
                                        "value": b"v" * 32}))
            for j in range(50)) + 5000
    finally:
        srv.close()


# -- the port against the JAX server, one script ---------------------------------

_TIME_FIELDS = ("lat_p50_ms", "lat_p99_ms")
# counters whose values depend on the dispatcher's timing, not the script
_TIMING = ("fanout.dispatch.turns",)


def _script(mod, registry_snapshot) -> dict:
    srv = mod.FanoutServer(max_peers=4, stall_timeout=0.2,
                           retention_budget=1 << 20)
    try:
        for off in range(0, len(WIRE), 4321):
            srv.publish(WIRE[off:off + 4321])
        srv.seal()
        full, bitten = bytearray(), bytearray()
        p_full = srv.attach_peer("full", sink=_counting_sink(full))
        p_bite = srv.attach_peer("bite", sink=_counting_sink(bitten, 1000))
        p_stall = srv.attach_peer("stall", sink=lambda vs: 0)
        p_byz = srv.attach_peer("byz", sink=_counting_sink(bytearray()),
                                explicit_ack=True)
        with pytest.raises(mod.FanoutBusy):
            srv.attach_peer("extra", sink=lambda vs: 0)
        assert p_full.wait_done(10) and p_bite.wait_done(10)
        assert _until(lambda: p_stall.shed_reason is not None)
        assert _until(lambda: p_byz.stats()["done"])
        with pytest.raises(mod.PeerShed):
            p_byz.ack(p_byz.sent + 5)
        assert bytes(full) == bytes(bitten) == WIRE
        peers = {k: {f: v for f, v in st.items() if f not in _TIME_FIELDS}
                 for k, st in srv.peers_snapshot().items()}
        snap = srv.snapshot()
        admission = srv.admission_state()
        counters = {k: v for k, v in registry_snapshot()["counters"].items()
                    if k.startswith("fanout.") and k not in _TIMING}
        gauges = {k: v for k, v in registry_snapshot()["gauges"].items()
                  if k.startswith("fanout.")}
        for p in (p_full, p_bite, p_stall, p_byz):
            p.close()
        after = srv.peers_snapshot()
    finally:
        srv.close()
    return {"peers": peers, "snapshot": snap, "admission": admission,
            "counters": counters, "gauges": gauges, "after": after}


def test_snapshots_and_counters_match_the_jax_server(port_obs, obs_enabled,
                                                     monkeypatch):
    monkeypatch.setenv("DAT_PUMP", "python")
    got = _script(pserver, metrics.snapshot)
    want = _script(jserver, jmetrics.snapshot)
    assert got == want
    assert got["peers"]["stall"]["shed"] == "stall"
    assert got["peers"]["byz"]["shed"] == "byzantine"
    assert got["counters"]["fanout.rejected"] == 1
    assert got["counters"]["fanout.sent.bytes"] == 3 * len(WIRE)
    assert got["after"] == {}


# -- the pump's tap: the broadcast source's publish hook -----------------------------


def test_pump_tap_sees_exactly_the_decoded_bytes(monkeypatch):
    """The port's tapped reader under ``recv_over`` against the JAX
    ``recv_pump(tap=)`` on its Python route: the same bytes tapped, the
    same rows decoded, the subscriber fed by the tap byte-exact."""
    import dat_replication_protocol_tpu as jax_protocol
    from dat_replication_protocol_tpu.session import pump as jpump
    from dat_replication_protocol_tpu_torch.session import pump as ppump
    from dat_replication_protocol_tpu_torch.session.transport import (
        recv_over)

    monkeypatch.setenv("DAT_PUMP", "python")
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    wire = _session_wire()
    seen = {}
    for name, mod, p in (("port", ppump, protocol),
                         ("jax", jpump, jax_protocol)):
        a, b = socket.socketpair()
        srv = (FanoutServer if name == "port" else jserver.FanoutServer)(
            stall_timeout=10.0)
        try:
            sub = bytearray()
            srv.attach_peer("sub", sink=_counting_sink(sub))
            tapped = []
            rows = []
            dec = p.decode()
            dec.change(lambda c, done: (rows.append(c.key), done()))

            def tap(d, tapped=tapped, srv=srv):
                tapped.append(bytes(d))
                srv.publish(d)

            sender = threading.Thread(target=lambda: (
                b.sendall(wire), b.shutdown(socket.SHUT_WR)), daemon=True)
            sender.start()
            if name == "port":
                # the plain route: the tap wraps the transport's reader
                recv_over(dec, ppump._tapped_reader(a.recv, tap))
            else:
                mod.recv_pump(dec, a.fileno(), tap=tap)
            sender.join(10)
            assert not sender.is_alive() and dec.finished
            srv.seal()
            assert srv.drain(10)
            seen[name] = (b"".join(tapped), bytes(sub), rows, dec.bytes)
        finally:
            srv.close()
            a.close()
            b.close()
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == seen["port"][1] == wire
    assert len(seen["port"][2]) == 50


def test_tapped_reader_without_a_tap_is_the_reader():
    from dat_replication_protocol_tpu_torch.session import pump as ppump

    def read(n):
        return b"ab"

    assert ppump._tapped_reader(read, None) is read
    got = []
    tapped = ppump._tapped_reader(lambda n: b"" if got else b"xy",
                                  got.append)
    assert tapped(5) == b"xy" and tapped(5) == b"" and got == [b"xy"]
