"""The port's ReplicationHub against the JAX package's.

The JAX hub runs on a ``hash_batch`` of ``hashlib`` digests; the port's
on the plain B1 (``device="cpu"``) or on an injected ``hash_begin``.
Both take the same registrations and submissions, and must give the
same admission decisions (``HubBusy`` fields, refused keys), the same
digests routed to the same sessions, the same weighted-fair batches,
the same flush barrier, the same shed victim, reason and parked bytes
(in ``SessionShed`` and in the ``hub.shed`` event), ``HubError``
everywhere after an engine failure or ``close()``, and the same labeled
collector entries and Prometheus lines.
"""

import hashlib
import threading
import time

import numpy as np
import pytest
import torch

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.hub import HubBusy as JaxHubBusy
from dat_replication_protocol_tpu.hub import ReplicationHub as JaxHub
from dat_replication_protocol_tpu.hub import SessionShed as JaxSessionShed
from dat_replication_protocol_tpu.obs import events as jax_events
from dat_replication_protocol_tpu.obs import metrics as jax_metrics
from dat_replication_protocol_tpu_torch.hub import (
    HubBusy,
    HubError,
    ReplicationHub,
    SessionShed,
)
from dat_replication_protocol_tpu_torch.hub import engine as hub_engine
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change,
)

HARD_TIMEOUT = 30.0


def _h(p: bytes) -> bytes:
    return hashlib.blake2b(p, digest_size=32).digest()


def _hashlib_batch(payloads):
    return [_h(p) for p in payloads]


def _begin(batch_fn):
    """A ``hash_begin`` engine over a ``hash_batch``-style function."""
    def begin(payloads):
        digests = batch_fn(payloads)
        return lambda: digests
    return begin


def _join_all(threads, timeout=HARD_TIMEOUT):
    for t in threads:
        t.join(timeout)
    assert all(not t.is_alive() for t in threads), "HANG"


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


def _hubs(engine=_hashlib_batch, **kw):
    """(jax hub, port hub) on the same engine and settings."""
    return (JaxHub(hash_batch=engine, **kw),
            ReplicationHub(hash_begin=_begin(engine), **kw))


# -- admission ----------------------------------------------------------------


def test_admission_rejects_with_the_same_fields():
    out = []
    for hub, busy in zip(_hubs(max_sessions=2), (JaxHubBusy, HubBusy)):
        a = hub.register("a")
        hub.register("b")
        with pytest.raises(busy) as ei:
            hub.register("c")
        e = ei.value
        a.close()
        c = hub.register("c")  # a freed slot admits again
        out.append((str(e), e.sessions, e.max_sessions, e.parked_bytes,
                    e.parked_budget == hub.parked_budget, c.key))
        hub.close()
    assert out[0] == out[1]
    assert out[1][1:3] == (2, 2)


def test_admission_closes_at_half_the_parked_budget(obs_enabled, port_obs):
    gate = threading.Event()

    def stuck(payloads):
        gate.wait(HARD_TIMEOUT)
        return _hashlib_batch(payloads)

    jhub, phub = _hubs(stuck, parked_budget=500, linger_s=0.0)
    got = []
    try:
        for hub, busy, log in ((jhub, JaxHubBusy, jax_events.EVENTS),
                               (phub, HubBusy, events.EVENTS)):
            s = hub.register("parker")
            s.submit(b"x" * 300, lambda d: None)
            with pytest.raises(busy) as ei:
                hub.register("late")
            reject = log.events("hub.reject")[-1]["fields"]
            got.append((str(ei.value), ei.value.parked_bytes, reject))
    finally:
        gate.set()
        jhub.close()
        phub.close()
    assert got[0] == got[1]
    assert got[1][1] == 300 and got[1][2]["key"] == "late"
    assert port_obs.REGISTRY.counter("hub.rejected").value == 1


@pytest.mark.parametrize("bad", ["a,b", "a{b", "a}b", 'a"b', "a=b", "a\nb",
                                 "a\rb", ""])
def test_label_breaking_keys_are_refused(bad):
    for hub in _hubs():
        with hub, pytest.raises(ValueError):
            hub.register(bad)


def test_duplicate_key_and_weight_are_refused():
    for hub in _hubs():
        with hub:
            s = hub.register("dup")
            with pytest.raises(ValueError, match="already registered"):
                hub.register("dup")
            with pytest.raises(ValueError, match="weight"):
                hub.register("w", weight=0)
            assert hub.register("tenant-a:10.0.0.7:4711").key == \
                "tenant-a:10.0.0.7:4711"
            s.close()


# -- digests routed by session --------------------------------------------------


def _session_wire(pkg, i: int, n_changes: int) -> bytes:
    e = pkg.encode()
    for j in range(n_changes):
        e.change({"key": f"s{i}-{j}", "change": j, "from": 0, "to": 1,
                  "value": b"v%d-%d" % (i, j)})
    b = e.blob(7)
    b.write(b"blob-%02d" % i)
    b.end()
    e.finalize()
    return b"".join(iter(lambda: e.read(4096) or b"", b""))


def _run_sessions(hub, decode, n_sessions, n_changes):
    out: dict = {}

    def run_one(i):
        s = hub.register(f"k{i}")
        dec = decode(s)
        digs = []
        dec.on_digest(lambda kind, seq, d: digs.append((kind, seq, d)))
        wire = _session_wire(protocol, i, n_changes)
        for off in range(0, len(wire), 257):
            dec.write(wire[off:off + 257])
        dec.end()
        assert dec.finished
        out[i] = digs
        s.close()

    threads = [threading.Thread(target=run_one, args=(i,))
               for i in range(n_sessions)]
    for t in threads:
        t.start()
    _join_all(threads)
    return out


def test_sessions_get_their_own_digests_as_the_jax_hub():
    n_sessions, n_changes = 6, 24
    batches = []

    def recording(payloads):
        batches.append(len(payloads))
        return _hashlib_batch(payloads)

    jhub = JaxHub(hash_batch=recording, linger_s=0.005)
    want = _run_sessions(
        jhub, lambda s: jax_protocol.decode(backend="tpu", pipeline=s),
        n_sessions, n_changes)
    jhub.close()
    phub = ReplicationHub(device="cpu", linger_s=0.005)
    got = _run_sessions(
        phub, lambda s: protocol.decode(backend="cuda", pipeline=s),
        n_sessions, n_changes)
    dispatches = phub._pipeline.dispatches
    phub.close()
    assert got == want
    for i in range(n_sessions):
        assert [s for k, s, _ in got[i] if k == "change"] == \
            list(range(n_changes))
        for kind, seq, d in got[i]:
            if kind == "change":
                assert d == _h(encode_change({
                    "key": f"s{i}-{seq}", "change": seq, "from": 0,
                    "to": 1, "value": b"v%d-%d" % (i, seq)}))
            else:
                assert d == _h(b"blob-%02d" % i)
    # the work was batched across sessions
    assert dispatches < n_sessions * (n_changes + 1)


# -- weighted-fair composition ------------------------------------------------


def _wedged(make, max_batch=16):
    """A hub whose dispatcher is parked inside its first turn (one
    primer item), so queues fill and the composer runs deterministically."""
    entered = threading.Event()
    release = threading.Event()

    def gated(payloads):
        entered.set()
        release.wait(HARD_TIMEOUT)
        return _hashlib_batch(payloads)

    hub = make(gated, max_batch=max_batch, linger_s=0.0)
    primer = hub.register("primer")
    primer.submit(b"prime", lambda d: None)
    assert entered.wait(5), "the dispatcher never took the primer"
    return hub, release


def _compose_script(hub, script, turns=3):
    """Register the script's sessions, queue its submissions, compose
    ``turns`` batches; returns each batch as (key, kind, item, tag)."""
    sessions = {key: hub.register(key, weight=w)
                for key, w, _ in script}
    for key, _, payloads in script:
        for tag, p in enumerate(payloads):
            sessions[key].submit(p, lambda t, d: None, tag)
    out = []
    for _ in range(turns):
        with hub._lock:
            batch = hub._compose_locked()
        out.append([(st.key, kind, bytes(item), tag)
                    for st, kind, item, cb, tag, nb in batch])
    return out


SCRIPTS = {
    # both saturated: 12 + 4 of 16 by the 3:1 weights
    "weights-3-1": [("heavy", 3.0, [b"H" * 8] * 40),
                    ("light", 1.0, [b"L" * 8] * 40)],
    # heavy nearly idle: light fills its unused quota
    "greedy-fill": [("heavy", 3.0, [b"H"] * 3),
                    ("light", 1.0, [b"L"] * 40)],
    # three equal sessions of varied sizes: the round-robin start rotates
    "round-robin": [(f"s{i}", 1.0, [bytes([i]) * (1 + j % 5)
                                    for j in range(11 + i)])
                    for i in range(3)],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_composition_is_the_jax_hubs(name):
    got = []
    for make in (lambda g, **kw: JaxHub(hash_batch=g, **kw),
                 lambda g, **kw: ReplicationHub(hash_begin=_begin(g), **kw)):
        hub, release = _wedged(make)
        try:
            got.append(_compose_script(hub, SCRIPTS[name]))
        finally:
            release.set()
            hub.close()
    assert got[0] == got[1]
    first = got[1][0]
    assert len(first) == 16
    if name == "weights-3-1":
        assert [k for k, *_ in first].count("heavy") == 12
    if name == "greedy-fill":
        assert [k for k, *_ in first].count("light") == 13


def test_flush_is_a_per_session_barrier():
    got = []
    for hub in (JaxHub(hash_batch=_hashlib_batch, linger_s=0.005),
                ReplicationHub(device="cpu", linger_s=0.005)):
        s = hub.register("flusher")
        out = []
        for i in range(100):
            s.submit(b"p%03d" % i, out.append)
        s.flush()
        got.append(list(out))  # every digest is in before flush returns
        s.close()
        hub.close()
    assert got[0] == got[1] == [_h(b"p%03d" % i) for i in range(100)]


def test_slow_consumer_stalls_only_its_own_window():
    hub = ReplicationHub(device="cpu", window_items=8, linger_s=0.0)
    slow = hub.register("slow")
    fast = hub.register("fast")
    fast_done = []
    blocked = threading.Event()
    proceed = threading.Event()

    def slow_run():
        for i in range(20):
            slow.submit(b"s" * 10, lambda d: proceed.wait(5))
            if i == 0:
                blocked.set()

    t_slow = threading.Thread(target=slow_run, daemon=True)
    t_slow.start()
    assert blocked.wait(5)

    def fast_run():
        for i in range(50):
            fast.submit(b"f%03d" % i, fast_done.append)
        fast.flush()

    t_fast = threading.Thread(target=fast_run)
    t_fast.start()
    _join_all([t_fast], timeout=10)
    assert fast_done == [_h(b"f%03d" % i) for i in range(50)]
    proceed.set()
    _join_all([t_slow], timeout=10)
    hub.close()


def test_nowait_sessions_poll_their_digests():
    got = []
    for hub in _hubs(linger_s=0.0):
        s = hub.register("edge", nowait=True)
        out = []
        for i in range(30):
            assert s.window_room()
            s.submit(b"n%02d" % i, out.append)
        s.flush()  # sets the barrier goal, never blocks
        deadline = time.monotonic() + 10
        while not s.drained and time.monotonic() < deadline:
            s.poll()
            time.sleep(0.001)
        s.poll()
        assert s.drained and not s.has_completions
        got.append(out)
        s.close()
        hub.close()
    assert got[0] == got[1] == [_h(b"n%02d" % i) for i in range(30)]


# -- shedding -----------------------------------------------------------------


def _flood(hub, shed_cls, release):
    flood = hub.register("flood")
    light = hub.register("light")
    seen = []

    def run():
        try:
            for _ in range(1000):
                flood.submit(b"x" * 100, lambda d: None)
        except shed_cls as e:
            seen.append(e)

    t = threading.Thread(target=run)
    t.start()
    _join_all([t], timeout=10)
    release.set()
    light_got = []
    for i in range(10):
        light.submit(b"y%d" % i, light_got.append)
    light.flush()
    with pytest.raises(shed_cls):
        flood.submit(b"more", lambda d: None)
    with pytest.raises(shed_cls):
        flood.flush()
    flood.close()
    light.close()
    e = seen[0]
    return (e.key, e.reason, e.parked_bytes, str(e)), light_got


def test_the_same_victim_is_shed_as_by_the_jax_hub(obs_enabled, port_obs):
    got = []
    for make, shed_cls, log in (
            (lambda g, **kw: JaxHub(hash_batch=g, **kw), JaxSessionShed,
             jax_events.EVENTS),
            (lambda g, **kw: ReplicationHub(hash_begin=_begin(g), **kw),
             SessionShed, events.EVENTS)):
        release = threading.Event()

        def gated(payloads, release=release):
            release.wait(HARD_TIMEOUT)
            return _hashlib_batch(payloads)

        hub = make(gated, parked_budget=5_000, window_items=10_000,
                   window_bytes=10 << 20, linger_s=0.0)
        try:
            shed, light = _flood(hub, shed_cls, release)
        finally:
            release.set()
            hub.close()
        sheds = [ev["fields"] for ev in log.events("hub.shed")]
        got.append((shed, light, sheds))
    assert got[0] == got[1]
    (key, reason, parked, _), light, sheds = got[1]
    assert (key, reason, parked) == ("flood", "parked-budget", 5_100)
    assert light == [_h(b"y%d" % i) for i in range(10)]
    assert sheds == [{"key": "flood", "reason": "parked-budget",
                      "parked_bytes": 5_100, "sessions": 2}]
    assert port_obs.REGISTRY.counter("hub.shed").value == 1


def test_in_flight_work_of_a_shed_session_is_dropped(port_obs):
    entered, release = threading.Event(), threading.Event()

    def gated(payloads):
        entered.set()
        release.wait(HARD_TIMEOUT)
        return _hashlib_batch(payloads)

    hub = ReplicationHub(hash_begin=_begin(gated), parked_budget=1_000,
                         linger_s=0.0, window_bytes=1 << 20)
    s = hub.register("offender")
    s.submit(b"a" * 600, lambda d: None)  # taken into the engine
    assert entered.wait(5)
    with pytest.raises(SessionShed) as ei:
        s.submit(b"b" * 600, lambda d: None)  # 1,200 parked: over budget
    assert ei.value.parked_bytes == 1_200
    release.set()
    deadline = time.monotonic() + 10
    while (port_obs.REGISTRY.counter("hub.completions.dropped").value < 1
           and time.monotonic() < deadline):
        time.sleep(0.005)
    assert port_obs.REGISTRY.counter("hub.completions.dropped").value == 1
    assert hub.snapshot()["parked_bytes"] == 0
    s.close()
    hub.close()


# -- failures -------------------------------------------------------------------


def test_engine_failure_is_hub_error_everywhere(obs_enabled, port_obs):
    msgs = []
    for hub, log in ((JaxHub(hash_batch=_raise, linger_s=0.0),
                      jax_events.EVENTS),
                     (ReplicationHub(hash_begin=_raise, linger_s=0.0),
                      events.EVENTS)):
        s = hub.register("victim")
        other = hub.register("other")
        err = _submit_until_error(s)
        with pytest.raises(type(err)):
            other.submit(b"y", lambda d: None)
        with pytest.raises(type(err)):
            hub.register("late")
        msgs.append((type(err).__name__, str(err),
                     log.events("hub.error")[0]["fields"]["error"]))
        hub.close()
    assert msgs[0] == msgs[1]
    assert "B1 did not launch" in msgs[1][2]


def _raise(payloads):
    raise RuntimeError("B1 did not launch")


def _submit_until_error(s):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            s.submit(b"x", lambda d: None)
        except RuntimeError as e:
            return e
        time.sleep(0.005)
    pytest.fail("the dispatcher's failure never surfaced")


def test_closed_hub_is_hub_error():
    for hub in _hubs():
        s = hub.register("orphan")
        hub.close()
        hub.close()  # idempotent
        with pytest.raises(RuntimeError, match="hub is closed"):
            s.submit(b"x", lambda d: None)
        with pytest.raises(RuntimeError, match="hub is closed"):
            hub.register("late")


def test_a_card_engine_that_fails_is_hub_error_not_another_engine(
        monkeypatch):
    """A hub on a card loads B1 at construction and sets the card in its
    dispatcher; a B1 that cannot launch reaches the session as HubError
    and no digest from any other engine is delivered."""
    loads, devices = [], []
    card = lambda device="cuda": torch.device("cuda", 0)  # noqa: E731
    monkeypatch.setattr(
        "dat_replication_protocol_tpu_torch.utils.device.resolve_device",
        card)
    monkeypatch.setattr(
        "dat_replication_protocol_tpu_torch.backend.cuda_backend."
        "resolve_device", card)
    monkeypatch.setattr(
        "dat_replication_protocol_tpu_torch.ops._build.load", loads.append)
    monkeypatch.setattr(hub_engine.torch.cuda, "set_device", devices.append)
    hub = ReplicationHub(linger_s=0.0)
    assert loads == ["blake2b"]
    s = hub.register("card")
    delivered = []
    with pytest.raises(HubError, match="dispatcher failed"):
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            s.submit(b"x", delivered.append)
            time.sleep(0.005)
    assert devices == [torch.device("cuda", 0)]
    assert delivered == []
    hub.close()


def test_hub_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ReplicationHub()


# -- telemetry ------------------------------------------------------------------


def _hub_entries(snap):
    return {section: {k: v for k, v in snap[section].items()
                      if k.startswith("hub.")}
            for section in ("counters", "gauges")}


def test_collector_entries_and_prometheus_lines(obs_enabled, port_obs):
    got = []
    for hub, mod in zip(_hubs(linger_s=0.002), (jax_metrics, metrics)):
        a = hub.register("alpha")
        b = hub.register("beta")
        out = []
        for i in range(12):
            a.submit(b"a" * 50, out.append)
        a.flush()
        snap = mod.REGISTRY.snapshot()
        per = hub.sessions_snapshot()
        prom = sorted(line for line in mod.to_prom_text().splitlines()
                      if "hub_session" in line or "dat_hub_sessions" in line)
        a.close()
        after = _hub_entries(mod.REGISTRY.snapshot())
        b.close()
        hub.close()
        got.append((_hub_entries(snap), per, prom, after))
    (entries, per, prom, after) = got[1]
    # dispatch counts follow the dispatcher's timing; the rest is exact
    for g in got:
        for k in list(g[0]["counters"]):
            if k.startswith("hub.session.dispatches") or k in (
                    "hub.dispatch.batches", "hub.dispatch.items",
                    "hub.dispatch.bytes"):
                assert g[0]["counters"][k] >= 1 or "beta" in k
                g[0]["counters"][k] = None
        for d in g[1].values():
            d["dispatches"] = None
        g[2][:] = [line for line in g[2] if "dispatches" not in line]
    assert got[0][:3] == got[1][:3]
    assert entries["counters"]["hub.session.submitted{session=alpha}"] == 12
    assert entries["counters"]["hub.session.delivered{session=alpha}"] == 12
    assert entries["gauges"]["hub.sessions"] == 2.0
    text = "\n".join(prom)
    assert 'dat_hub_session_parked_bytes{session="alpha"} 0' in text
    assert "# TYPE dat_hub_sessions gauge" in text
    # a closed session leaves the breakdown
    assert "hub.session.submitted{session=alpha}" not in after["counters"]
    assert after["gauges"]["hub.sessions"] == 1.0


def test_stale_hub_close_keeps_successor_collector(port_obs):
    hub_a = ReplicationHub(device="cpu")
    hub_b = ReplicationHub(device="cpu")  # replaces A's collector
    s = hub_b.register("survivor")
    hub_a.close()
    snap = port_obs.REGISTRY.snapshot()
    assert "hub.session.submitted{session=survivor}" in snap["counters"]
    s.close()
    hub_b.close()
    assert "hub.sessions" not in port_obs.REGISTRY.snapshot()["gauges"] or \
        port_obs.REGISTRY.snapshot()["gauges"]["hub.sessions"] == 0.0


def test_admission_state_and_snapshot_are_the_jax_hubs():
    got = []
    for hub in _hubs(max_sessions=3, parked_budget=1 << 20):
        s = hub.register("one")
        state = hub.admission_state()
        snap = hub.snapshot()
        snap.pop("pump_route")
        s.close()
        hub.close()
        got.append((state, snap, hub.admission_state()["open"]))
    assert got[0] == got[1]
    assert got[1][0]["open"] and not got[1][2]


def test_plain_engine_digests_random_payloads_as_hashlib():
    rng = np.random.default_rng(11)
    sizes = rng.integers(0, 3000, 64)
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in sizes]
    hub = ReplicationHub(device="cpu", linger_s=0.0, max_batch=16)
    s = hub.register("rand")
    out = []
    for i, p in enumerate(payloads):
        s.submit(p, lambda tag, d: out.append((tag, d)), 100 + i)
    s.flush()
    s.close()
    hub.close()
    assert out == [(100 + i, _h(p)) for i, p in enumerate(payloads)]


def test_more_sessions_than_cores_keep_the_accounting_exact():
    """Stress: more session threads than cores under a short switch
    interval, mixing tagged and untagged submits and flushes; every session
    gets exactly its digests and the hub's parked bytes return to 0."""
    import os
    import sys

    n = (os.cpu_count() or 4) + 4
    hub = ReplicationHub(hash_begin=_begin(_hashlib_batch), linger_s=0.0,
                         max_batch=64, window_items=32)
    got: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def run(i):
        s = hub.register(f"t{i}")
        out = []
        for k in range(40):
            if k % 3:
                s.submit(b"%d-%d" % (i, k), out.append)
            else:
                for j in range(5):
                    s.submit(b"%d-%d-%d" % (i, k, j),
                             lambda tag, d: out.append(d), j)
            if k % 10 == 9:
                s.flush()
        s.flush()
        got[i] = (out, s.stats())
        s.close()

    try:
        threads = [threading.Thread(target=run, args=(i,), daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        _join_all(threads)
    finally:
        sys.setswitchinterval(old)
    snap = hub.snapshot()
    hub.close()
    for i in range(n):
        want = []
        for k in range(40):
            want += ([b"%d-%d" % (i, k)] if k % 3 else
                     [b"%d-%d-%d" % (i, k, j) for j in range(5)])
        out, stats = got[i]
        assert out == [_h(p) for p in want]
        assert stats["submitted"] == stats["delivered"] == len(want)
        assert stats["parked_bytes"] == 0
    assert (snap["parked_bytes"], snap["queued_items"]) == (0, 0)
