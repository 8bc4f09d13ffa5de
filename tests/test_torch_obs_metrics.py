"""The port's metrics core and event log against the JAX package's.

The same seeded sequence of counter, gauge and histogram operations
(and collectors) goes through a fresh registry of each package: the
snapshots and their Prometheus text must be equal.  Then the gate, the
disabled path's cost, and the event ring and its sinks.
"""

import io
import os
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import metrics as jax_metrics
from dat_replication_protocol_tpu_torch.obs import (device, events, flight,
                                                    metrics, tracing)


@pytest.fixture
def port_obs():
    """The port's gate on, with clean values, rings, recorder, sentinel
    and engine notes; the prior gate state restored afterwards."""
    was_on = metrics.OBS.on

    def reset():
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        tracing.SPANS.clear()
        flight.FLIGHT._reset_for_tests()
        device.SENTINEL.reset_for_tests()
        device.reset_engine_notes()

    reset()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        reset()


def _drive(mod, seed: int):
    """One seeded sequence of registry operations through ``mod``'s
    metric classes; returns the registry."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    names = [f"t.m{i}" for i in range(6)]
    for _ in range(400):
        op = int(rng.integers(0, 5))
        name = names[int(rng.integers(0, len(names)))]
        if op == 0:
            reg.counter("c." + name).inc(int(rng.integers(1, 1000)))
        elif op == 1:
            reg.gauge("g." + name).set(float(rng.normal()))
        elif op == 2:
            reg.gauge("g." + name).inc(float(rng.integers(1, 9)))
        elif op == 3:
            reg.gauge("g." + name).dec(0.5)
        else:
            reg.histogram("h." + name, ring=16).observe(
                float(10.0 ** rng.uniform(-7, 2)))
    reg.register_collector("hub", lambda: {
        "counters": {'hub.session.bytes{session=k"1}': 7},
        "gauges": {"hub.session.parked{session=k2}": 2.5}})
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_and_prom_text_equal_the_reference(seed):
    ours = _drive(metrics, seed)
    ref = _drive(jax_metrics, seed)
    assert ours.snapshot() == ref.snapshot()
    assert metrics.to_prom_text(ours.snapshot()) == \
        jax_metrics.to_prom_text(ref.snapshot())
    # reset keeps registrations, zeroes values and drops collectors
    ours.reset()
    ref.reset()
    assert ours.snapshot() == ref.snapshot()


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.9, 0.99, 1.0])
def test_histogram_quantiles_equal_the_reference(q):
    rng = np.random.default_rng(7)
    ours = metrics.Histogram("h", ring=32)
    ref = jax_metrics.Histogram("h", ring=32)
    assert ours.quantile(q) is None and ref.quantile(q) is None
    for v in rng.exponential(size=100):
        ours.observe(float(v))
        ref.observe(float(v))
    assert ours.quantile(q) == ref.quantile(q)
    assert (ours.count, ours.sum) == (ref.count, ref.sum)


def _retype(m):
    reg = m.Registry()
    reg.counter("x")
    reg.gauge("x")


def _rebucket(m):
    reg = m.Registry()
    reg.histogram("x", buckets=(1.0, 2.0))
    reg.histogram("x", buckets=(1.0, 3.0))


@pytest.mark.parametrize("make", [
    lambda m: m.Histogram("h", buckets=(1.0, 0.5)),
    lambda m: m.Histogram("h", buckets=(1.0, 1.0)),
    lambda m: m.Histogram("h", ring=0),
    lambda m: m.Histogram("h").quantile(1.5),
    _retype,
    _rebucket,
], ids=["unsorted", "duplicate", "ring", "quantile", "retype", "rebucket"])
def test_errors_equal_the_reference(make):
    with pytest.raises(ValueError) as ours:
        make(metrics)
    with pytest.raises(ValueError) as ref:
        make(jax_metrics)
    assert str(ours.value) == str(ref.value)


def test_gate_starts_off_and_follows_enable_and_disable():
    assert metrics._Gate().on is False
    was_on = metrics.OBS.on
    try:
        metrics.enable()
        assert metrics.OBS.on
        metrics.disable()
        assert not metrics.OBS.on
    finally:
        metrics.OBS.on = was_on


def test_collector_unregister_is_owner_checked():
    reg = metrics.Registry()
    old = lambda: {"counters": {"a{k=1}": 1}}  # noqa: E731
    new = lambda: {"counters": {"a{k=1}": 2}}  # noqa: E731
    reg.register_collector("hub", old)
    reg.register_collector("hub", new)
    reg.unregister_collector("hub", old)  # a late close of the old owner
    assert reg.snapshot()["counters"] == {"a{k=1}": 2}
    reg.unregister_collector("hub", new)
    assert reg.snapshot()["counters"] == {}


def _timed(fn, n):
    t0 = time.perf_counter()
    fn(n)
    return time.perf_counter() - t0


def test_disabled_path_is_gate_bound():
    """A disabled site (`if OBS.on: metric.inc()`) costs a few attribute
    loads: bound it against the same loop doing one locked increment per
    iteration, with the reference test's 2x headroom."""
    gate = metrics.OBS
    c = metrics.Counter("budget.test")
    was_on = gate.on
    gate.on = False
    try:
        def gated(n):
            for _ in range(n):
                if gate.on:
                    c.inc()

        def enabled_cost(n):
            for _ in range(n):
                c.inc()

        N = 200_000
        gated(N)  # warm
        enabled_cost(1000)
        t_gated = min(_timed(gated, N) for _ in range(3))
        t_inc = min(_timed(enabled_cost, N) for _ in range(3))
    finally:
        gate.on = was_on
    assert t_gated < t_inc * 2.0, (
        f"disabled path too slow: gated={t_gated:.4f}s vs "
        f"locked-inc={t_inc:.4f}s over 200k iterations")


def test_disabled_session_leaves_everything_dark():
    """With the gate off, a digest session registers no value, no event
    and no span (the dark-gate probe)."""
    import dat_replication_protocol_tpu_torch as protocol

    was_on = metrics.OBS.on
    metrics.OBS.on = False
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    tracing.SPANS.clear()
    try:
        enc = protocol.encode(backend="cuda", device="cpu")
        dec = protocol.decode(backend="cuda", device="cpu")
        enc.on_digest(lambda *a: None)
        dec.on_digest(lambda *a: None)
        protocol.pipe(enc, dec)
        enc.change({"key": "k", "change": 1, "from": 0, "to": 1})
        enc.blob(3).end(b"abc")
        enc.finalize()
        assert dec.finished
        snap = metrics.snapshot()
        assert not any(snap["counters"].values())
        assert not any(snap["gauges"].values())
        assert not any(h["count"] for h in snap["histograms"].values())
        assert events.EVENTS.events() == [] and tracing.SPANS.spans() == []
    finally:
        metrics.OBS.on = was_on


def test_event_ring_wraps_and_counts_drops(port_obs):
    log = events.EventLog(capacity=4)
    for i in range(10):
        log.emit("t.ev", i=i)
    got = log.events()
    assert [r["fields"]["i"] for r in got] == [6, 7, 8, 9]
    assert [r["seq"] for r in got] == [6, 7, 8, 9]
    assert log.dropped == 6 and log.count("t.ev") == 4
    assert log.last()["fields"] == {"i": 9}
    log.clear()
    assert log.events() == [] and log.dropped == 0
    log.emit("t.ev")
    assert log.events()[0]["seq"] == 10  # seq keeps counting


def test_resize_keeps_the_newest_records(port_obs):
    log = events.EventLog(capacity=4)
    for i in range(6):
        log.emit("t.ev", i=i)
    log.resize(2)
    assert [r["fields"]["i"] for r in log.events()] == [4, 5]
    log.resize(8)
    for i in range(6, 12):
        log.emit("t.ev", i=i)
    assert [r["fields"]["i"] for r in log.events()] == list(range(4, 12))
    with pytest.raises(ValueError):
        log.resize(0)


def test_event_emit_is_dark_while_gate_off():
    log = events.EventLog()
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    try:
        log.emit("t.ev", x=1)
    finally:
        metrics.OBS.on = was_on
    assert log.events() == []


def test_event_sink_writes_one_json_line_per_record(port_obs):
    import json

    log = events.EventLog()
    buf = io.StringIO()
    log.attach_sink(buf)
    log.emit("t.a", x=1)
    log.emit("t.b", y="z")
    log.detach_sink()
    log.emit("t.c")
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert [r["event"] for r in lines] == ["t.a", "t.b"]
    assert lines[1]["fields"] == {"y": "z"}


def _fill_pipe(w: int) -> int:
    total = 0
    while True:
        try:
            total += os.write(w, b"x" * 65536)
        except BlockingIOError:
            return total


def _drain(r: int) -> bytes:
    os.set_blocking(r, False)
    out = b""
    while True:
        try:
            chunk = os.read(r, 65536)
        except BlockingIOError:
            return out
        if not chunk:
            return out
        out += chunk


def test_fd_sink_drops_whole_records_and_never_tears_two(port_obs):
    """A full non-blocking pipe: a record that cannot start is dropped
    whole and the next one lands once there is room; a record that can
    only partly fit either tears (the sink latches dead, nothing follows
    the fragment) or is refused whole, as the kernel decides; a re-attach
    clears the latch."""
    import json

    r, w = os.pipe()
    os.set_blocking(w, False)
    try:
        log = events.EventLog()
        log.attach_sink(w)
        _fill_pipe(w)
        log.emit("t.full", i=1)
        assert log.sink_dropped == 1
        assert b"t.full" not in _drain(r)
        log.emit("t.retry", i=2)
        assert json.loads(_drain(r).decode())["event"] == "t.retry"
        filled = _fill_pipe(w)
        os.read(r, 64)
        log.emit("t.torn", pad="y" * 4096)
        log.emit("t.after", i=3)
        assert log.sink_dropped == 3
        drained = _drain(r)
        assert b"t.after" not in drained
        torn = len(drained) - (filled - 64)
        assert torn in (0, 64)
        if torn:
            assert not drained.endswith(b"\n")
        log.attach_sink(w)
        log.emit("t.reborn")
        assert json.loads(_drain(r).decode())["event"] == "t.reborn"
    finally:
        os.close(r)
        os.close(w)
