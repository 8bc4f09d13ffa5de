"""The port's loop profiler against the JAX package's.

The JAX package's twelve cases of ``test_loopprof.py``, run on the port:

* **Span tiling**: recorded ``edge.turn`` spans tile the loop's wall time
  exactly (``span[i+1].ts == span[i].ts + span[i].dur``, float equality);
  idle turns coalesce into the next active span and the shutdown flush
  closes the trailing idle stretch.
* **The dark path**: with the obs gate off the dispatcher runs the dark
  twin (one attribute load, no profiler name in its bytecode, no
  ``edge.turn`` span, no ``edge.loop.turns``).
* **Lag**: ``lag = max(0, work_s - tick)``; a clean turn is exactly 0.0,
  a stalled turn reads its overrun, the live view extrapolates mid-turn,
  and the watermark board exports ``edge.loop.lag{loop=}`` only while
  live; ``/healthz`` grows a ``loop_lag`` stage.

Then one JAX and one port :class:`LoopProfiler` driven by the same
synthetic clock (seeded floats): ``export()``, ``state()``, the
``edge.turn`` spans and the ``edge.turn.*_s`` histogram counts are equal.
"""

import random
import socket
import threading
import time

import pytest

from dat_replication_protocol_tpu.obs import loopprof as jax_loopprof
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.obs import tracing as jtracing
from dat_replication_protocol_tpu.obs import watermarks as jwatermarks
from dat_replication_protocol_tpu_torch.edge import EdgeLoop
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.obs import events, metrics, tracing
from dat_replication_protocol_tpu_torch.obs import loopprof
from dat_replication_protocol_tpu_torch.obs.loopprof import (
    PHASES, LoopProfiler)
from dat_replication_protocol_tpu_torch.obs.tracing import SPANS
from dat_replication_protocol_tpu_torch.obs.watermarks import WATERMARKS

from test_wire_fixtures import SESSION_1


@pytest.fixture
def port_obs():
    """The port's gate on, with clean registry, rings and board."""
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    tracing.SPANS.clear()
    WATERMARKS.reset_for_tests()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        tracing.SPANS.clear()
        WATERMARKS.reset_for_tests()


def _recv_all(sock: socket.socket) -> bytes:
    parts = []
    while True:
        d = sock.recv(65536)
        if not d:
            return b"".join(parts)
        parts.append(d)


def _hub() -> ReplicationHub:
    return ReplicationHub(device="cpu", linger_s=0.002)


def _run_sessions(loop: EdgeLoop, n: int) -> None:
    """Serve ``n`` reference sessions through a bound loop thread and
    join it (``max_sessions`` must equal ``n``)."""
    port = loop.bind("127.0.0.1", 0)
    t = threading.Thread(target=loop.serve, daemon=True)
    t.start()
    try:
        for _ in range(n):
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.sendall(SESSION_1)
            c.shutdown(socket.SHUT_WR)
            assert _recv_all(c)
            c.close()
    finally:
        loop.close()
        t.join(timeout=10)
    assert not t.is_alive()


def _loop_spans(name: str) -> list:
    return [r for r in SPANS.spans("edge.turn")
            if r["fields"]["loop"] == name]


# -- span tiling ---------------------------------------------------------------


def test_edge_turn_spans_tile_exactly(port_obs):
    hub = _hub()
    loop = EdgeLoop(hub, max_sessions=3, tick=0.01, profile_every=1)
    try:
        _run_sessions(loop, 3)
    finally:
        hub.close()
    spans = _loop_spans(loop.profiler.name)
    assert len(spans) >= 3  # at least one active span a session
    for prev, nxt in zip(spans, spans[1:]):
        assert nxt["ts"] == prev["ts"] + prev["dur"]  # float-exact
    for r in spans:
        f = r["fields"]
        if f["work_s"] == 0.0:
            continue  # the trailing idle flush has the short shape
        for name in PHASES:
            assert name.replace("-", "_") + "_s" in f
        assert f["lag_s"] >= 0.0 and f["tick"] == 0.01


def test_idle_turns_coalesce_and_flush_covers_the_tail(port_obs):
    hub = _hub()
    loop = EdgeLoop(hub, tick=0.005, profile_every=1)
    port = loop.bind("127.0.0.1", 0)
    t = threading.Thread(target=loop.serve, daemon=True)
    t.start()
    try:
        c = socket.create_connection(("127.0.0.1", port), timeout=10)
        c.sendall(SESSION_1)
        c.shutdown(socket.SHUT_WR)
        assert _recv_all(c)
        c.close()
        time.sleep(0.1)  # the loop idles: a dozen quiet turns or more
    finally:
        loop.close()
        t.join(timeout=10)
        hub.close()
    spans = _loop_spans(loop.profiler.name)
    assert spans, "no spans recorded"
    tail = spans[-1]
    assert tail["fields"]["turns"] >= 2
    assert tail["fields"]["work_s"] == 0.0
    assert tail["fields"]["poll_wait_s"] > 0.0
    for prev, nxt in zip(spans, spans[1:]):
        assert nxt["ts"] == prev["ts"] + prev["dur"]


# -- the dark path -------------------------------------------------------------


def test_dark_turn_never_touches_the_profiler():
    """Bytecode: the dark twin names no profiler at all; the per-turn
    gate fork lives in ``_dispatch_loop``."""
    dark = EdgeLoop._dark_turn.__code__
    assert "profiler" not in dark.co_names
    assert not any("prof" in n for n in dark.co_names + dark.co_varnames)
    dispatch = EdgeLoop._dispatch_loop.__code__
    assert "_OBS" in dispatch.co_names and "on" in dispatch.co_names
    assert "_lit_turn" in dispatch.co_names
    assert "_dark_turn" in dispatch.co_names


def test_gate_off_records_nothing():
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    loop = None
    try:
        before = len(SPANS.spans("edge.turn"))
        turns = loopprof._M_TURNS.value
        hub = _hub()
        loop = EdgeLoop(hub, max_sessions=1, tick=0.01)
        try:
            _run_sessions(loop, 1)
        finally:
            hub.close()
        assert len(SPANS.spans("edge.turn")) == before
        assert loopprof._M_TURNS.value == turns
        assert loop.profiler.turns == 0
        assert loop.profiler.lag_max_s == 0.0
    finally:
        metrics.OBS.on = was_on
        if loop is not None:
            WATERMARKS.untrack_loop(loop.profiler.name)


# -- lag (the profiler driven by hand) -----------------------------------------


def test_clean_turn_lag_is_exactly_zero():
    prof = LoopProfiler("unit", tick=0.05)
    t0 = 100.0
    prof.turn_begin(t0)
    prof.poll_done(t0 + 0.05, 0)          # a full quiet tick of poll
    prof.turn_done(t0 + 0.0501)           # 100 us of sweep
    assert prof.lag_s == 0.0              # exactly zero
    assert prof.lag_max_s == 0.0
    assert prof.turns == 1 and prof.active_turns == 0


def test_stalled_turn_reads_its_overrun():
    prof = LoopProfiler("unit", tick=0.05)
    t0 = 100.0
    prof.turn_begin(t0)
    prof.poll_done(t0 + 0.001, 1)
    prof.account("read", "c1:peer", 0.3, 4096)
    prof.turn_done(t0 + 0.001 + 0.35, sessions=1)
    assert abs(prof.lag_s - 0.30) < 1e-9  # 0.35 of work - a 0.05 tick
    assert prof.lag_max_s == prof.lag_s
    assert prof.active_turns == 1


def test_live_lag_extrapolates_mid_turn():
    prof = LoopProfiler("unit", tick=0.05)
    prof.turn_begin(100.0)
    prof.poll_done(100.001, 1)            # work begins and never ends
    assert prof.live_lag(now=100.001 + 0.5) > 0.4
    assert prof.oldest_ready_s(now=100.001 + 0.5) > 0.4
    assert prof.export()["behind"]
    prof.turn_done(100.001 + 0.5, sessions=1)
    assert prof.live_lag(now=200.0) == prof.lag_s  # idle: no extrapolation


def test_turn_profiler_top_k_ranks_heaviest_sessions(port_obs):
    prof = LoopProfiler("unit", tick=0.01, top_k=2)
    t0 = 50.0
    prof.turn_begin(t0)
    prof.poll_done(t0 + 0.001, 3)
    prof.account("read", "c1:a", 0.002, 100)
    prof.account("read", "c2:b", 0.200, 9000)
    prof.account("tx", "c2:b", 0.010, 500)
    prof.account("tx", "c3:c", 0.050, 50)
    prof.turn_done(t0 + 0.001 + 0.262, sessions=3)
    top = _loop_spans("unit")[-1]["fields"]["top"]
    assert [e["session"] for e in top] == ["c2:b", "c3:c"]  # top_k=2
    assert top[0]["phase"] == "read"      # 0.200 read against 0.010 tx
    assert top[0]["bytes"] == 9500
    assert top[1]["phase"] == "tx"


def test_sampling_gates_top_capture_on_clean_turns(port_obs):
    prof = LoopProfiler("unit2", tick=10.0, sample_every=4)
    t = 0.0
    for _ in range(8):
        prof.turn_begin(t)
        prof.poll_done(t + 0.001, 1)
        prof.account("read", "c1:a", 0.001, 10)
        t += 0.01
        prof.turn_done(t, sessions=1)
    spans = _loop_spans("unit2")
    assert len(spans) == 8
    with_top = [i for i, r in enumerate(spans) if "top" in r["fields"]]
    assert with_top == [3, 7]  # active turns 4 and 8


# -- the watermark board and /healthz ------------------------------------------


def test_loop_lag_gauges_ride_the_watermark_board(port_obs):
    prof = LoopProfiler("wmtest", tick=0.05)
    prof.attach()
    try:
        prof.turn_begin(10.0)
        prof.poll_done(10.001, 1)
        prof.turn_done(10.001 + 0.25, sessions=1)  # 0.2 s of lag
        snap = port_obs.REGISTRY.snapshot()["gauges"]
        assert snap["edge.loop.lag{loop=wmtest}"] == prof.lag_s
        assert snap["edge.loop.lag_max{loop=wmtest}"] == prof.lag_max_s
        board = WATERMARKS.snapshot()
        assert board["loops"]["wmtest"]["state"] == "live"
        assert board["loops"]["wmtest"]["behind"]
    finally:
        prof.detach()
    assert "wmtest" not in WATERMARKS.snapshot().get("loops", {})


def test_dark_loop_exports_state_not_gauges(port_obs):
    prof = LoopProfiler("darkwm", tick=0.05)
    prof.attach()
    try:
        metrics.OBS.on = False
        snap = metrics.REGISTRY.snapshot()["gauges"]
        assert "edge.loop.lag{loop=darkwm}" not in snap
        assert WATERMARKS.snapshot()["loops"]["darkwm"]["state"] == "dark"
    finally:
        metrics.enable()
        prof.detach()


def test_healthz_loop_lag_stage_flips_and_recovers(port_obs):
    from dat_replication_protocol_tpu_torch.obs.http import default_healthz

    assert "loop_lag" not in default_healthz()["stages"]
    prof = LoopProfiler("hz", tick=0.05)
    prof.attach()
    try:
        # mid-stall: work began long ago and has not finished
        prof.turn_begin(time.monotonic() - 1.0)
        prof.poll_done(time.monotonic() - 1.0, 1)
        hz = default_healthz()
        assert not hz["ok"]
        assert hz["stages"]["loop_lag"]["behind"] == ["hz"]
        assert hz["stages"]["loop_lag"]["lag_s"]["hz"] > 0.5
        # the stall ends; the next clean turn recovers the probe
        prof.turn_done(time.monotonic())
        prof.turn_begin(time.monotonic())
        prof.poll_done(time.monotonic(), 0)
        prof.turn_done(time.monotonic())
        hz = default_healthz()
        assert hz["ok"] and hz["stages"]["loop_lag"]["ok"]
    finally:
        prof.detach()


# -- the same synthetic clock through both profilers ---------------------------


def _script(seed: int, turns: int = 200) -> list:
    """A seeded turn schedule: quiet turns, clean active turns, overruns
    and sessions, every float from ``random.Random(seed)``."""
    rng = random.Random(seed)
    out = []
    t = 1000.0 + rng.random()
    for _ in range(turns):
        poll = rng.uniform(0.0, 0.02)
        kind = rng.random()
        steps = []
        if kind < 0.3:
            work = rng.uniform(0.0, 0.001)   # an idle turn
        else:
            if rng.random() < 0.2:
                steps.append(("phase", "accept", rng.uniform(0, 1e-3)))
            for _ in range(rng.randint(1, 5)):
                steps.append(("account", rng.choice(PHASES[1:]),
                              f"c{rng.randint(1, 9)}:127.0.0.1:{rng.randint(1, 9)}",
                              rng.uniform(0, 4e-3), rng.randint(0, 1 << 20)))
            work = rng.uniform(0.0, 0.03)   # some overrun the tick
        out.append((t, t + poll, 0 if kind < 0.3 else len(steps), steps,
                    t + poll + work, rng.randint(0, 64)))
        t += poll + work
    return out


def _drive(prof, script) -> None:
    for t0, t_poll, nready, steps, t_end, sessions in script:
        prof.turn_begin(t0)
        prof.poll_done(t_poll, nready)
        for step in steps:
            if step[0] == "phase":
                prof.phase(step[1], step[2])
            else:
                prof.account(*step[1:])
        prof.turn_done(t_end, sessions=sessions)
    prof.flush(script[-1][4] + 0.5)


_HISTS = ("poll_wait_s", "accept_s", "read_s", "hub_drain_s", "tx_s",
          "overload_ladder_s", "work_s")


def _hist_counts(snap: dict) -> dict:
    hists = snap["histograms"]
    return {h: hists[f"edge.turn.{h}"]["count"] for h in _HISTS}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_clock_gives_the_jax_profilers_record(seed, port_obs,
                                                    obs_enabled):
    script = _script(seed)
    name = f"clock{seed}"
    port = LoopProfiler(name, tick=0.01, sample_every=5, top_k=3)
    jax = jax_loopprof.LoopProfiler(name, tick=0.01, sample_every=5,
                                    top_k=3)
    _drive(port, script)
    _drive(jax, script)
    assert port.export() == jax.export()
    assert port.state() == jax.state()
    got = [(r["span"], r["ts"], r["dur"], r["fields"])
           for r in SPANS.spans("edge.turn")]
    want = [(r["span"], r["ts"], r["dur"], r["fields"])
            for r in jtracing.SPANS.spans("edge.turn")]
    assert got == want
    assert any("top" in f for *_, f in got)
    assert _hist_counts(metrics.snapshot()) == _hist_counts(
        jmetrics.snapshot())
    assert metrics.snapshot()["counters"]["edge.loop.turns"] == len(script)
    # the board's record of each, while attached
    port.attach()
    jax.attach()
    try:
        assert (WATERMARKS.snapshot()["loops"][name]
                == jwatermarks.WATERMARKS.snapshot()["loops"][name])
    finally:
        port.detach(now=script[-1][4] + 1.0)
        jax.detach(now=script[-1][4] + 1.0)
