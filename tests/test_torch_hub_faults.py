"""One misbehaving session cannot hurt its neighbours on the port's hub.

The neighbour-isolation sweep of ``tests/test_hub_faults.py`` at its 20
seeds, on the port's ``ReplicationHub`` (plain B1, ``device="cpu"``):
eight concurrent sessions a seed, exactly one of which
(``FaultPlan.faulty_session``) runs the seed's stall, truncate or flip
plan through the JAX package's ``FaultyReader``; the others run benign
plans.  Every healthy session must finish with the digest stream the
JAX package's decoder gives for its wire; the faulted one is resumed,
shed or torn down with one structured error, never hung; any
``hub.shed`` event names only it.  The port has no resume layer yet, so
a truncated connection is resumed here by feeding the same decoder from
its ``bytes`` count, which is the reference checkpoint's
``wire_offset``.  Then three targeted arms: a long stall, a truncation
inside a blob, and a garbage session torn down alone.
"""

from __future__ import annotations

import threading
import time

import pytest

import dat_replication_protocol_tpu as jax_protocol
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu.obs.events import EVENTS as JAX_EVENTS
from dat_replication_protocol_tpu.session.faults import (
    FaultPlan,
    FaultyReader,
    TransportFault,
    bytes_reader,
)
from dat_replication_protocol_tpu_torch.hub import (
    HubError,
    ReplicationHub,
    SessionShed,
)
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.session.decoder import (
    DecoderDestroyedError,
)
from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

N_SESSIONS = 8
HARD_TIMEOUT = 25.0


def _build_wire(i: int) -> bytes:
    """The reference test's per-session wire: a change run, a 1,100-byte
    blob with a change parked behind it, and a tail."""
    e = protocol.encode()
    for j in range(24):
        e.change({"key": f"s{i}-b{j}", "change": j, "from": j, "to": j + 1,
                  "value": b"v%02d-%03d" % (i, j)})
    big = e.blob(1100)
    big.write(bytes([(i * 7 + k) % 251 for k in range(600)]))
    e.change({"key": f"s{i}-parked", "change": 99, "from": 0, "to": 1,
              "value": b"after-blob-%d" % i})
    big.end(bytes([(i * 13 + k) % 241 for k in range(500)]))
    for j in range(6):
        e.change({"key": f"s{i}-t{j}", "change": j, "from": j, "to": j + 1})
    e.finalize()
    return b"".join(iter(lambda: e.read(4096) or b"", b""))


_WIRES = [_build_wire(i) for i in range(N_SESSIONS)]


def _reference_digests(i: int) -> list:
    dec = jax_protocol.decode(backend="tpu")
    digs: list = []
    dec.on_digest(lambda kind, seq, d: digs.append((kind, seq, d)))
    dec.blob(lambda b, done: b.collect(lambda _data: done()))
    for off in range(0, len(_WIRES[i]), 777):
        dec.write(_WIRES[i][off:off + 777])
    dec.end()
    assert dec.finished
    return digs


_EXPECTED = [_reference_digests(i) for i in range(N_SESSIONS)]


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


def _hub_decoder(hub_session):
    dec = protocol.decode(backend="cuda", pipeline=hub_session)
    digs: list = []
    dec.on_digest(lambda kind, seq, d: digs.append((kind, seq, d)))
    dec.blob(lambda b, done: b.collect(lambda _data: done()))
    return dec, digs


def _feed(dec, reader, chunk: int) -> None:
    while not dec.destroyed:
        data = reader.read(chunk)
        if not data:
            return
        dec.write(data)


def _feed_resumable(dec, wire: bytes, plan_for, chunk: int = 512,
                    max_reconnects: int = 8) -> int:
    """Feed ``wire`` into ``dec`` over faulty connections: after a drop or
    an early EOF, reconnect from ``dec.bytes`` with ``plan_for(remaining,
    failures)``.  Returns the reconnects; raises the decoder's
    ProtocolError when it is destroyed."""
    errors: list = []
    dec.on_error(errors.append)
    failures = 0
    while True:
        off = dec.bytes
        reader = FaultyReader(bytes_reader(wire[off:]),
                              plan_for(len(wire) - off, failures))
        try:
            _feed(dec, reader, chunk)
        except TransportFault:
            pass
        except DecoderDestroyedError:
            pass
        if dec.destroyed:
            raise errors[0]
        if dec.bytes >= len(wire):
            dec.end()
            if dec.destroyed:
                raise errors[0]
            return failures
        failures += 1
        if failures > max_reconnects:
            raise ProtocolError("too many reconnects", offset=dec.bytes)


def _run_hub_seed(seed: int, hub: ReplicationHub):
    faulty = FaultPlan.faulty_session(seed, N_SESSIONS)
    results: dict = {}
    stats: dict = {}

    def healthy_run(i: int) -> None:
        wire = _WIRES[i]
        s = hub.register(f"seed{seed}-s{i}")
        try:
            dec, digs = _hub_decoder(s)
            plan = FaultPlan.for_sweep(seed, len(wire), attempt=0,
                                       session=i, n_sessions=N_SESSIONS)
            _feed(dec, FaultyReader(bytes_reader(wire), plan), 1024)
            dec.end()
            assert dec.finished, f"healthy session {i} did not finish"
            stats[i] = s.stats()
            results[i] = ("done", digs)
        finally:
            s.close()

    def faulty_run(i: int) -> None:
        wire = _WIRES[i]
        s = hub.register(f"seed{seed}-s{i}")
        try:
            dec, digs = _hub_decoder(s)
            try:
                _feed_resumable(
                    dec, wire,
                    lambda remaining, failures: FaultPlan.for_sweep(
                        seed, remaining, attempt=failures, session=i,
                        n_sessions=N_SESSIONS))
            except ProtocolError as e:
                assert e.offset is not None, f"unstructured error: {e}"
                results[i] = ("error", e)
                return
            except SessionShed as e:
                results[i] = ("shed", e)
                return
            stats[i] = s.stats()
            results[i] = ("done", digs)
        finally:
            s.close()

    threads = [threading.Thread(
        target=faulty_run if i == faulty else healthy_run, args=(i,),
        daemon=True) for i in range(N_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HARD_TIMEOUT)
    assert all(not t.is_alive() for t in threads), \
        f"HANG: seed {seed} sessions still running after {HARD_TIMEOUT}s"
    return results, stats, faulty


@pytest.mark.parametrize("seed", range(20))
def test_sweep_one_faulty_session_cannot_hurt_neighbours(seed, obs_enabled,
                                                         port_obs):
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    try:
        results, stats, faulty = _run_hub_seed(seed, hub)
    finally:
        hub.close()
    for i in range(N_SESSIONS):
        if i == faulty:
            continue
        outcome, digs = results[i]
        assert outcome == "done", f"healthy session {i}: {results[i]}"
        assert digs == _EXPECTED[i], f"healthy session {i} digests diverged"
        assert stats[i]["shed"] is None
        assert stats[i]["delivered"] == len(_EXPECTED[i])
    outcome, payload = results[faulty]
    assert outcome in ("done", "error", "shed"), results[faulty]
    scenario = FaultPlan.session_scenario(seed, N_SESSIONS)
    if outcome == "done" and scenario != "flip":
        assert payload == _EXPECTED[faulty]
    # the injector's own events say the predicted fault fired
    assert JAX_EVENTS.events(f"fault.{scenario}"), \
        f"predicted scenario {scenario!r} never fired (seed {seed})"
    for ev in events.EVENTS.events("hub.shed"):
        assert ev["fields"]["key"] == f"seed{seed}-s{faulty}"


def _run_arms(hub, special, special_fn, healthy_step=777):
    results: dict = {}

    def healthy_run(i: int) -> None:
        s = hub.register(f"h{i}")
        try:
            dec, digs = _hub_decoder(s)
            for off in range(0, len(_WIRES[i]), healthy_step):
                dec.write(_WIRES[i][off:off + healthy_step])
            dec.end()
            results[i] = (dec.finished, digs, time.monotonic())
        finally:
            s.close()

    def special_run() -> None:
        s = hub.register(special)
        try:
            results[special] = special_fn(s)
        finally:
            s.close()

    threads = [threading.Thread(target=special_run, daemon=True)]
    threads += [threading.Thread(target=healthy_run, args=(i,), daemon=True)
                for i in range(1, N_SESSIONS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(HARD_TIMEOUT)
    assert all(not t.is_alive() for t in threads), "HANG"
    for i in range(1, N_SESSIONS):
        finished, digs, _ = results[i]
        assert finished and digs == _EXPECTED[i]
    return results


def test_long_stall_does_not_stall_neighbours():
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    t0 = time.monotonic()

    def stalled(s):
        dec, digs = _hub_decoder(s)
        plan = FaultPlan(seed=1, stall_at=len(_WIRES[0]) // 2, stall_s=3.0)
        _feed(dec, FaultyReader(bytes_reader(_WIRES[0]), plan), 512)
        dec.end()
        assert dec.finished and digs == _EXPECTED[0]
        return time.monotonic() - t0

    try:
        results = _run_arms(hub, "staller", stalled)
    finally:
        hub.close()
    healthy = [results[i][2] - t0 for i in range(1, N_SESSIONS)]
    assert max(healthy) < 2.5, f"neighbours waited on the stall: {healthy}"
    assert results["staller"] >= 3.0


def test_mid_blob_truncation_resumes_while_neighbours_run():
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    wire = _WIRES[0]
    cut = int(len(wire) * 0.55)  # inside the 1,100-byte blob

    def truncated(s):
        dec, digs = _hub_decoder(s)
        reconnects = _feed_resumable(
            dec, wire,
            lambda remaining, failures: FaultPlan(
                seed=3, truncate_at=(cut if failures == 0 else None)))
        return reconnects, digs

    try:
        results = _run_arms(hub, "trunc", truncated, healthy_step=513)
    finally:
        hub.close()
    reconnects, digs = results["trunc"]
    assert reconnects == 1
    assert digs == _EXPECTED[0]  # exactly once across the reconnect


def test_garbage_session_is_torn_down_alone():
    hub = ReplicationHub(device="cpu", max_sessions=N_SESSIONS,
                         linger_s=0.002)

    def byzantine(s):
        dec, _digs = _hub_decoder(s)
        errs: list = []
        dec.on_error(errs.append)
        try:
            dec.write(b"\xff" * 64)
            dec.end()
        except (ProtocolError, DecoderDestroyedError, HubError):
            pass
        return errs

    try:
        results = _run_arms(hub, "byz", byzantine)
        errs = results["byz"]
        assert len(errs) == 1 and isinstance(errs[0], ProtocolError)
        assert errs[0].offset is not None
        # the slot was released: a full hub admits a replacement
        hub.register("fresh").close()
    finally:
        hub.close()
