"""FaultPlan chaos over the port's edge session table.

The JAX package's sweep of ``test_edge_chaos.py`` on the port, seeds
0-19: four mixed-QoS hub sessions through ONE
:class:`~dat_replication_protocol_tpu_torch.edge.EdgeLoop`, the session
that ``FaultPlan.faulty_session`` elects misbehaving as its
``FaultPlan.session_scenario`` says (``stall``, ``truncate`` or
``flip``).  The faulted session ends in a not-ok record and never hangs,
a reconnect from it completes a clean session, and every healthy
neighbour's reply is byte-exact against ``hashlib`` within the 5.0 s
budget.  Then the mixed-modes case: a faulted hub session beside a live
reconcile responder in the same table.
"""

import hashlib
import socket
import threading
import time

import pytest

from dat_replication_protocol_tpu_torch import decode, sidecar
from dat_replication_protocol_tpu_torch.edge import EdgeLoop
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.obs import events, metrics
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
    RatelessReplica, run_initiator)
from dat_replication_protocol_tpu_torch.session.faults import FaultPlan

from test_wire_fixtures import CHANGE_PAYLOAD, SESSION_4

N_SESSIONS = 4
SEEDS = range(20)

# a neighbour contaminated by the fault (the stall parks its socket
# ~0.3 s; the teardown runs on the loop's tick) would blow well past this
P99_BUDGET_S = 5.0

_BLOB_DIGEST = hashlib.blake2b(b"hello world", digest_size=32).digest()
_CHANGE_DIGEST = hashlib.blake2b(CHANGE_PAYLOAD, digest_size=32).digest()


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    metrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()


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


def _healthy_client(addr, results, i):
    t0 = time.monotonic()
    c = socket.create_connection(addr, timeout=10)
    c.settimeout(15)
    c.sendall(SESSION_4)
    c.shutdown(socket.SHUT_WR)
    reply = _decode_reply(_recv_all(c))
    c.close()
    results[i] = (reply, time.monotonic() - t0)


def _faulty_client(addr, scenario: str):
    c = socket.create_connection(addr, timeout=10)
    c.settimeout(15)
    half = len(SESSION_4) // 2
    if scenario == "flip":
        # one bit of wire corruption mid-stream: a structured destroy,
        # the reply answered with EOF
        bad = bytearray(SESSION_4)
        bad[half] ^= 0x40
        c.sendall(bytes(bad))
        c.shutdown(socket.SHUT_WR)
        _recv_all(c)
    elif scenario == "truncate":
        # a clean-looking EOF mid-frame
        c.sendall(SESSION_4[:half])
        c.shutdown(socket.SHUT_WR)
        _recv_all(c)
    else:  # stall: park mid-wire, then go without a clean shutdown
        c.sendall(SESSION_4[:half])
        time.sleep(0.3)
    c.close()


def _serve(loop) -> tuple:
    port = loop.bind("127.0.0.1", 0)
    t = threading.Thread(target=loop.serve, daemon=True)
    t.start()
    return port, t


def _stop(loop, t) -> None:
    """A test that fails mid-way leaves its loop serving: stop it, so its
    turns do not land in a later test's telemetry."""
    if t is not None and t.is_alive():
        loop.close()
        t.join(10)


def _session_records() -> list:
    return [e["fields"] for e in events.EVENTS.events("sidecar.session")]


@pytest.mark.parametrize("seed", SEEDS)
def test_chaos_sweep_faulted_session_never_perturbs_neighbors(seed,
                                                              port_obs):
    faulty = FaultPlan.faulty_session(seed, N_SESSIONS)
    scenario = FaultPlan.session_scenario(seed, N_SESSIONS)
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    qos_of = lambda n, peer, mode: \
        "latency" if n % 2 else "throughput"  # noqa: E731
    # +1: the faulted session RECONNECTS after its teardown
    loop = EdgeLoop(hub, qos_of=qos_of, max_sessions=N_SESSIONS + 1,
                    drain_timeout=2.0, tick=0.02)
    results = {}
    t = None
    try:
        port, t = _serve(loop)
        addr = ("127.0.0.1", port)
        threads = []
        for i in range(N_SESSIONS):
            if i == faulty:
                th = threading.Thread(target=_faulty_client,
                                      args=(addr, scenario), daemon=True)
            else:
                th = threading.Thread(target=_healthy_client,
                                      args=(addr, results, i), daemon=True)
            threads.append(th)
            th.start()
            time.sleep(0.02)  # a deterministic admission order
        for th in threads:
            th.join(20)
            assert not th.is_alive(), f"client HANG (seed {seed})"
        # the faulted peer reconnects and completes a clean session
        resume = {}
        _healthy_client(addr, resume, "resume")
        t.join(timeout=15)
        assert not t.is_alive(), f"loop HANG (seed {seed})"
    finally:
        _stop(loop, t)
        hub.close()
    for i, (reply, elapsed) in results.items():
        by_key = {ch.key: ch for ch in reply}
        assert set(by_key) == {"blob-0", "change-0"}, (
            f"seed {seed} ({scenario}): neighbour {i} reply perturbed")
        assert by_key["blob-0"].value == _BLOB_DIGEST
        assert by_key["change-0"].value == _CHANGE_DIGEST
        assert elapsed < P99_BUDGET_S, (
            f"seed {seed} ({scenario}): neighbour {i} took {elapsed:.2f} s")
    reply, _ = resume["resume"]
    assert {ch.key for ch in reply} == {"blob-0", "change-0"}, (
        f"seed {seed} ({scenario}): the faulted peer did not resume")
    recs = _session_records()
    assert len(recs) == N_SESSIONS + 1
    bad = [r for r in recs if not r["ok"]]
    assert len(bad) == 1, f"seed {seed} ({scenario}): {recs}"


def test_chaos_mixed_modes_fault_isolated_across_legs(tmp_path, port_obs):
    logfile = tmp_path / "log.bin"
    logfile.write_bytes(replay.encode_change_log(
        [{"key": "srv-only", "change": 0, "from": 0, "to": 1,
          "value": b"v"}]))
    replica = sidecar.load_reconcile_replica(str(logfile), device="cpu")
    client = RatelessReplica([], device="cpu")
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    mode_of = lambda n, peer: \
        "hub" if n in (1, 3) else "reconcile"  # noqa: E731
    loop = EdgeLoop(hub, reconcile_replica=replica, mode_of=mode_of,
                    max_sessions=3, drain_timeout=2.0, tick=0.02)
    t = None
    try:
        port, t = _serve(loop)
        addr = ("127.0.0.1", port)
        # n=1: the faulted hub session (corrupt wire)
        fth = threading.Thread(target=_faulty_client,
                               args=(addr, "flip"), daemon=True)
        fth.start()
        time.sleep(0.05)
        # n=2: the reconcile responder, beside the fault
        c = socket.create_connection(addr, timeout=10)
        out = run_initiator(
            client, c.recv, c.sendall,
            close_write=lambda: c.shutdown(socket.SHUT_WR))
        c.close()
        assert out["ok"]
        assert {ch.key for ch in out["received"]} == {"srv-only"}
        fth.join(15)
        assert not fth.is_alive()
        # n=3: a clean hub session after the fault: the table recovered
        results = {}
        _healthy_client(addr, results, "after")
        t.join(timeout=15)
        assert not t.is_alive()
        assert {ch.key for ch in results["after"][0]} == {"blob-0",
                                                          "change-0"}
    finally:
        _stop(loop, t)
        hub.close()
    recs = _session_records()
    assert [r["ok"] for r in recs if "session" in r] == [False, True]
    assert [r["ok"] for r in recs if r.get("reconcile")] == [True]
