"""The port's sidecar over TCP, and its anti-entropy modes.

``serve_tcp(max_sessions=, ready_cb=)`` runs on ``127.0.0.1:0`` in a
thread: its digest reply must equal the ``--stdio`` reply
(``run_session`` over a byte pair) for the same request; ``--reconcile``
and ``--snapshot`` sessions are served to a port client and to a JAX
client; a client that never reads its reply is released by a short
``drain_timeout``; ``main()`` parses the new flags and the loaders read
files.  Every wait is bounded.
"""

import io
import socket
import threading
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu.runtime import reconcile_driver as J
from dat_replication_protocol_tpu.runtime import snapshot_driver as JS
from dat_replication_protocol_tpu_torch import encode, sidecar
from dat_replication_protocol_tpu_torch.runtime import reconcile_driver as P
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.runtime import snapshot_driver as PS
from dat_replication_protocol_tpu_torch.session.reconnect import (
    BackoffPolicy, retrying)
from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

WAIT = 30.0


def _serve(max_sessions=1, **kw):
    port = {}
    ready = threading.Event()
    t = threading.Thread(target=sidecar.serve_tcp, daemon=True,
                         args=("127.0.0.1", 0),
                         kwargs={"max_sessions": max_sessions,
                                 "device": "cpu",
                                 "ready_cb": lambda p: (port.setdefault(
                                     "p", p), ready.set()), **kw})
    t.start()
    assert ready.wait(WAIT)
    return t, port["p"]


def _connect(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
    s.settimeout(WAIT)
    return s


def _request() -> bytes:
    e = encode()
    for i in range(6):
        e.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                  "value": bytes([i]) * 40})
        if i == 2:
            e.blob(70_000).end(b"q" * 70_000)
    e.finalize()
    out = bytearray()
    while (c := e.read()) is not None:
        out += c
    return bytes(out)


def test_the_tcp_digest_reply_equals_the_stdio_reply():
    wire = _request()
    stdio = bytearray()
    out = sidecar.run_session(io.BytesIO(wire).read, stdio.extend,
                              device="cpu")
    assert out["ok"] and out["digests"] == 7
    t, port = _serve()
    s = _connect(port)
    s.sendall(wire)
    s.shutdown(socket.SHUT_WR)
    reply = bytearray()
    while chunk := s.recv(65536):
        reply += chunk
    s.close()
    t.join(WAIT)
    assert not t.is_alive()
    assert bytes(reply) == bytes(stdio)


def _records(n, lo=0, seed=3):
    rng = np.random.default_rng(seed)
    return [{"key": f"r{i:05d}", "change": i, "from": 0, "to": 1,
             "value": rng.bytes(int(rng.integers(1, 60))),
             "subset": None if i % 4 else "s"} for i in range(lo, lo + n)]


def _received(recs):
    return sorted((c.key, c.change, c.value or b"", c.subset or "")
                  for c in recs)


@pytest.mark.parametrize("client", ["port", "jax"])
def test_reconcile_sessions_are_served_over_tcp(client, tmp_path):
    rows = _records(1500)
    wa = replay.encode_change_log(rows[:1400] + _records(20, 5000))
    wb = replay.encode_change_log(rows[30:])
    path = tmp_path / "b.log"
    path.write_bytes(wb)
    replica = sidecar.load_reconcile_replica(str(path), device="cpu")
    assert np.array_equal(replica.digests, J.RatelessReplica(wb).digests)
    t, port = _serve(reconcile_replica=replica)
    s = _connect(port)
    if client == "port":
        res = P.run_initiator(P.RatelessReplica(wa, device="cpu"), s.recv,
                              s.sendall,
                              lambda: s.shutdown(socket.SHUT_WR))
    else:
        res = J.run_initiator(J.RatelessReplica(wa), s.recv, s.sendall,
                              lambda: s.shutdown(socket.SHUT_WR),
                              engine="host")
    s.close()
    t.join(WAIT)
    assert res["ok"] and res["records_sent"] == 20 + 30
    assert len(res["received"]) == 100


@pytest.mark.parametrize("client", ["port", "jax"])
def test_snapshot_sessions_are_served_over_tcp(client, tmp_path):
    data = np.random.default_rng(4).integers(0, 256, 300_000,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "data.bin"
    path.write_bytes(data)
    source = sidecar.load_snapshot_source(str(path), wire_offset=77,
                                          device="cpu")
    assert source.manifest.wire_offset == 77
    t, port = _serve(max_sessions=2, snapshot_source=source)
    have = bytearray(data)
    have[1000] ^= 1
    for h in (None, bytes(have)):
        s = _connect(port)
        if client == "port":
            res = PS.run_snapshot_joiner(s.recv, s.sendall,
                                         lambda: s.shutdown(socket.SHUT_WR),
                                         have=h, device="cpu")
        else:
            res = JS.run_snapshot_joiner(s.recv, s.sendall,
                                         lambda: s.shutdown(socket.SHUT_WR),
                                         have=h, engine="host")
        s.close()
        assert res["data"] == data and res["wire_offset"] == 77
    t.join(WAIT)
    assert not t.is_alive()


def test_a_garbage_client_gets_eof_and_the_daemon_serves_on(tmp_path):
    wb = replay.encode_change_log(_records(200))
    replica = P.RatelessReplica(wb, device="cpu")
    t, port = _serve(max_sessions=2, reconcile_replica=replica)
    s = _connect(port)
    s.sendall(b"\xff" * 64)
    s.shutdown(socket.SHUT_WR)
    got = bytearray()
    while chunk := s.recv(4096):
        got += chunk
    s.close()
    s = _connect(port)
    res = P.run_initiator(P.RatelessReplica(wb, device="cpu"), s.recv,
                          s.sendall, lambda: s.shutdown(socket.SHUT_WR))
    s.close()
    t.join(WAIT)
    assert res["ok"] and res["records_sent"] == 0


def test_a_client_that_never_reads_is_released_by_the_drain_timeout():
    # the reply writer parks until close_write fires, as a socket write
    # to a client that stopped reading would
    wire = _request()
    released = threading.Event()
    closed = []

    def park(_data):
        released.wait(WAIT)

    def close_write():
        closed.append(1)
        released.set()

    t0 = time.monotonic()
    out = sidecar.run_session(io.BytesIO(wire).read, park,
                              close_write=close_write, device="cpu",
                              drain_timeout=0.5)
    assert out["ok"] is False and closed == [1]
    assert time.monotonic() - t0 < 10


def test_bind_retries_through_a_held_port():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    threading.Timer(0.3, blocker.close).start()
    srv = {}

    def bind():
        s = socket.socket()
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            s.close()
            raise
        return s

    srv["s"] = retrying(bind, BackoffPolicy(base=0.05, cap=0.2,
                                            max_retries=50, seed=1))
    srv["s"].close()
    with pytest.raises(ProtocolError, match="failed after 2 attempt"):
        retrying(lambda: (_ for _ in ()).throw(OSError("nope")),
                 BackoffPolicy(base=0, max_retries=1), describe="probe")


def test_main_parses_the_new_flags(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(sidecar, "serve_tcp",
                        lambda host, port, **kw: calls.update(
                            host=host, port=port, **kw))
    log = tmp_path / "a.log"
    log.write_bytes(replay.encode_change_log(_records(10)))
    assert sidecar.main(["--tcp", "127.0.0.1:0", "--reconcile", str(log),
                         "--device", "cpu", "--drain-timeout", "0",
                         "--max-retries", "3", "--backoff-base", "0.5"]) == 0
    assert (calls["host"], calls["port"], calls["device"]) \
        == ("127.0.0.1", 0, "cpu")
    assert calls["drain_timeout"] is None and calls["snapshot_source"] is None
    assert calls["reconcile_replica"].n == 10
    assert (calls["retry_policy"].max_retries,
            calls["retry_policy"].base) == (3, 0.5)
    data = tmp_path / "d.bin"
    data.write_bytes(b"z" * 5000)
    calls.clear()
    sidecar.main(["--tcp", ":7000", "--snapshot", str(data),
                  "--snapshot-offset", "9", "--device", "cpu"])
    assert (calls["host"], calls["port"]) == ("127.0.0.1", 7000)
    assert calls["snapshot_source"].manifest.wire_offset == 9
    assert calls["drain_timeout"] == sidecar.DEFAULT_DRAIN_TIMEOUT
    for bad in ([], ["--stdio", "--tcp", "h:1"],
                ["--tcp", "h:1", "--reconcile", "a", "--snapshot", "b"],
                ["--stdio", "--hub"],
                ["--tcp", "h:1", "--hub", "--reconcile", "a"],
                ["--tcp", "h:1", "--hub", "--snapshot", "b"],
                ["--tcp", "h:1", "--hub-mesh", "auto"],
                ["--tcp", "h:1", "--stats-format", "xml"]):
        with pytest.raises(SystemExit):
            sidecar.main(bad)


def test_a_crowd_of_joiners_shares_one_source():
    # more joiner threads than cores on one shared source, with a short
    # switch interval: the cold log and the symbol prefix are built once
    # under their locks, and every joiner assembles the dataset
    import os
    import sys

    data = np.random.default_rng(12).integers(0, 256, 60_000,
                                              dtype=np.uint8)
    source = PS.SnapshotSource(data, device="cpu")
    n = (os.cpu_count() or 4) + 4
    have = data.copy()
    have[source.offs[::4]] ^= 1
    t, port = _serve(max_sessions=n, snapshot_source=source)
    results = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)

    def join(i):
        s = _connect(port)
        try:
            results[i] = PS.run_snapshot_joiner(
                s.recv, s.sendall, lambda: s.shutdown(socket.SHUT_WR),
                have=have if i == 1 else None, device="cpu")
        finally:
            s.close()

    try:
        threads = [threading.Thread(target=join, args=(i,), daemon=True)
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    t.join(WAIT)
    assert not t.is_alive()
    assert all(r is not None and r["data"] == data.tobytes()
               for r in results)
    assert source.cold_log() is source.cold_log()
    assert source.weighted_symbols() is source.weighted_symbols()
