"""The port's sidecar in hub mode, its stats records and its scrape
endpoint, against the JAX package's.

* ``run_session(hub=)`` over socketpairs: two sessions share one hub,
  each with its own reply-drain clock; a full hub rejects a third with
  EOF and a ``rejected`` record.
* The ``--tcp --hub --device cpu`` subprocess serves concurrent clients
  byte-exact, writes parseable ``--stats-fd`` records whose hub
  breakdown names each live session (one forced by SIGUSR1 each time),
  rejects the client past ``--hub-max-sessions`` with EOF, and ends
  with a wire cost ledger that tiles each connection.  ``--hub`` with
  ``--stdio`` is refused.
* ``StatsEmitter`` JSON and ``prom`` records against the JAX
  ``StatsEmitter`` driven directly on a pipe (the JAX package's own
  ``--stats-fd`` subprocess test fails by itself, so it is no oracle).
* ``/metrics``, ``/snapshot``, ``/healthz`` (200, then 503 at capacity)
  and ``/events`` against the JAX ``ObsHttpServer`` over the same hub
  state.
"""

import hashlib
import json
import os
import select
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from dat_replication_protocol_tpu import sidecar as jax_sidecar
from dat_replication_protocol_tpu.hub import ReplicationHub as JaxHub
from dat_replication_protocol_tpu.obs import http as jax_http
from dat_replication_protocol_tpu_torch import decode, encode, sidecar
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.obs import events, metrics, wirecost
from dat_replication_protocol_tpu_torch.obs import http as obs_http
from dat_replication_protocol_tpu_torch.wire.change_codec import (
    encode_change)

REPO = Path(__file__).resolve().parent.parent
WAIT = 30.0


def _h(p: bytes) -> bytes:
    return hashlib.blake2b(p, digest_size=32).digest()


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    wirecost.WIRECOST.reset_for_tests()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        wirecost.WIRECOST.reset_for_tests()


def _records(tag: str, n: int) -> list:
    return [{"key": f"{tag}-{i}", "change": i, "from": 0, "to": 1,
             "value": bytes([i % 256]) * (i % 50)} for i in range(n)]


def _wire(tag: str, n: int = 40, blob: int = 3000) -> bytes:
    e = encode()
    for r in _records(tag, n):
        e.change(r)
    e.blob(blob).end(bytes([len(tag)]) * blob)
    e.finalize()
    out = bytearray()
    while (c := e.read()) is not None:
        out += c
    return bytes(out)


def _want(tag: str, n: int = 40, blob: int = 3000) -> list:
    return ([_h(encode_change(r)) for r in _records(tag, n)]
            + [_h(bytes([len(tag)]) * blob)])


def _reply_digests(reply: bytes) -> list:
    got = []
    dec = decode()
    dec.change(lambda c, done: (got.append(bytes(c.value)), done()))
    dec.write(reply)
    dec.end()
    return got


def _recv_all(s) -> bytes:
    out = bytearray()
    while chunk := s.recv(65536):
        out += chunk
    return bytes(out)


# -- run_session on a hub -----------------------------------------------------


def _pair(small: bool = False):
    a, b = socket.socketpair()
    if small:  # a reply that nobody reads fills these at once
        for s in (a, b):
            s.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    for s in (a, b):
        s.settimeout(WAIT)
    return a, b


def _serve_pair(hub, key, conn, drain_timeout, out):
    def run():
        out[key] = sidecar.run_session(
            conn.recv, conn.sendall,
            close_write=lambda: conn.shutdown(socket.SHUT_WR),
            drain_timeout=drain_timeout, hub=hub, session_key=key)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_sessions_share_a_hub_with_their_own_drain_clocks():
    hub = ReplicationHub(device="cpu", linger_s=0.002)
    out: dict = {}
    good_srv, good_cli = _pair()
    stuck_srv, stuck_cli = _pair(small=True)
    threads = [_serve_pair(hub, "good", good_srv, 1.0, out),
               _serve_pair(hub, "stuck", stuck_srv, 1.0, out)]
    stuck_wire = _wire("stuck", n=3000, blob=100)
    sender = threading.Thread(target=lambda: (
        stuck_cli.sendall(stuck_wire), stuck_cli.shutdown(socket.SHUT_WR)),
        daemon=True)
    sender.start()  # this client never reads its reply
    t0 = time.monotonic()
    good_cli.sendall(_wire("good"))
    good_cli.shutdown(socket.SHUT_WR)
    reply = _recv_all(good_cli)
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads)
    assert _reply_digests(reply) == _want("good")
    assert out["good"]["ok"] and out["good"]["session"] == "good"
    assert out["good"]["shed"] is None and out["good"]["digests"] == 41
    assert out["stuck"]["ok"] is False  # torn down by its own clock
    assert time.monotonic() - t0 < 20
    assert hub.sessions_snapshot() == {}  # both slots released
    hub.close()
    for s in (good_srv, good_cli, stuck_srv, stuck_cli):
        s.close()


def test_a_full_hub_rejects_with_eof_and_a_record(port_obs):
    hub = ReplicationHub(device="cpu", max_sessions=1)
    holder = hub.register("holder")
    srv, cli = _pair()
    closed = []
    out = sidecar.run_session(srv.recv, srv.sendall,
                              close_write=lambda: (
                                  closed.append(1),
                                  srv.shutdown(socket.SHUT_WR)),
                              hub=hub, session_key="late")
    assert out == {"changes": 0, "blobs": 0, "bytes": 0, "digests": 0,
                   "ok": False, "rejected": True, "sessions": 1,
                   "parked_bytes": 0}
    assert closed == [1] and cli.recv(10) == b""
    rec = events.EVENTS.events("sidecar.session")[-1]["fields"]
    assert rec["rejected"] is True
    holder.close()
    hub.close()
    srv.close()
    cli.close()


def test_hub_and_stdio_are_refused(capsys):
    with pytest.raises(SystemExit) as ei:
        sidecar.main(["--stdio", "--hub"])
    assert ei.value.code == 2
    assert "--hub multiplexes many connections" in capsys.readouterr().err


# -- the --tcp --hub subprocess -----------------------------------------------


def _lines(fd, buf: bytearray, timeout: float) -> list:
    """The complete stats lines that arrive on ``fd`` within ``timeout``
    (at least one, unless the time runs out or the pipe closes)."""
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
    """SIGUSR1 the sidecar until a stats record satisfies ``ok``: each
    kick asks for one record, and a kick that lands while the emitter is
    writing may fold into that record, so an unanswered kick is
    repeated."""
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        proc.send_signal(signal.SIGUSR1)
        for rec in _lines(fd, buf, 2.0):
            if ok(rec):
                return rec
    pytest.fail("no stats record satisfied the check")


def test_tcp_hub_subprocess_serves_rejects_and_reports(tmp_path):
    r, w = os.pipe()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
         "--tcp", "127.0.0.1:0", "--hub", "--device", "cpu",
         "--hub-max-sessions", "2", "--stats-fd", str(w),
         "--stats-interval", "3600"],
        pass_fds=(w,), env=env, cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    os.close(w)
    buf = bytearray()
    clients = []
    try:
        line = proc.stderr.readline()
        assert "listening on" in line, line
        port = int(line.rsplit(":", 1)[1])
        wires = {t: _wire(t) for t in ("alpha", "beta")}
        for tag, wire in wires.items():
            s = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
            s.sendall(wire[:len(wire) // 2])
            clients.append((tag, s))
        rec = _kick_until(proc, r, buf,
                          lambda x: len(x.get("sessions", {})) == 2)
        keys = sorted(rec["sessions"])
        assert [k.split(":")[0] for k in keys] == ["c1", "c2"]
        assert all(k.split(":")[1] == "127.0.0.1" for k in keys)
        assert rec["hub"]["sessions"] == 2
        assert rec["healthz"]["stages"]["admission"]["open"] is False
        assert {"metrics", "jit_sites", "watermarks", "pump", "emit_seq",
                "events_dropped"} <= set(rec)
        # the third client is past --hub-max-sessions: EOF, no reply
        late = socket.create_connection(("127.0.0.1", port), timeout=WAIT)
        late.sendall(_wire("late"))
        assert _recv_all(late) == b""
        late.close()
        for tag, s in clients:
            s.sendall(wires[tag][len(wires[tag]) // 2:])
            s.shutdown(socket.SHUT_WR)
        for tag, s in clients:
            assert _reply_digests(_recv_all(s)) == _want(tag)
        # every session logged its record; the ledger tiles each link
        logs = [proc.stderr.readline() for _ in range(3)]
        assert sum("'rejected': True" in x for x in logs) == 1, logs
        assert sum("'ok': True" in x for x in logs) == 2, logs
        rec = _kick_until(proc, r, buf, lambda x: x["sessions"] == {})
        assert rec["hub"]["sessions"] == 0
        links = rec["wirecost"]["links"]
        for key in keys:
            for d in ("rx", "tx"):
                link = links[f"{key}|{d}"]
                assert link["residual_bytes"] == 0
                assert link["ledger_bytes"] == link["transport_bytes"] > 0
        counters = rec["metrics"]["counters"]
        assert counters["hub.admitted"] == 2
        assert counters["hub.rejected"] == 1
        assert counters["hub.dispatch.items"] == 2 * 41
        proc.send_signal(signal.SIGINT)  # the last record at shutdown
        proc.wait(WAIT)
        final = []
        while more := _lines(r, buf, 5.0):
            final += more
        assert final and final[-1]["emit_seq"] > rec["emit_seq"]
    finally:
        for _, s in clients:
            s.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        os.close(r)


# -- StatsEmitter against the JAX StatsEmitter ---------------------------------


def _hub_state(hub):
    a = hub.register("alpha")
    hub.register("beta")
    got = []
    for i in range(5):
        a.submit(b"s%d" % i * 30, got.append)
    a.flush()
    return got


@pytest.mark.parametrize("fmt", ["json", "prom"])
def test_stats_records_are_the_jax_emitters(fmt, obs_enabled, port_obs,
                                            monkeypatch):
    recs = []
    for mod, hub in ((jax_sidecar, JaxHub(hash_batch=lambda ps: [
            _h(p) for p in ps])), (sidecar, ReplicationHub(device="cpu"))):
        _hub_state(hub)
        monkeypatch.setattr(mod, "_ACTIVE_HUB", hub)
        r, w = os.pipe()
        em = mod.StatsEmitter(w, interval=3600, fmt=fmt)
        assert em.dump_once() and em.dump_once()
        os.close(w)
        data = b""
        while chunk := os.read(r, 1 << 16):
            data += chunk
        os.close(r)
        hub.close()
        recs.append(data.decode())
    if fmt == "json":
        want, got = ([json.loads(x) for x in text.splitlines()]
                     for text in recs)
        assert [x["emit_seq"] for x in got] == [0, 1]
        for w_rec, g_rec in zip(want, got):
            assert set(w_rec) == set(g_rec)
            for key in ("sessions", "events_dropped"):
                assert w_rec[key] == g_rec[key]
            for rec in (w_rec, g_rec):
                rec["hub"].pop("pump_route")
                for snap in (rec["metrics"], ):
                    for section in ("counters", "gauges"):
                        snap[section] = {
                            k: v for k, v in snap[section].items()
                            if k.startswith("hub.") and "dispatch" not in k}
            assert w_rec["hub"] == g_rec["hub"]
            assert w_rec["metrics"]["counters"] == \
                g_rec["metrics"]["counters"]
            assert w_rec["metrics"]["gauges"] == g_rec["metrics"]["gauges"]
            assert w_rec["healthz"]["stages"]["admission"] == \
                g_rec["healthz"]["stages"]["admission"]
            assert g_rec["healthz"]["ok"] is True
    else:
        def hub_lines(text):
            return sorted(x for x in text.splitlines()
                          if "hub_session" in x and "dispatches" not in x)

        assert hub_lines(recs[0]) == hub_lines(recs[1])
        # two records, each: three TYPE lines and two sessions' values,
        # and hub.sessions' TYPE line and value
        assert len(hub_lines(recs[1])) == 2 * (3 + 3 * 2 + 2)
        for name in ("dat_obs_events_dropped", "dat_obs_spans_dropped",
                     "dat_obs_scrape_ts"):
            assert recs[1].count(f"# TYPE {name} gauge") == 2


def test_a_dead_stats_fd_latches_the_emitter_as_the_jax_one():
    got = []
    for mod in (jax_sidecar, sidecar):
        r, w = os.pipe()
        os.close(r)
        em = mod.StatsEmitter(w, interval=3600)
        got.append((em.dump_once(), em.dump_once(), em._emit_seq))
        os.close(w)
    assert got[0] == got[1] == (False, False, 1)
    with pytest.raises(ValueError, match="unknown stats format"):
        sidecar.StatsEmitter(1, fmt="xml")


# -- the scrape endpoint against the JAX ObsHttpServer --------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=WAIT) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_scrape_routes_are_the_jax_endpoints(obs_enabled, port_obs,
                                             monkeypatch):
    views = []
    for mod, http_mod, hub in (
            (jax_sidecar, jax_http,
             JaxHub(hash_batch=lambda ps: [_h(p) for p in ps],
                    max_sessions=3)),
            (sidecar, obs_http, ReplicationHub(device="cpu",
                                               max_sessions=3))):
        _hub_state(hub)
        monkeypatch.setattr(mod, "_ACTIVE_HUB", hub)
        srv = http_mod.ObsHttpServer(
            0, snapshot_fn=mod.snapshot_stats,
            admission_fn=hub.admission_state).start()
        try:
            view = {}
            code, body = _get(srv.url + "/healthz")
            view["healthz"] = (code, json.loads(body)["stages"]["admission"])
            hub.register("gamma")  # at capacity: admission closes
            code, body = _get(srv.url + "/healthz")
            hz = json.loads(body)
            view["healthz_full"] = (code, hz["ok"],
                                    hz["stages"]["admission"])
            code, body = _get(srv.url + "/metrics")
            view["metrics"] = (code, sorted(
                x for x in body.splitlines()
                if "hub_session" in x and "dispatches" not in x))
            code, body = _get(srv.url + "/snapshot")
            snap = json.loads(body)
            snap["hub"].pop("pump_route")
            view["snapshot"] = (code, snap["hub"], snap["sessions"])
            code, body = _get(srv.url + "/events?n=8")
            view["events"] = (code, [
                (e["event"], e["fields"]) for e in
                map(json.loads, body.splitlines())
                if e["event"].startswith("hub.")])
            view["missing"] = _get(srv.url + "/nope")[0]
        finally:
            srv.close()
            hub.close()
        views.append(view)
    assert views[0] == views[1]
    got = views[1]
    assert got["healthz"][0] == 200 and got["healthz"][1]["open"]
    assert got["healthz_full"][:2] == (503, False)
    assert got["snapshot"][2]["gamma"]["submitted"] == 0
    assert [e for e, _ in got["events"][1]] == ["hub.admit"] * 3
    assert got["missing"] == 404
