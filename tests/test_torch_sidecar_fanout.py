"""The port's sidecar in fan-out mode, against the JAX package's.

* ``--tcp 127.0.0.1:0 --fanout --device cpu`` as a subprocess: a probe
  connection gives the source claim back; the source's digest reply
  equals ``hashlib``; three subscribers that connected before the wire
  and one that connects after the source's end read the wire byte for
  byte, then EOF; a subscriber that sends bytes reads a ``not_source``
  record.
* ``--fanout --snapshot DATA --fanout-retention`` small: the bootstrap
  port is announced before the listener, a late subscriber reads one
  ``snapshot_needed`` record whose ``hint`` names it, and a joiner
  bootstraps the dataset from there byte for byte.
* The usage errors: ``--fanout --stdio``, ``--reconcile`` with
  ``--fanout`` or ``--hub``, a snapshot port that cannot be bound.
* ``run_subscriber``'s refusal records (``snapshot_needed`` with its
  hint, ``rejected``, ``not_source``) and the stats record's ``fanout``
  and ``peers`` sections, field for field against the JAX sidecar's.
* The decoder's watermark link in ``run_session``: ``/snapshot`` shows
  the session's ``accepted``, ``parsed`` and ``checkpoint`` offsets,
  equal to the JAX sidecar's for the same bytes.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from dat_replication_protocol_tpu import sidecar as jax_sidecar
from dat_replication_protocol_tpu.fanout import FanoutServer as JaxFanout
from dat_replication_protocol_tpu.hub import ReplicationHub as JaxHub
from dat_replication_protocol_tpu.obs import http as jax_http
from dat_replication_protocol_tpu.obs import watermarks as jax_watermarks
from dat_replication_protocol_tpu_torch import decode, encode, sidecar
from dat_replication_protocol_tpu_torch.fanout import FanoutServer
from dat_replication_protocol_tpu_torch.hub import ReplicationHub
from dat_replication_protocol_tpu_torch.obs import http as obs_http
from dat_replication_protocol_tpu_torch.obs import watermarks
from dat_replication_protocol_tpu_torch.runtime.snapshot_driver import (
    run_snapshot_joiner)
from dat_replication_protocol_tpu_torch.wire.framing import (
    CAP_SNAPSHOT, TYPE_BLOB, TYPE_CHANGE, iter_frames)

REPO = Path(__file__).resolve().parent.parent
WAIT = 30.0


def _wire(n: int = 60, blob: int = 20000) -> bytes:
    e = encode()
    for i in range(n):
        e.change({"key": f"k{i}", "change": i, "from": 0, "to": 1,
                  "value": bytes([i]) * 64})
    e.blob(blob).end(bytes(range(256)) * (blob // 256) + b"x" * (blob % 256))
    e.finalize()
    out = bytearray()
    while (c := e.read()) is not None:
        out += c
    return bytes(out)


WIRE = _wire()


def _want_digests(wire: bytes) -> list:
    out, seqs = [], {"change": 0, "blob": 0}
    for _s, tid, p0, end in iter_frames(wire):
        kind = {TYPE_CHANGE: "change", TYPE_BLOB: "blob"}[tid]
        out.append((kind, seqs[kind],
                    hashlib.blake2b(wire[p0:end], digest_size=32).digest()))
        seqs[kind] += 1
    return out


def _reply_digests(reply: bytes) -> list:
    got = []
    dec = decode()
    dec.change(lambda c, done: (got.append(
        (c.subset.split(":")[1], c.change, bytes(c.value))), done()))
    dec.write(reply)
    dec.end()
    assert dec.finished
    return got


def _recv_all(sock) -> bytes:
    out = bytearray()
    while chunk := sock.recv(65536):
        out += chunk
    return bytes(out)


def _connect(port: int):
    return socket.create_connection(("127.0.0.1", port), timeout=WAIT)


class _Sidecar:
    """The sidecar in a subprocess, its stderr lines collected on a
    thread, its port read from the ``listening on`` line."""

    def __init__(self, *args):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
             *args], cwd=REPO, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": str(REPO)})
        self.lines = []
        self.cond = threading.Condition()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()
        self.port = int(self.wait_for("listening on").rsplit(":", 1)[1])

    def _read(self) -> None:
        for line in self.proc.stderr:
            with self.cond:
                self.lines.append(line.rstrip("\n"))
                self.cond.notify_all()
        with self.cond:
            self.cond.notify_all()

    def wait_for(self, text: str, count: int = 1) -> str:
        deadline = time.monotonic() + WAIT
        with self.cond:
            while True:
                hits = [ln for ln in self.lines if text in ln]
                if len(hits) >= count:
                    return hits[count - 1]
                left = deadline - time.monotonic()
                assert left > 0 and self.reader.is_alive(), (text,
                                                             self.lines)
                self.cond.wait(min(left, 0.5))

    def close(self) -> list:
        self.proc.terminate()
        try:
            self.proc.wait(WAIT)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(WAIT)
        self.reader.join(WAIT)
        return self.lines


def test_fanout_sidecar_serves_source_and_subscribers():
    side = _Sidecar("--tcp", "127.0.0.1:0", "--fanout", "--device", "cpu")
    try:
        probe = _connect(side.port)  # a health check: no bytes
        probe.close()
        # its session gives the claim back before its record is printed
        side.wait_for("'bytes': 0, 'digests': 0")
        src = _connect(side.port)
        time.sleep(0.5)  # the source's thread claims the slot
        subs = [_connect(side.port) for _ in range(3)]
        time.sleep(0.2)
        sender = threading.Thread(
            target=lambda: (src.sendall(WIRE), src.shutdown(socket.SHUT_WR)),
            daemon=True)
        sender.start()
        reply = _recv_all(src)
        sender.join(WAIT)
        assert not sender.is_alive()
        src.close()
        assert _reply_digests(reply) == _want_digests(WIRE)
        for s in subs:
            assert _recv_all(s) == WIRE
            s.close()
        late = _connect(side.port)  # after the seal: retention serves it
        assert _recv_all(late) == WIRE
        late.close()
        side.wait_for("'digests': 61")
        side.wait_for("fanout_peer", 4)
    finally:
        lines = side.close()
    records = [ln for ln in lines if "fanout_peer" in ln]
    assert len(records) == 4
    assert all(f"'sent_bytes': {len(WIRE)}" in r and "'ok': True" in r
               for r in records)
    assert sum("'digests': 61" in ln and "'ok': True" in ln
               for ln in lines) == 1, lines


def test_a_subscriber_that_sends_reads_not_source():
    side = _Sidecar("--tcp", "127.0.0.1:0", "--fanout", "--device", "cpu")
    try:
        src = _connect(side.port)
        src.sendall(WIRE[:1000])  # claims and publishes
        time.sleep(0.5)
        rogue = _connect(side.port)
        rogue.sendall(WIRE[:100])
        got = _recv_all(rogue)
        rogue.close()
        # a subscriber from byte 0: the published prefix, then the record
        i = got.rindex(b'{"fanout_peer"')
        assert got[:i] == WIRE[:i] and i <= 1000
        rec = json.loads(got[i:])
        src.sendall(WIRE[1000:])
        src.shutdown(socket.SHUT_WR)
        assert _reply_digests(_recv_all(src)) == _want_digests(WIRE)
        src.close()
    finally:
        side.close()
    assert rec["not_source"] is True and rec["ok"] is False
    assert rec["fanout_peer"].startswith("p2:127.0.0.1:")


def test_fanout_snapshot_composition_redirects_late_subscribers(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 200_000,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "data.bin"
    path.write_bytes(data)
    side = _Sidecar("--tcp", "127.0.0.1:0", "--fanout", "--device", "cpu",
                    "--snapshot", str(path), "--fanout-retention", "4096")
    try:
        boot = [ln for ln in side.lines if "snapshot bootstrap on" in ln]
        assert len(boot) == 1 and side.lines.index(boot[0]) < len(
            side.lines) - 1  # announced before the listener
        snap_port = int(boot[0].rsplit(":", 1)[1])
        src = _connect(side.port)
        src.sendall(WIRE)
        src.shutdown(socket.SHUT_WR)
        assert _reply_digests(_recv_all(src)) == _want_digests(WIRE)
        src.close()
        late = _connect(side.port)
        rec = json.loads(_recv_all(late))
        late.close()
        assert rec["snapshot_needed"] is True and rec["ok"] is False
        assert rec["hint"] == {"port": snap_port, "cap": CAP_SNAPSHOT}
        start, end = rec["retained"]
        assert end == len(WIRE) and 0 < start and end - start <= 4096
        joiner = _connect(rec["hint"]["port"])
        res = run_snapshot_joiner(
            joiner.recv, joiner.sendall,
            close_write=lambda: joiner.shutdown(socket.SHUT_WR),
            device="cpu")
        joiner.close()
        assert res["data"] == data
    finally:
        side.close()


@pytest.mark.parametrize("args,message", [
    (["--stdio", "--fanout"], "--fanout broadcasts to many connections"),
    (["--tcp", "127.0.0.1:0", "--fanout", "--reconcile", "x.log"],
     "--reconcile is its own session mode"),
    (["--tcp", "127.0.0.1:0", "--hub", "--reconcile", "x.log"],
     "cannot combine with"),
], ids=["fanout-stdio", "reconcile-fanout", "reconcile-hub"])
def test_usage_errors(args, message, capsys):
    with pytest.raises(SystemExit) as ei:
        sidecar.main([*args, "--device", "cpu"])
    assert ei.value.code == 2 and message in capsys.readouterr().err


def test_a_snapshot_port_that_cannot_bind_ends_the_sidecar(tmp_path,
                                                           capsys):
    path = tmp_path / "data.bin"
    path.write_bytes(bytes(5000))
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen(1)
    try:
        rc = sidecar.main(["--tcp", "127.0.0.1:0", "--fanout", "--snapshot",
                           str(path), "--snapshot-port",
                           str(busy.getsockname()[1]), "--device", "cpu"])
    finally:
        busy.close()
    err = capsys.readouterr().err
    assert rc == 1 and "cannot serve the snapshot bootstrap" in err
    assert "listening on" not in err
    assert sidecar._ACTIVE_FANOUT is None  # torn down on the way out


# -- the refusal records and the stats sections against the JAX sidecar ----------


def _refusal(mod, fanout, what: str) -> dict:
    a, b = socket.socketpair()
    try:
        b.settimeout(WAIT)
        if what == "not_source":
            b.sendall(b"\x05\x01hello")
        out = mod.run_subscriber(a, fanout, key="late")
        got = _recv_all(b)
        i = got.rindex(b'{"fanout_peer"')  # after any streamed prefix
        assert got[:i] == b"x" * i
        rec = json.loads(got[i:])
    finally:
        a.close()
        b.close()
    assert rec == out
    return rec


@pytest.mark.parametrize("what", ["snapshot_needed", "rejected",
                                  "not_source"])
def test_refusal_records_match_jax(what):
    recs = []
    for mod, server in ((jax_sidecar, JaxFanout), (sidecar, FanoutServer)):
        kw = {"stall_timeout": 5.0}
        if what == "snapshot_needed":
            kw.update(retention_budget=64,
                      snapshot_hint={"port": 4711, "cap": CAP_SNAPSHOT})
        if what == "rejected":
            kw.update(max_peers=0)
        fanout = server(**kw)
        try:
            fanout.publish(b"x" * 400)
            fanout.log.enforce_retention()
            recs.append(_refusal(mod, fanout, what))
        finally:
            fanout.close()
    assert recs[0] == recs[1]
    assert recs[1][what] is True and recs[1]["ok"] is False
    if what == "snapshot_needed":
        assert recs[1]["hint"] == {"port": 4711, "cap": CAP_SNAPSHOT}
        assert recs[1]["retained"] == [336, 400]


def test_stats_record_fanout_sections_match_jax(monkeypatch):
    monkeypatch.setenv("DAT_PUMP", "python")
    views = []
    for mod, server in ((jax_sidecar, JaxFanout), (sidecar, FanoutServer)):
        fanout = server(stall_timeout=5.0)
        monkeypatch.setattr(mod, "_ACTIVE_FANOUT", fanout)
        try:
            got = bytearray()

            def sink(views_, got=got):
                for v in views_:
                    got.extend(bytes(v))
                return sum(len(v) for v in views_)

            peer = fanout.attach_peer("k1", sink=sink)
            fanout.publish(b"z" * 5000)
            fanout.seal()
            assert fanout.drain(10) and bytes(got) == b"z" * 5000
            r, w = os.pipe()
            try:
                assert mod.StatsEmitter(w).dump_once()
                rec = json.loads(os.read(r, 1 << 20))
            finally:
                os.close(r)
                os.close(w)
            for st in rec["peers"].values():
                st.pop("lat_p50_ms")
                st.pop("lat_p99_ms")
            views.append((rec["fanout"], rec["peers"],
                          mod.snapshot_stats()["healthz"]["stages"][
                              "admission"]))
            peer.close()
        finally:
            fanout.close()
    assert views[0] == views[1]
    assert views[1][0]["peers"] == 1 and views[1][0]["sealed"] is True
    assert views[1][1]["k1"]["sent_bytes"] == 5000


def _get_json(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=WAIT) as resp:
        return json.loads(resp.read())


def test_session_watermark_link_is_on_the_snapshot_endpoint(monkeypatch):
    monkeypatch.setenv("DAT_NATIVE_DISABLE", "1")
    monkeypatch.setenv("DAT_PUMP", "python")
    half = len(WIRE) // 2 + 7  # mid-frame: part of a payload received
    views = []
    for mod, http_mod, wm, hub in (
            (jax_sidecar, jax_http, jax_watermarks.WATERMARKS,
             JaxHub(hash_batch=lambda ps: [hashlib.blake2b(
                 p, digest_size=32).digest() for p in ps])),
            (sidecar, obs_http, watermarks.WATERMARKS,
             ReplicationHub(device="cpu"))):
        wm.reset_for_tests()
        srv = http_mod.ObsHttpServer(0, snapshot_fn=mod.snapshot_stats).start()
        a, b = socket.socketpair()
        out = {}
        t = threading.Thread(target=lambda: out.update(mod.run_session(
            a.recv, a.sendall, close_write=lambda: a.shutdown(
                socket.SHUT_WR), hub=hub, session_key="wm-link")),
            daemon=True)
        try:
            t.start()
            b.sendall(WIRE[:half])
            deadline = time.monotonic() + WAIT
            while True:
                links = _get_json(srv.url + "/snapshot")["watermarks"][
                    "links"]
                offs = links.get("wm-link", {}).get("offsets", {})
                # the snapshot reads accepted, then parsed: wait until
                # the parse of the first half shows too, not only its
                # receipt
                if (offs.get("accepted") == half
                        and offs.get("parsed") == half) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.02)
            views.append(offs)
            b.sendall(WIRE[half:])
            b.shutdown(socket.SHUT_WR)
            _recv_all(b)
            t.join(WAIT)
            assert not t.is_alive() and out["ok"]
            after = _get_json(srv.url + "/snapshot")["watermarks"]["links"]
            assert "wm-link" not in after  # untracked when the session ends
        finally:
            srv.close()
            hub.close()
            a.close()
            b.close()
    assert views[0] == views[1]
    assert views[1]["accepted"] == half
    assert views[1]["parsed"] == half
    assert views[1]["checkpoint"] == 0


def _raise(payloads):
    raise RuntimeError("B1 did not launch")


def test_a_source_whose_engine_fails_is_not_a_complete_session(capsys):
    """The source's digests ride a hub whose engine fails: its session
    ends in the hub's error (its reply torn, its record ``ok: False``),
    as the JAX sidecar's does.  The subscriber reads the bytes the
    source published, as in the JAX sidecar; the failure is the source's
    record, not a fallback that completes the session."""
    outcomes = []
    for mod, fanout_cls, hub in (
            (jax_sidecar, JaxFanout, JaxHub(hash_batch=_raise,
                                            linger_s=0.0)),
            (sidecar, FanoutServer, ReplicationHub(hash_begin=_raise,
                                                   linger_s=0.0))):
        fanout = fanout_cls(stall_timeout=10.0)
        ready = threading.Event()
        port = []
        kw = {"device": "cpu"} if mod is sidecar else {}
        t = threading.Thread(target=mod.serve_tcp, daemon=True,
                             args=("127.0.0.1", 0), kwargs=dict(
                                 max_sessions=2, fanout=fanout, hub=hub,
                                 ready_cb=lambda p: (port.append(p),
                                                     ready.set()), **kw))
        t.start()
        try:
            assert ready.wait(WAIT)
            src = _connect(port[0])
            time.sleep(0.5)  # the source's thread claims the slot
            sub = _connect(port[0])
            sender = threading.Thread(target=lambda: (
                src.sendall(WIRE), src.shutdown(socket.SHUT_WR)),
                daemon=True)
            sender.start()
            reply = _recv_all(src)
            got = _recv_all(sub)
            sender.join(WAIT)
            src.close()
            sub.close()
            t.join(WAIT)
        finally:
            fanout.close()
            hub.close()
        digests = []
        dec = decode()
        dec.change(lambda c, done: (digests.append(c.key), done()))
        dec.write(reply)
        outcomes.append((len(digests), got))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][0] < 61 and WIRE.startswith(outcomes[1][1])
    records = [ln for ln in capsys.readouterr().err.splitlines()
               if "'digests'" in ln and "'session'" in ln]
    assert records and all("'ok': False" in r for r in records)
