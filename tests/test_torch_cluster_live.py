"""The port's live gossip leg: ``GossipDriver``, the sidecar's
``--replica`` mode and the edge's replica leg, against the JAX package's.

* The JAX package's live cases of ``test_cluster.py`` on the port: three
  ``--replica``-shaped ``serve_tcp`` loops with a ``GossipDriver`` each
  converge over real sockets; the flags parse, refuse the modes they
  cannot combine with, and without ``--device`` want the card (raising
  on a host without one); the stats record carries ``gossip``; a
  delivered-form replica converges on records without optionals and a
  second exchange ships nothing.
* Across packages over TCP: JAX and port ``serve_tcp(replica_node=)``
  loops, each dialled by a ``GossipDriver`` of its own package, start
  three-way divergent and converge to the ``hashlib`` oracle's content
  digest.
* The ``--tcp --replica LOGFILE --gossip-peers ... --device cpu`` sidecar
  as three subprocesses: every ``--stats-fd`` record's ``gossip.digest``
  reaches the oracle, and a ``propagation`` section appears (the stats
  fd turns the gate on).
* ``--tcp --edge --replica --device cpu``: the edge's ``replica_machine``
  answers a port and a JAX ``GossipDriver``; its session records equal
  ``run_replica_session``'s for the same exchanges, field for field, and
  its ``edge`` section lists a replica session by kind.
* A replica build made stale by a concurrent absorb is not cached; a peer
  that accepts and never answers costs one transport failure within the
  dial timeout; ``weights.replica_node_from_checkpoint`` loads a JAX
  checkpoint and the JAX package loads the port's.

The port runs B1's plain version on the CPU.
"""

import ast
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
from pathlib import Path

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu import sidecar as jax_sidecar
from dat_replication_protocol_tpu.cluster import GossipDriver as JaxDriver
from dat_replication_protocol_tpu.cluster import ReplicaNode as JaxNode
from dat_replication_protocol_tpu.runtime.reconcile_driver import (
    run_initiator as jax_run_initiator,
)
from dat_replication_protocol_tpu_torch import sidecar, weights
from dat_replication_protocol_tpu_torch.cluster import (
    GossipDriver,
    ReplicaNode,
    serve_responder_session,
)
from dat_replication_protocol_tpu_torch.obs import metrics, propagation
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.runtime.reconcile_driver import (
    run_initiator,
)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
WAIT = 60


def recs(lo, hi, tag="s", val=b"v"):
    return [{"key": f"k{i}", "change": i, "from": 0, "to": 1,
             "value": val + b"%d" % i, "subset": tag}
            for i in range(lo, hi)]


def _content_order(d: bytes) -> tuple:
    return tuple(int.from_bytes(d[i:i + 8], "little") for i in (0, 8, 16, 24))


def oracle(records) -> str:
    """``hashlib`` over the sorted unique canonical record digests (the
    content digest's order: four little-endian 64-bit words)."""
    wire = replay.encode_change_log(records)
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    digests = {hashlib.blake2b(p, digest_size=32).digest()
               for p in replay.canonical_change_payloads(cols)}
    return hashlib.blake2b(b"".join(sorted(digests, key=_content_order)),
                           digest_size=32).hexdigest()


def _serve(serve_tcp, node, max_sessions=500) -> int:
    port = {}
    ready = threading.Event()
    threading.Thread(
        target=serve_tcp, args=("127.0.0.1", 0),
        kwargs=dict(ready_cb=lambda p: (port.setdefault("p", p),
                                        ready.set()),
                    replica_node=node, max_sessions=max_sessions),
        daemon=True).start()
    assert ready.wait(10)
    return port["p"]


def _wait_converged(nodes, timeout=WAIT) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len({n.content_digest() for n in nodes}) == 1:
            return
        time.sleep(0.05)
    raise AssertionError("the mesh did not converge")


# -- the reference's live cases, on the port --------------------------------------


def test_live_replica_mesh_converges_over_tcp():
    nodes = {
        "n1": ReplicaNode("n1", recs(0, 30), device=CPU),
        "n2": ReplicaNode("n2", recs(20, 50), device=CPU),
        "n3": ReplicaNode("n3", recs(40, 70), device=CPU),
    }
    ports = {name: _serve(sidecar.serve_tcp, nd)
             for name, nd in nodes.items()}
    drivers = [
        GossipDriver(nodes[me],
                     [f"127.0.0.1:{ports[o]}" for o in nodes if o != me],
                     interval=0.05, seed=i).start()
        for i, me in enumerate(nodes)]
    try:
        _wait_converged(list(nodes.values()))
        assert nodes["n1"].record_count == 70
        assert nodes["n1"].content_digest().hex() == oracle(recs(0, 70))
        snap = drivers[0].snapshot()
        assert snap["replica"] == "n1"
        assert snap["rounds"] >= 1 and "peers" in snap
    finally:
        for d in drivers:
            d.close()


def test_sidecar_replica_flag_wiring(tmp_path):
    node = sidecar.load_replica_node(str(tmp_path / "cold.log"), "cold",
                                     device=CPU)
    assert node.record_count == 0
    log = tmp_path / "warm.log"
    log.write_bytes(ReplicaNode("t", recs(0, 5), device=CPU).canonical_wire())
    node = sidecar.load_replica_node(str(log), "warm", device=CPU)
    assert node.record_count == 5
    assert node.delivered_form
    for argv in (
        ["--stdio", "--replica", "x.log"],
        ["--tcp", "127.0.0.1:0", "--replica", "x.log", "--hub"],
        ["--tcp", "127.0.0.1:0", "--replica", "x.log", "--fanout"],
        ["--tcp", "127.0.0.1:0", "--replica", "x.log", "--reconcile",
         "y.log"],
        ["--tcp", "127.0.0.1:0", "--replica", "x.log", "--snapshot",
         "y.bin"],
        ["--tcp", "127.0.0.1:0", "--gossip-peers", "h:1"],
    ):
        with pytest.raises(SystemExit):
            sidecar.main(argv)
    if not torch.cuda.is_available():
        # no --device: the card, and nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            sidecar.main(["--tcp", "127.0.0.1:0", "--replica", str(log)])
        assert sidecar._ACTIVE_GOSSIP is None


def test_snapshot_stats_carries_gossip_record():
    node = ReplicaNode("stats-probe", recs(0, 3), device=CPU)
    sidecar.set_active_gossip(node)
    try:
        snap = sidecar.snapshot_stats()
        assert snap["gossip"]["replica"] == "stats-probe"
        assert snap["gossip"]["records"] == 3
        assert snap["gossip"]["digest"] == oracle(recs(0, 3))
        assert "propagation" not in snap  # an empty board is left out
    finally:
        sidecar.set_active_gossip(None)
    assert "gossip" not in sidecar.snapshot_stats()


def test_snapshot_stats_carries_propagation_once_the_board_holds_a_link():
    was_on = metrics.OBS.on
    propagation.PROPAGATION.reset_for_tests()
    metrics.enable()
    node = ReplicaNode("p", recs(0, 3), device=CPU)
    sidecar.set_active_gossip(node)
    try:
        propagation.record_exchange("p", "q", role="initiator", rnd=1,
                                    outcome="progress", seconds=0.01,
                                    diff=2)
        snap = sidecar.snapshot_stats()
        assert list(snap["propagation"]["links"]) == ["p->q"]
    finally:
        sidecar.set_active_gossip(None)
        metrics.OBS.on = was_on
        propagation.PROPAGATION.reset_for_tests()


def test_delivered_form_replica_converges_on_absent_optionals():
    bare = [{"key": f"n{i}", "change": i, "from": 0, "to": 1}
            for i in range(6)]
    a = ReplicaNode("a", bare + recs(0, 4), delivered_form=True, device=CPU)
    b = ReplicaNode("b", recs(0, 4), delivered_form=True, device=CPU)

    def once():
        sa, sb = socket.socketpair()
        t = threading.Thread(target=lambda: serve_responder_session(
            b, sb.recv, sb.sendall,
            close_write=lambda: sb.shutdown(socket.SHUT_WR)))
        t.start()
        st = run_initiator(a.replica, sa.recv, sa.sendall,
                           close_write=lambda: sa.shutdown(socket.SHUT_WR))
        t.join(10)
        sa.close()
        sb.close()
        if st["received"]:
            a.absorb(st["received"])
        return st

    once()
    assert a.content_digest() == b.content_digest()
    again = once()  # the mesh is done: diff 0, nothing ships
    assert again["records_sent"] == 0 and not again["received"]
    back = ReplicaNode.from_checkpoint(a.checkpoint(), device=CPU)
    assert back.delivered_form
    assert back.content_digest() == a.content_digest()
    # the JAX package's delivered-form node holds the same set
    jb = JaxNode("b", bare + recs(0, 4), delivered_form=True)
    assert jb.content_digest() == a.content_digest()


# -- across packages over TCP -------------------------------------------------------


def test_jax_and_port_replicas_converge_over_tcp():
    """n1 and n3 are JAX replicas behind the JAX ``serve_tcp``, n2 a port
    replica behind the port's; each dials the other two with a
    ``GossipDriver`` of its own package."""
    spans = {"n1": (0, 30), "n2": (20, 50), "n3": (40, 70)}
    nodes = {
        "n1": JaxNode("n1", recs(*spans["n1"]), delivered_form=True),
        "n2": ReplicaNode("n2", recs(*spans["n2"]), delivered_form=True,
                          device=CPU),
        "n3": JaxNode("n3", recs(*spans["n3"]), delivered_form=True),
    }
    serve = {"n1": jax_sidecar.serve_tcp, "n2": sidecar.serve_tcp,
             "n3": jax_sidecar.serve_tcp}
    ports = {k: _serve(serve[k], nd) for k, nd in nodes.items()}
    drivers = []
    for i, (me, nd) in enumerate(nodes.items()):
        cls = GossipDriver if me == "n2" else JaxDriver
        drivers.append(cls(nd, [f"127.0.0.1:{ports[o]}" for o in nodes
                                if o != me], interval=0.05, seed=i).start())
    try:
        _wait_converged(list(nodes.values()))
        want = oracle(recs(0, 70))
        for nd in nodes.values():
            assert nd.content_digest().hex() == want
            assert nd.record_count == 70
        # the port replica exchanged with both packages
        peers = drivers[1].snapshot()["peers"]
        assert all(st["ok"] + st["transport"] >= 0 for st in peers.values())
        assert nodes["n2"].stats["repairs_applied"] > 0
    finally:
        for d in drivers:
            d.close()


# -- the --replica sidecar subprocesses ---------------------------------------------


def _free_ports(n: int) -> list:
    socks = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


class _Sidecar:
    """One port sidecar subprocess with a ``--stats-fd`` pipe."""

    def __init__(self, args: list):
        self.r, w = os.pipe()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "dat_replication_protocol_tpu_torch.sidecar",
             *args, "--device", CPU, "--stats-fd", str(w),
             "--stats-interval", "0.3"],
            pass_fds=(w,), env={**os.environ, "PYTHONPATH": str(REPO)},
            cwd=REPO, stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        os.close(w)
        self.buf = bytearray()
        self.records: list = []
        self.lines: list = []
        self._t = threading.Thread(target=self._read_stderr, daemon=True)
        self._t.start()

    def _read_stderr(self) -> None:
        for line in self.proc.stderr:
            self.lines.append(line.rstrip("\n"))

    def poll_stats(self, timeout: float = 0.0) -> list:
        new = []
        while select.select([self.r], [], [], timeout)[0]:
            chunk = os.read(self.r, 1 << 20)
            if not chunk:
                break
            self.buf += chunk
            timeout = 0.0
        *lines, rest = bytes(self.buf).split(b"\n")
        self.buf[:] = rest
        for line in lines:
            new.append(json.loads(line))  # every line one record
        self.records += new
        return new

    def wait_line(self, text: str, timeout: float = WAIT) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.lines):
                if text in line:
                    return line
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"no {text!r} line: {self.lines[-10:]}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.wait(20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(10)
        self._t.join(10)
        os.close(self.r)


def test_replica_sidecar_subprocesses_converge(tmp_path):
    spans = [(0, 40), (30, 70), (60, 100)]
    ports = _free_ports(3)
    sides = []
    try:
        for i, (lo, hi) in enumerate(spans):
            log = tmp_path / f"r{i}.log"
            log.write_bytes(replay.encode_change_log(recs(lo, hi)))
            peers = ",".join(f"127.0.0.1:{p}" for j, p in enumerate(ports)
                             if j != i)
            sides.append(_Sidecar(
                ["--tcp", f"127.0.0.1:{ports[i]}", "--replica", str(log),
                 "--replica-key", f"r{i}", "--gossip-peers", peers,
                 "--gossip-interval", "0.1"]))
        for s in sides:
            s.wait_line("listening on")
        want = oracle(recs(0, 100))
        deadline = time.monotonic() + WAIT
        last = {}
        while time.monotonic() < deadline and len(last) < 3:
            for i, s in enumerate(sides):
                for rec in s.poll_stats(0.1):
                    g = rec.get("gossip")
                    # the frontier is noted just after an absorb, so a
                    # record may hold the new digest before its frontier
                    if g and g["digest"] == want and g["records"] == 100 \
                            and rec.get("propagation", {}).get(
                                "frontier", {}).get(f"r{i}", {}).get(
                                    "digest") == want:
                        last[i] = rec
        assert len(last) == 3, [s.records[-1:] for s in sides]
        for i, rec in last.items():
            assert rec["gossip"]["replica"] == f"r{i}"
            assert set(rec["gossip"]["peers"]) == {
                f"127.0.0.1:{p}" for j, p in enumerate(ports) if j != i}
            assert rec["propagation"]["links"]
    finally:
        for s in sides:
            s.close()
    for s in sides:
        # every session line the sidecar logged is one whole record
        for line in s.lines:
            if line.startswith("sidecar: ('"):
                rec = ast.literal_eval(line.split(") ", 1)[1])
                assert set(rec) >= {"replica", "ok"}


# -- the edge's replica leg ------------------------------------------------------------


def _until(cond, timeout: float = WAIT) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def _session_records(lines: list) -> list:
    out = []
    for line in lines:
        if line.startswith("sidecar: ('"):
            out.append(ast.literal_eval(line.split(") ", 1)[1]))
    return out


def _initiators():
    """A port and a JAX initiator, each over its own divergent log."""
    return (ReplicaNode("ip", recs(0, 12) + recs(100, 104, tag="p"),
                        delivered_form=True, device=CPU),
            JaxNode("ij", recs(6, 18) + recs(200, 203, tag="j"),
                    delivered_form=True))


def test_edge_replica_leg_records_equal_the_threaded_leg(tmp_path):
    log = tmp_path / "edge.log"
    log.write_bytes(replay.encode_change_log(recs(4, 14)))
    # the threaded leg, in process: the same log, the same initiators
    threaded = sidecar.load_replica_node(str(log), "e", device=CPU)
    port = _serve(sidecar.serve_tcp, threaded)
    ip, ij = _initiators()
    # the responder absorbs after its session ends, which can be after
    # the initiator's return: each dial waits for the previous absorb
    for (cls, nd), held in (((GossipDriver, ip), 18), ((JaxDriver, ij), 25)):
        assert cls(nd, [f"127.0.0.1:{port}"], seed=1).gossip_once()
        _until(lambda: threaded.record_count == held)
    # the edge subprocess: the same log, fresh initiators
    edge = _Sidecar(["--tcp", "127.0.0.1:0", "--edge", "--replica",
                     str(log), "--replica-key", "e"])
    try:
        line = edge.wait_line("edge listening on")
        eport = int(line.rsplit(":", 1)[1])
        ip2, ij2 = _initiators()
        for i, (cls, nd) in enumerate(((GossipDriver, ip2),
                                       (JaxDriver, ij2))):
            assert cls(nd, [f"127.0.0.1:{eport}"], seed=1).gossip_once()
            # the edge logs a session's record once it absorbed
            _until(lambda: len(_session_records(edge.lines)) == i + 1)
        for nd, twin in ((ip2, ip), (ij2, ij)):
            assert nd.content_digest() == twin.content_digest()
        # a connection held open sits in the table as a replica session
        t_held = time.time()
        held = socket.create_connection(("127.0.0.1", eport))
        deadline = time.monotonic() + WAIT
        seen = None
        while time.monotonic() < deadline and seen is None:
            edge.proc.send_signal(signal.SIGUSR1)
            for rec in edge.poll_stats(0.5):
                e = rec.get("edge")
                if e and e["by_kind"] == {"replica": 1} \
                        and rec["ts"] >= t_held:
                    seen = rec
        assert seen is not None, edge.records[-1:]
        assert seen["gossip"]["replica"] == "e"
        assert seen["gossip"]["digest"] == threaded.content_digest().hex()
        held.close()
    finally:
        edge.close()
    got = _session_records(edge.lines)
    # the threaded leg's records, from run_replica_session over the same
    # log and the same initiators
    want_records = []
    twin = sidecar.load_replica_node(str(log), "e", device=CPU)
    ip3, ij3 = _initiators()
    for nd in (ip3, ij3):
        sa, sb = socket.socketpair()
        out = {}
        t = threading.Thread(target=lambda: out.setdefault(
            "rec", sidecar.run_replica_session(
                sb.recv, sb.sendall, lambda: sb.shutdown(socket.SHUT_WR),
                twin)))
        t.start()
        init = (run_initiator if isinstance(nd, ReplicaNode)
                else jax_run_initiator)
        st = init(nd.replica, sa.recv, sa.sendall,
                  close_write=lambda: sa.shutdown(socket.SHUT_WR))
        t.join(10)
        sa.close()
        sb.close()
        assert st["ok"]
        want_records.append(out["rec"])
    assert got[:2] == want_records
    assert all(r["ok"] for r in want_records)
    assert [r["applied"] for r in want_records] == [8, 7]


# -- traps --------------------------------------------------------------------------------


def test_stale_replica_build_is_not_cached():
    base = recs(0, 200)
    node = ReplicaNode("s", base, device=CPU)
    batches = [recs(1000 + 10 * i, 1010 + 10 * i, tag="x") for i in range(30)]
    stop = threading.Event()
    reads = {"n": 0}

    def reader() -> None:
        while not stop.is_set():
            rep = node.replica
            assert rep.n >= 200
            reads["n"] += 1

    t = threading.Thread(target=reader)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the build with the absorbs
    t.start()
    try:
        for b in batches:
            node.absorb(b)
            time.sleep(0.002)
    finally:
        stop.set()
        t.join(30)
        sys.setswitchinterval(old)
    assert not t.is_alive()
    assert reads["n"] > 0
    everything = base + [r for b in batches for r in b]
    fresh = ReplicaNode("f", node.canonical_wire(), device=CPU)
    assert node.record_count == fresh.record_count == len(everything)
    assert node.content_digest() == fresh.content_digest()
    assert node.content_digest().hex() == oracle(everything)


def test_wedged_peer_costs_one_transport_failure():
    """A peer that accepts and never answers: the dial's SO_RCVTIMEO ends
    the round within the dial timeout, as a transport failure."""
    wedged = socket.socket()
    wedged.bind(("127.0.0.1", 0))
    wedged.listen(4)  # the kernel accepts; nobody reads or answers
    node = ReplicaNode("w", recs(0, 50), device=CPU)
    drv = GossipDriver(node, [f"127.0.0.1:{wedged.getsockname()[1]}"],
                       dial_timeout=1.0)
    try:
        t0 = time.monotonic()
        assert drv.gossip_once() is None
        took = time.monotonic() - t0
    finally:
        wedged.close()
    assert took < 5.0, took
    assert node.stats["transport_failures"] == 1
    assert node.stats["corrupt_exchanges"] == 0
    assert list(drv.peer_stats.values()) == [
        {"ok": 0, "transport": 1, "corrupt": 0}]


# -- checkpoints across packages -------------------------------------------------------


def test_checkpoints_cross_packages():
    jn = JaxNode("c", recs(0, 20), fanout_retention=1 << 14)
    jn.round = 9
    jn._feed_pos = {"o": (2, 77)}
    pn = weights.replica_node_from_checkpoint(jn.checkpoint(), device=CPU,
                                              fanout_retention=1 << 14)
    jback = JaxNode.from_checkpoint(jn.checkpoint(),
                                    fanout_retention=1 << 14)
    assert pn.content_digest() == jn.content_digest()
    assert pn.record_count == jn.record_count == 20
    assert pn.snapshot() == jback.snapshot()
    assert pn.checkpoint() == jback.checkpoint()
    # and the reverse: the port's checkpoint into the JAX package
    pn2 = ReplicaNode("d", recs(5, 15), delivered_form=True, device=CPU)
    pn2.round = 3
    jn2 = JaxNode.from_checkpoint(pn2.checkpoint())
    assert jn2.delivered_form
    assert jn2.content_digest() == pn2.content_digest()
    assert jn2.snapshot() == ReplicaNode.from_checkpoint(
        pn2.checkpoint(), device=CPU).snapshot()
    for bad in ({"key": "x"}, dict(jn.checkpoint(), round=-1),
                dict(jn.checkpoint(), wire="text"),
                dict(jn.checkpoint(), feeds={"o": (1,)})):
        with pytest.raises((KeyError, ValueError)):
            weights.replica_node_from_checkpoint(bad, device=CPU)
