"""The live gossip leg: a :class:`~.node.ReplicaNode` dialing real peers
over TCP (the sidecar's ``--replica`` mode).

A trimmed copy of ``dat_replication_protocol_tpu/cluster/live.py``.  One
sidecar serves inbound reconcile sessions against the node's CURRENT
log (:func:`serve_responder_session`) while the :class:`GossipDriver`
timer thread, on a jittered :class:`~..session.reconnect.BackoffPolicy`
schedule (so N replicas started together do not dial in lockstep),
samples a peer address, runs one reconciliation as the initiator and
absorbs the records it received.  Both directions mutate the same node
under its lock; convergence needs no coordinator, only the timer.

The failure taxonomy is the node's: connection errors are transport
class (the peer may be down or partitioned: retry later), structured
protocol failures accrue suspicion, and ``byzantine_after`` corrupt
exchanges quarantine the address.  Counters ride the ``gossip.*``
registry names and :meth:`GossipDriver.snapshot`, the ``gossip`` section
of the sidecar's stats records.  Every replica build on this path
launches B1 on the node's device.
"""

from __future__ import annotations

import random
import socket
import struct
import threading
import time
from typing import Optional

from ..obs import propagation as _propagation
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..runtime.reconcile_driver import run_initiator, run_responder
from ..session.pump import io_for_socket
from ..session.reconnect import BackoffPolicy
from ..wire.framing import ProtocolError
from .node import ReplicaNode, classify_error

__all__ = ["GossipDriver", "serve_responder_session",
           "absorb_responder_stats", "DEFAULT_INTERVAL", "DIAL_TIMEOUT"]

_M_DIALS = _counter("gossip.dials")

DEFAULT_INTERVAL = 1.0
DIAL_TIMEOUT = 10.0


def absorb_responder_stats(node: ReplicaNode, stats: dict) -> dict:
    """Fold one completed responder exchange into the node: absorb the
    initiator's records, stamp ``applied``, count the repairs shipped.
    Shared by :func:`serve_responder_session` and the edge's replica
    sessions; the mutation rides the node's lock inside ``absorb``."""
    applied = node.absorb(stats["received"]) if stats["received"] else 0
    stats["applied"] = applied
    if stats.get("records_sent"):
        node.stats["repairs_sent"] += stats["records_sent"]
    return stats


def serve_responder_session(node: ReplicaNode, read_bytes, write_bytes,
                            close_write=None, *,
                            peer: str = "inbound") -> dict:
    """Serve one inbound anti-entropy session against the node's current
    replica and absorb what the initiator shipped.  Returns
    ``run_responder``'s stats dict plus ``applied``; raises the session's
    ONE structured ProtocolError on a failed decode.  ``peer`` labels
    the provenance record."""
    t0 = time.monotonic()
    try:
        stats = run_responder(node.replica, read_bytes, write_bytes,
                              close_write=close_write)
        out = absorb_responder_stats(node, stats)
    except Exception as e:
        if _OBS.on:
            _propagation.record_exchange(
                node.key, peer, role="responder", rnd=node.round,
                outcome=classify_error(e),
                seconds=time.monotonic() - t0,
                error=f"{type(e).__name__}: {e}")
        raise
    if _OBS.on:
        diff = out["applied"] + out.get("records_sent", 0)
        _propagation.record_exchange(
            node.key, peer, role="responder", rnd=node.round,
            outcome="converged" if diff == 0 else "progress",
            seconds=time.monotonic() - t0, diff=diff,
            wire_bytes=len(out.get("received") or b""),
            repair_bytes=len(out.get("received") or b""))
        _propagation.note_frontier(node.key, node.content_digest().hex(),
                                   node.record_count, node.round)
    return out


class GossipDriver:
    """See the module docstring.  ``peers`` is a list of ``host:port``
    strings (other ``--replica`` sidecars)."""

    def __init__(self, node: ReplicaNode, peers, *,
                 interval: float = DEFAULT_INTERVAL,
                 policy: Optional[BackoffPolicy] = None,
                 seed: Optional[int] = None,
                 dial_timeout: float = DIAL_TIMEOUT):
        self.node = node
        self.peers = [p for p in peers if p]
        if not self.peers:
            raise ValueError("gossip needs at least one peer address")
        self.interval = interval
        # the jittered round timer IS a BackoffPolicy: attempt 1 with
        # base=interval sleeps uniform(0, 2*interval), one interval on
        # average; rounds that all fail escalate the attempt, so a
        # partitioned replica backs off instead of hammering dead links
        self._policy = policy if policy is not None else BackoffPolicy(
            base=interval, cap=interval * 8, max_retries=1 << 30,
            seed=seed)
        self._dial_timeout = dial_timeout
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._failed_streak = 0
        self.peer_stats = {p: {"ok": 0, "transport": 0, "corrupt": 0}
                           for p in self.peers}
        # monotonic stamp of the last successful exchange a peer: a dead
        # link shows as a growing age, not a frozen counter
        self._last_success: dict[str, Optional[float]] = {
            p: None for p in self.peers}
        self._thread = threading.Thread(
            target=self._run, name=f"gossip-{node.key}", daemon=True)

    def start(self) -> "GossipDriver":
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10)

    # -- one round -----------------------------------------------------------

    def gossip_once(self) -> Optional[dict]:
        """One dial and exchange (also callable from tests).  Returns the
        initiator's stats on success, None on a failure."""
        node = self.node
        node.begin_round()
        addr = node.sample_peer(self.peers)
        if addr is None:
            return None
        host, _, port = addr.rpartition(":")
        t0 = time.monotonic()
        if _OBS.on:
            _M_DIALS.inc()
        try:
            conn = socket.create_connection(
                (host or "127.0.0.1", int(port)),
                timeout=self._dial_timeout)
        except OSError as e:
            node.note_transport_failure(addr)
            self.peer_stats[addr]["transport"] += 1
            if _OBS.on:
                self._record_lit("transport", addr, t0, error=str(e))
            return None
        try:
            # kernel-level timeouts, not settimeout(T): Python's timeout
            # mode flips the fd to O_NONBLOCK.  SO_RCVTIMEO/SO_SNDTIMEO
            # keep the socket blocking and bound every recv and send, so
            # a wedged peer surfaces as EAGAIN (an OSError, transport
            # class) and the round is abandoned
            # datlint: disable=unbounded-join -- SO_RCVTIMEO+SO_SNDTIMEO set below bound every op at the kernel
            conn.settimeout(None)
            tv = struct.pack(
                "ll", int(self._dial_timeout),
                int((self._dial_timeout % 1.0) * 1_000_000))
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_RCVTIMEO, tv)
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_SNDTIMEO, tv)
            # the wire pump's batched reader and writer: a timeout that
            # runs out raises BlockingIOError from either (the blocking
            # gather-send returns EAGAIN instead of retrying it)
            rd, wr = io_for_socket(conn)
            stats = run_initiator(
                node.replica, rd, wr,
                close_write=lambda: conn.shutdown(socket.SHUT_WR))
        except ProtocolError as e:
            if classify_error(e) == "corruption":
                self.peer_stats[addr]["corrupt"] += 1
                node.note_corruption(addr, e)
                if _OBS.on:
                    self._record_lit("corruption", addr, t0,
                                     error=f"{type(e).__name__}: {e}")
            else:
                node.note_transport_failure(addr)
                self.peer_stats[addr]["transport"] += 1
                if _OBS.on:
                    self._record_lit("transport", addr, t0, error=str(e))
            return None
        except OSError as e:
            node.note_transport_failure(addr)
            self.peer_stats[addr]["transport"] += 1
            if _OBS.on:
                self._record_lit("transport", addr, t0, error=str(e))
            return None
        finally:
            try:
                conn.close()
            except OSError:
                pass
        node.note_success(addr)
        self.peer_stats[addr]["ok"] += 1
        self._last_success[addr] = time.monotonic()
        applied = node.absorb(stats["received"]) if stats["received"] \
            else 0
        if stats.get("records_sent"):
            node.stats["repairs_sent"] += stats["records_sent"]
        if _OBS.on:
            diff = applied + stats.get("records_sent", 0)
            self._record_lit(
                "converged" if diff == 0 else "progress", addr, t0,
                diff=diff, wire_bytes=len(stats.get("received") or b""))
            _propagation.note_frontier(
                node.key, node.content_digest().hex(),
                node.record_count, node.round)
        return stats

    def _record_lit(self, outcome: str, addr: str, t0: float, *,
                    diff: Optional[int] = None, wire_bytes: int = 0,
                    error: Optional[str] = None) -> None:
        """One lit provenance record for the dial leg (the live initiator
        never goes through :func:`~.node.gossip_exchange`)."""
        _propagation.record_exchange(
            self.node.key, addr, role="initiator", rnd=self.node.round,
            outcome=outcome, seconds=time.monotonic() - t0, diff=diff,
            wire_bytes=wire_bytes, repair_bytes=wire_bytes, t0=t0,
            error=error)

    def _run(self) -> None:
        while not self._stop.is_set():
            # the jittered wait comes FIRST: N replicas started together
            # must not all dial at once
            attempt = 1 + min(6, self._failed_streak)
            self._stop.wait(self._policy.delay(attempt))
            if self._stop.is_set():
                return
            try:
                ok = self.gossip_once() is not None
            except Exception:
                ok = False  # a dying exchange never kills the timer
            self._failed_streak = 0 if ok else self._failed_streak + 1

    # -- telemetry -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``gossip`` record of the stats lines: the node's, plus each
        peer's counts, ``last_success_age_s`` (None before the first
        success) and the node's suspicion toward it."""
        out = self.node.snapshot()
        out["interval"] = self.interval
        now = time.monotonic()
        peers = {}
        for addr, st in self.peer_stats.items():
            entry = dict(st)
            last = self._last_success.get(addr)
            entry["last_success_age_s"] = (
                None if last is None else round(now - last, 6))
            entry["suspicion"] = self.node._suspect.get(addr, 0)
            peers[addr] = entry
        out["peers"] = peers
        return out
