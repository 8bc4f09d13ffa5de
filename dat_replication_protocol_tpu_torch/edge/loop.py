"""The event-driven edge loop: ONE selector session table.

The port of ``dat_replication_protocol_tpu/edge/loop.py``.
``EdgeLoop._dispatch_loop`` is the sidecar's thread-per-connection edge
rewritten as one ``selectors`` loop whose per-turn I/O primitive is the
pump's non-blocking step (:func:`~..session.pump.recv_step` /
``send_step``).  One table serves hub sessions, broadcast subscribers
of N groups on one hub, and reconcile and snapshot responders, with
per-session QoS classes mapped onto the hub's weight presets.

**The staged-overload contract is the threaded edge's:**

1. **Admission**: the hub's :class:`~..hub.HubBusy` and the fan-out's
   ``FanoutBusy`` make the decision, with the threaded edge's rejection
   records; the loop adds no arm of its own.
2. **Per-session windows**: the submit window becomes a READ GATE.
   While :meth:`~..hub.HubSession.window_room` is false the session's fd
   leaves the readable set, the kernel socket buffer fills and the
   peer's TCP window closes.
3. **Heaviest-offender shed**: the hub's policy, unchanged; a shed
   surfaces on the session's next submit or poll, and the sweep raises
   it for a session that submits nothing more.

A faulted or slow session never holds up a neighbour: every fd in the
table is non-blocking from admission on, every kernel call the loop
makes returns at once on would-block, and a stalled reply tears down on
the threaded edge's ``drain_timeout`` clock.

A ``nowait`` hub session's digests are computed on the hub's dispatcher
thread but delivered on the loop thread, by :meth:`HubSession.poll` in
the sweep: the reply encoder is only ever touched by the loop.  The
reply is finalized only once the request is finalized AND the hub
session is drained (flush-before-finalize), so no digest is sealed out.

The gossip leg (mode ``"replica"``) serves each connection as a
responder against the live :class:`~..cluster.ReplicaNode` given as
``replica_node``; its received records are absorbed into the node when
the session completes.
"""

from __future__ import annotations

import itertools
import os
import selectors
import socket
import time
from typing import Callable, Optional

from ..hub import HubBusy, SessionShed
from ..obs.events import emit as _emit
from ..obs.loopprof import SAMPLE_EVERY, LoopProfiler
from ..obs.metrics import (
    OBS as _OBS,
    REGISTRY as _REGISTRY,
    counter as _counter,
)
from ..session.pump import (
    PUMP_BUF,
    EdgePump,
    effective_pump_route,
    recv_step,
    send_step,
)
from ..sidecar import DEFAULT_DRAIN_TIMEOUT, _send_refusal, log_line
from .machines import (
    hub_machine,
    reconcile_machine,
    replica_machine,
    snapshot_machine,
)

__all__ = ["EdgeLoop", "EdgeSession", "serve_edge", "QOS_PRESETS",
           "EDGE_TICK", "ACCEPT_BURST"]

# per-QoS-class presets on the hub's weight knob: latency sessions get a
# 4x weighted-fair share and a small receive slab a turn, so a
# throughput session's megabyte reads never sit between a latency
# session's frame and its digest; throughput sessions keep the pump's
# full slab
QOS_PRESETS = {
    "latency": {"weight": 4.0, "recv_cap": 256 << 10},
    "throughput": {"weight": 1.0, "recv_cap": PUMP_BUF},
}

# selector timeout: the loop's guarded fallback, not its pacing (I/O
# readiness wakes it at once); the tick bounds how stale a timer check
# (stall clocks, subscriber done-probes) can get
EDGE_TICK = 0.05

# accepted connections per accept turn: a connect flood cannot starve
# live sessions' I/O
ACCEPT_BURST = 64

_M_SESSIONS = _counter("sidecar.sessions")
_M_STALLS = _counter("sidecar.stalls")

# edge.served/admitted/rejected/shed come from the loop's registry
# COLLECTOR, read off the admission attributes, so they count with the
# gate off too

# default loop names for telemetry labels: edge0, edge1, ... in
# construction order
_LOOP_SEQ = itertools.count()


class EdgeSession:
    """One row of the session table."""

    __slots__ = ("n", "fd", "conn", "peer", "kind", "key", "qos",
                 "pump", "machine", "group", "is_source", "fanout_peer",
                 "tap", "rx_eof", "tx_done", "tx_ready", "tx_blocked",
                 "tx_more", "mask", "progress", "error", "dead",
                 "not_source", "sub_done")

    def __init__(self, n: int, conn: socket.socket, peer, kind: str,
                 key: str, qos: str):
        self.n = n
        self.fd = conn.fileno()
        self.conn = conn
        self.peer = peer
        self.kind = kind  # hub | subscriber | reconcile | replica | snapshot
        self.key = key
        self.qos = qos
        self.pump: Optional[EdgePump] = None
        self.machine = None
        self.group: Optional[str] = None
        self.is_source = False
        self.fanout_peer = None
        self.tap = None
        self.rx_eof = False
        self.tx_done = False
        self.tx_ready = True      # the first sweep probes the encoder once
        self.tx_blocked = False
        self.tx_more = False      # the last send turn moved bytes and the
        #   encoder may hold more: watch EVENT_WRITE for the next turn
        self.mask = 0
        self.progress = time.monotonic()
        self.error: Optional[BaseException] = None
        self.dead = False
        self.not_source = False
        self.sub_done = False


class EdgeLoop:
    """See the module docstring.  Construct, :meth:`bind`, :meth:`serve`
    (blocking; tests run it on a thread), :meth:`close` from any thread.

    ``mode_of(n, peer)`` picks each accepted connection's leg
    (``"hub" | "fanout" | "reconcile" | "replica" | "snapshot"``) and
    defaults to ``serve_tcp``'s precedence over the legs configured;
    ``qos_of(n, peer, mode)`` picks the QoS class (default
    ``"throughput"``); ``group_of(n, peer)`` picks the broadcast group
    of a ``"fanout"`` connection (default: the first group).
    """

    def __init__(self, hub=None, *, fanouts=None, reconcile_replica=None,
                 snapshot_source=None, replica_node=None,
                 mode_of: Optional[Callable] = None,
                 qos_of: Optional[Callable] = None,
                 group_of: Optional[Callable] = None,
                 drain_timeout: Optional[float] = DEFAULT_DRAIN_TIMEOUT,
                 max_sessions: Optional[int] = None,
                 tick: float = EDGE_TICK,
                 name: Optional[str] = None,
                 profile_every: int = SAMPLE_EVERY):
        self._hub = hub
        self._fanouts = dict(fanouts) if fanouts else {}
        self._reconcile_replica = reconcile_replica
        self._snapshot_source = snapshot_source
        self._replica_node = replica_node
        self._mode_of = mode_of if mode_of is not None else self._default_mode
        self._qos_of = qos_of if qos_of is not None else (
            lambda n, peer, mode: "throughput")
        self._group_of = group_of
        self._drain_timeout = drain_timeout
        self._max_sessions = max_sessions
        self._tick = float(tick)
        # per-turn phase accounting, loop lag and the turn profiler; only
        # the lit dispatch twin touches it
        self.profiler = LoopProfiler(name or f"edge{next(_LOOP_SEQ)}",
                                     tick=self._tick,
                                     sample_every=profile_every)

        self._sel = selectors.DefaultSelector()
        self._srv: Optional[socket.socket] = None
        self.port: Optional[int] = None
        self._table: dict[int, EdgeSession] = {}
        self._served = 0
        self._admitted = 0
        self._rejected = 0
        self._shed = 0
        self._closed = False
        # source-slot claims, one per broadcast group (serve_tcp's
        # election, per group): claimed at admission, given back by a
        # source that published nothing
        self._src_claims: dict[str, bool] = {g: False for g in self._fanouts}
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        os.set_blocking(self._wake_w, False)
        self._collector_fn = self._collect
        _REGISTRY.register_collector("edge", self._collector_fn)

    def _default_mode(self, n: int, peer) -> str:
        if self._snapshot_source is not None:
            return "snapshot"
        if self._replica_node is not None:
            return "replica"
        if self._reconcile_replica is not None:
            return "reconcile"
        if self._fanouts:
            return "fanout"
        return "hub"

    # -- lifecycle -----------------------------------------------------------

    def bind(self, host: str, port: int) -> int:
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind((host, port))
            srv.listen(128)
        except OSError:
            srv.close()
            raise
        srv.setblocking(False)
        self._srv = srv
        self.port = srv.getsockname()[1]
        self._sel.register(srv.fileno(), selectors.EVENT_READ, "accept")
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        return self.port

    def serve(self, ready_cb=None) -> None:
        """Run the loop on the calling thread until :meth:`close`, or,
        with ``max_sessions`` set, until that many connections were
        served AND the table drained."""
        if self._srv is None:
            raise RuntimeError("bind() first")
        log_line(f"sidecar: edge listening on :{self.port}")
        if ready_cb is not None:
            ready_cb(self.port)
        self.profiler.attach()
        try:
            self._dispatch_loop()
        finally:
            self._shutdown()

    def close(self) -> None:
        """Signal the loop to exit (thread-safe, idempotent)."""
        self._closed = True
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    def _shutdown(self) -> None:
        self.profiler.detach()
        _REGISTRY.unregister_collector("edge", self._collector_fn)
        for sess in list(self._table.values()):
            try:
                if sess.fanout_peer is not None:
                    sess.fanout_peer.close()
                sess.conn.close()
            except OSError:
                pass
        self._table.clear()
        for fd in (self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
        # a close() after the loop ended must not write into whatever
        # file reuses the pipe's fd numbers (os.write(-1) fails EBADF)
        self._wake_r = self._wake_w = -1
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        self._sel.close()

    # -- the loop ------------------------------------------------------------

    def _dispatch_loop(self) -> None:
        # one gate check a TURN forks the lit and dark twins: with the
        # gate off a turn pays one attribute load for telemetry
        while not self._closed:
            if _OBS.on:
                self._lit_turn()
            else:
                self._dark_turn()
            if (self._max_sessions is not None
                    and self._served >= self._max_sessions
                    and not self._table):
                return

    def _dark_turn(self) -> None:
        events = self._sel.select(self._tick)
        now = time.monotonic()
        for skey, mask in events:
            tag = skey.data
            if tag == "accept":
                self._accept_burst()
            elif tag == "wake":
                self._drain_wake()
            else:
                self._io_turn(tag, mask, now)
        self._sweep(time.monotonic())

    def _lit_turn(self) -> None:
        # the dark twin with the profiler's monotonic splits around work
        # the loop does anyway: no new kernel calls, nothing new blocks
        prof = self.profiler
        prof.turn_begin(time.monotonic())
        events = self._sel.select(self._tick)
        now = time.monotonic()
        prof.poll_done(now, len(events))
        for skey, mask in events:
            tag = skey.data
            if tag == "accept":
                t0 = time.monotonic()
                self._accept_burst()
                prof.phase("accept", time.monotonic() - t0)
            elif tag == "wake":
                self._drain_wake()
            else:
                self._io_turn(tag, mask, now, prof)
        self._sweep(time.monotonic(), prof)
        prof.turn_done(time.monotonic(), sessions=len(self._table))

    def _drain_wake(self) -> None:
        try:
            os.read(self._wake_r, 4096)  # O_NONBLOCK since construction
        except OSError:
            pass

    # -- admission (overload stage 1: the hub's or the fan-out's) -----------

    def _accept_burst(self) -> None:
        for _ in range(ACCEPT_BURST):
            if (self._max_sessions is not None
                    and self._served >= self._max_sessions):
                return
            try:
                conn, peer = self._srv.accept()  # O_NONBLOCK listener
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                # EMFILE/ECONNABORTED: stop this turn; the listener stays
                # registered and the next turn retries (the tick is the
                # backoff)
                return
            self._served += 1
            try:
                self._admit(conn, peer, self._served)
            except Exception as e:  # an admission failure is one
                # connection's problem, never the loop's
                _emit("edge.error",
                      error=f"admit: {type(e).__name__}: {e}")
                try:
                    conn.close()
                except OSError:
                    pass

    def _admit(self, conn: socket.socket, peer, n: int) -> None:
        conn.setblocking(False)
        # mode/qos/group selectors classify; an exception from them is
        # absorbed by _accept_burst, which closes THIS conn only
        mode = self._mode_of(n, peer)
        qos = self._qos_of(n, peer, mode)
        preset = QOS_PRESETS[qos]
        host_port = f"{peer[0]}:{peer[1]}"
        if mode == "fanout":
            group = (self._group_of(n, peer) if self._group_of is not None
                     else next(iter(self._fanouts)))
            fanout = self._fanouts[group]
            is_source = False
            if not fanout.log.sealed and not self._src_claims[group]:
                self._src_claims[group] = True
                is_source = True
            if is_source:
                sess = self._admit_hub(conn, peer, n, qos, preset,
                                       key=f"c{n}:{host_port}")
                if sess is not None:
                    sess.group = group
                    sess.is_source = True
                    sess.tap = fanout.publish
                else:
                    # rejected at the hub: the slot goes back
                    self._src_claims[group] = False
                return
            self._admit_subscriber(conn, peer, n, qos, fanout,
                                   key=f"p{n}:{host_port}", group=group)
            return
        if mode == "hub":
            self._admit_hub(conn, peer, n, qos, preset,
                            key=f"c{n}:{host_port}")
            return
        if mode == "reconcile":
            machine = reconcile_machine(self._reconcile_replica, host_port)
        elif mode == "snapshot":
            machine = snapshot_machine(self._snapshot_source, host_port)
        elif mode == "replica":
            if self._replica_node is None:
                raise ValueError("edge mode 'replica' needs the loop's "
                                 "replica_node (a cluster.ReplicaNode)")
            machine = replica_machine(self._replica_node, host_port)
        else:
            raise ValueError(f"unknown edge mode {mode!r}")
        sess = EdgeSession(n, conn, peer, mode, host_port, qos)
        sess.machine = machine
        sess.pump = EdgePump(conn.fileno(), cap=preset["recv_cap"])
        self._install(sess)

    def _admit_hub(self, conn, peer, n, qos, preset,
                   key: str) -> Optional[EdgeSession]:
        from .. import decode, encode  # lazy, like the threaded leg

        try:
            machine = hub_machine(encode, decode, self._hub, key,
                                  weight=preset["weight"])
        except HubBusy as e:
            # the threaded leg's rejection record: no decoder, no reply
            # bytes, the client reads EOF (overload stage 1)
            out = {"changes": 0, "blobs": 0, "bytes": 0, "digests": 0,
                   "ok": False, "rejected": True,
                   "sessions": e.sessions, "parked_bytes": e.parked_bytes}
            self._rejected += 1
            if _OBS.on:
                _emit("sidecar.session", **out)
            log_line(f"sidecar: {peer} {out}")
            try:
                conn.shutdown(socket.SHUT_WR)
            except OSError:
                pass
            conn.close()
            return None
        sess = EdgeSession(n, conn, peer, "hub", key, qos)
        sess.machine = machine
        sess.pump = EdgePump(conn.fileno(), cap=preset["recv_cap"])
        self._install(sess)
        return sess

    def _admit_subscriber(self, conn, peer, n, qos, fanout, key: str,
                          group: str) -> None:
        from ..fanout import FanoutBusy, SnapshotNeeded

        try:
            fanout_peer = fanout.attach_peer(key, fd=conn.fileno(),
                                             offset=0)
        except SnapshotNeeded as e:
            out = {"fanout_peer": key, "ok": False,
                   "snapshot_needed": True, "retained": list(e.retained)}
            if e.hint is not None:
                out["hint"] = dict(e.hint)
            _send_refusal(conn, out)
            conn.close()
            return
        except FanoutBusy as e:
            out = {"fanout_peer": key, "ok": False, "rejected": True,
                   "peers": e.peers, "max_peers": e.max_peers}
            self._rejected += 1
            _send_refusal(conn, out)
            conn.close()
            return
        sess = EdgeSession(n, conn, peer, "subscriber", key, qos)
        sess.fanout_peer = fanout_peer
        sess.group = group
        self._install(sess)

    def _install(self, sess: EdgeSession) -> None:
        self._table[sess.fd] = sess
        self._admitted += 1
        self._update_mask(sess)

    # -- per-session turns ---------------------------------------------------

    def _io_turn(self, sess: EdgeSession, mask: int, now: float,
                 prof: Optional[LoopProfiler] = None) -> None:
        if sess.dead:
            return
        try:
            if mask & selectors.EVENT_READ:
                if sess.kind == "subscriber":
                    self._probe_subscriber(sess)
                elif prof is not None:
                    t0 = time.monotonic()
                    rx = self._read_turn(sess, now)
                    prof.account("read", sess.key,
                                 time.monotonic() - t0, rx)
                else:
                    self._read_turn(sess, now)
            if mask & selectors.EVENT_WRITE and not sess.dead:
                if prof is not None:
                    t0 = time.monotonic()
                    tx = self._tx_turn(sess, now)
                    prof.account("tx", sess.key,
                                 time.monotonic() - t0, tx)
                else:
                    self._tx_turn(sess, now)
        except Exception as e:
            if prof is not None:
                t0 = time.monotonic()
                self._session_error(sess, e)
                prof.account("overload-ladder", sess.key,
                             time.monotonic() - t0, 0)
            else:
                self._session_error(sess, e)
        if not sess.dead:
            self._update_mask(sess)

    def _read_turn(self, sess: EdgeSession, now: float) -> int:
        dec = sess.machine.dec
        if sess.rx_eof or dec.destroyed or not self._read_gate_open(sess):
            return 0
        nbytes, eof = recv_step(sess.pump, dec, sess.tap)
        if eof:
            sess.rx_eof = True
            if not dec.destroyed and not dec.finished:
                dec.end()
        if nbytes or eof:
            sess.tx_ready = True  # the machine's hooks may have queued reply
        return nbytes

    def _probe_subscriber(self, sess: EdgeSession) -> None:
        # run_subscriber's EOF and misroute probe, event-driven
        try:
            # bounded: the fd is O_NONBLOCK (set at admission; the
            # fan-out's dup shares the open file description)
            probe = sess.conn.recv(4096)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            sess.rx_eof = True
            self._finish_session(sess)
            return
        if probe == b"":
            sess.rx_eof = True  # the client went away: release the slot
        else:
            # a subscriber has nothing to say: inbound bytes mean a
            # SOURCE was routed here, refused loudly (the threaded leg's)
            sess.not_source = True
        self._finish_session(sess)

    def _tx_turn(self, sess: EdgeSession, now: float) -> int:
        m = sess.machine
        if m is None or m.enc is None or sess.tx_done:
            return 0
        sess.tx_ready = False
        accepted, finished, blocked = send_step(sess.pump, m.enc)
        sess.tx_blocked = blocked
        # a turn that ends on its pull budget looks like one that ran the
        # encoder dry; both keep EVENT_WRITE one more turn (the JAX
        # package's loop drops it and parks a long reply until the peer
        # sends again)
        sess.tx_more = bool(accepted) and not finished and not blocked
        if accepted or not blocked:
            sess.progress = now  # a reply byte reached the kernel (or
            #   nothing was pending): the stall clock resets
        if finished:
            sess.tx_done = True
            try:
                sess.conn.shutdown(socket.SHUT_WR)  # the reply's EOF
            except OSError:
                pass
        return accepted

    def _read_gate_open(self, sess: EdgeSession) -> bool:
        m = sess.machine
        if not m.dec.writable():
            return False
        if sess.kind == "hub" and m.hub_session is not None:
            # overload stage 2: the hub window as a read gate
            return m.hub_session.window_room()
        return True

    def _session_error(self, sess: EdgeSession, e: BaseException) -> None:
        # a transport, shed or protocol failure: destroy both directions
        # (the threaded legs' cascade); the teardown predicate finishes
        m = sess.machine
        if sess.error is None:
            sess.error = e
        if m is not None:
            if m.dec is not None and not m.dec.destroyed:
                m.dec.destroy(e)
            if m.enc is not None and not m.enc.destroyed:
                m.enc.destroy(e)

    # -- the per-turn sweep --------------------------------------------------

    def _sweep(self, now: float,
               prof: Optional[LoopProfiler] = None) -> None:
        for sess in list(self._table.values()):
            if sess.dead:
                continue
            try:
                self._sweep_one(sess, now, prof)
            except Exception as e:
                if prof is not None:
                    t0 = time.monotonic()
                    self._session_error(sess, e)
                    prof.account("overload-ladder", sess.key,
                                 time.monotonic() - t0, 0)
                else:
                    self._session_error(sess, e)
            if not sess.dead:
                self._maybe_finish(sess)
            if not sess.dead:
                self._update_mask(sess)

    def _sweep_one(self, sess: EdgeSession, now: float,
                   prof: Optional[LoopProfiler] = None) -> None:
        if sess.kind == "subscriber":
            p = sess.fanout_peer
            if p.wait_done(timeout=0):
                sess.sub_done = True
                self._finish_session(sess)
            elif p.shed_reason is not None:
                self._finish_session(sess)
            return
        m = sess.machine
        hs = getattr(m, "hub_session", None)
        if hs is not None:
            if hs.shed_reason is not None and sess.error is None:
                # overload stage 3: the hub shed this session between
                # submits; the threaded leg saw it on its next wait, the
                # loop sees it here
                raise SessionShed(hs.key, hs.shed_reason, 0)
            if hs.has_completions and not m.enc.destroyed \
                    and m.enc.writable():
                # reply backpressure: while the encoder sits above its
                # high-water mark, completions PARK in the hub, parked
                # bytes grow, the window gate closes reads and the shed
                # policy may fire
                if prof is not None:
                    t0 = time.monotonic()
                    polled = hs.poll()
                    prof.account("hub-drain", sess.key,
                                 time.monotonic() - t0, 0)
                else:
                    polled = hs.poll()
                if polled:
                    sess.tx_ready = True
            if (m.rx_finalized and hs.drained
                    and not m.enc.finalized and not m.enc.destroyed):
                # flush-before-finalize, the loop's half: every digest of
                # submitted work is encoded before the reply seals
                if prof is not None:
                    t0 = time.monotonic()
                    m.enc.finalize()
                    prof.account("hub-drain", sess.key,
                                 time.monotonic() - t0, 0)
                else:
                    m.enc.finalize()
                sess.tx_ready = True
        if sess.tx_ready and not sess.tx_blocked and not sess.tx_done:
            if prof is not None:
                t0 = time.monotonic()
                tx = self._tx_turn(sess, now)
                prof.account("tx", sess.key, time.monotonic() - t0, tx)
            else:
                self._tx_turn(sess, now)
        if (self._drain_timeout is not None and not sess.tx_done
                and m.enc is not None and not m.enc.destroyed
                and (sess.tx_blocked or sess.rx_eof)
                and now - sess.progress > self._drain_timeout):
            if prof is not None:
                t0 = time.monotonic()
                self._teardown_stalled(sess)
                prof.account("overload-ladder", sess.key,
                             time.monotonic() - t0, 0)
            else:
                self._teardown_stalled(sess)

    def _teardown_stalled(self, sess: EdgeSession) -> None:
        # the client stopped reading its reply: the threaded leg's
        # reply-drain teardown and stall event
        m = sess.machine
        if _OBS.on:
            _M_STALLS.inc()
            _emit("sidecar.stall", kind="reply-drain",
                  seconds=self._drain_timeout, reply_bytes=m.enc.bytes)
        m.enc.destroy(TimeoutError(
            f"reply stream stalled for {self._drain_timeout}s"))
        try:
            sess.conn.shutdown(socket.SHUT_WR)
        except OSError:
            pass

    def _maybe_finish(self, sess: EdgeSession) -> None:
        if sess.kind == "subscriber":
            return  # finished from the sweep and probe paths directly
        m = sess.machine
        rx_over = sess.rx_eof or m.dec.destroyed
        tx_over = sess.tx_done or m.enc.destroyed
        if rx_over and tx_over:
            self._finish_session(sess)

    # -- teardown and records ------------------------------------------------

    def _unregister(self, sess: EdgeSession) -> None:
        if sess.mask:
            try:
                self._sel.unregister(sess.fd)
            except KeyError:
                pass
            sess.mask = 0

    def _finish_session(self, sess: EdgeSession) -> None:
        sess.dead = True
        self._unregister(sess)
        self._table.pop(sess.fd, None)
        try:
            if sess.kind == "subscriber":
                out = self._subscriber_record(sess)
            elif sess.kind == "hub":
                out = sess.machine.record(tx_done=sess.tx_done)
                if sess.is_source:
                    fanout = self._fanouts[sess.group]
                    if fanout.log.end > fanout.log.start:
                        fanout.seal()
                    else:
                        # nothing published: a probe, not the feed; the
                        # slot goes back
                        self._src_claims[sess.group] = False
                if out.get("shed") is not None:
                    self._shed += 1
                if _OBS.on:
                    _M_SESSIONS.inc()
                    _emit("sidecar.session", **out)
            else:
                out = sess.machine.record(error=sess.error)
                if _OBS.on:
                    _M_SESSIONS.inc()
                    _emit("sidecar.session", **out)
            log_line(f"sidecar: {sess.peer} {out}")
        finally:
            try:
                sess.conn.close()
            except OSError:
                pass

    def _subscriber_record(self, sess: EdgeSession) -> dict:
        p = sess.fanout_peer
        stats = p.stats()
        p.close()
        if stats["shed"] is not None:
            self._shed += 1
        if sess.not_source:
            out = {"fanout_peer": sess.key, "ok": False,
                   "not_source": True,
                   "detail": "subscriber connections must not send "
                             "data; the broadcast source slot was "
                             "already claimed — reconnect to retry as "
                             "source"}
            return _send_refusal(sess.conn, out)
        try:
            sess.conn.shutdown(socket.SHUT_WR)  # a clean EOF
        except OSError:
            pass
        out = {"fanout_peer": sess.key, "sent_bytes": stats["sent_bytes"],
               "shed": stats["shed"],
               "ok": sess.sub_done and stats["shed"] is None}
        if _OBS.on:
            _M_SESSIONS.inc()
            _emit("sidecar.session", **out)
        return out

    # -- the readiness mask --------------------------------------------------

    def _update_mask(self, sess: EdgeSession) -> None:
        want = 0
        if not sess.dead:
            if sess.kind == "subscriber":
                want |= selectors.EVENT_READ  # the EOF/misroute probe
            else:
                m = sess.machine
                if (not sess.rx_eof and not m.dec.destroyed
                        and self._read_gate_open(sess)):
                    want |= selectors.EVENT_READ
                if (sess.tx_blocked or sess.tx_more) and not sess.tx_done \
                        and not m.enc.destroyed:
                    want |= selectors.EVENT_WRITE
        if want == sess.mask:
            return
        if sess.mask == 0:
            self._sel.register(sess.fd, want, sess)
        elif want == 0:
            try:
                self._sel.unregister(sess.fd)
            except KeyError:
                pass
        else:
            self._sel.modify(sess.fd, want, sess)
        sess.mask = want

    # -- telemetry -----------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``edge`` section of ``--stats-fd`` and ``/snapshot``
        records: the table's aggregate with per-QoS-class and per-kind
        breakdowns (lock-free reads)."""
        by_class: dict = {}
        by_kind: dict = {}
        for sess in list(self._table.values()):
            by_class[sess.qos] = by_class.get(sess.qos, 0) + 1
            by_kind[sess.kind] = by_kind.get(sess.kind, 0) + 1
        return {
            "sessions": len(self._table),
            "served": self._served,
            "admitted": self._admitted,
            "rejected": self._rejected,
            "shed": self._shed,
            "by_class": by_class,
            "by_kind": by_kind,
            "pump_route": effective_pump_route(),
            "loop": self.profiler.state(),
        }

    def admission_state(self) -> dict:
        """Lock-free admission view for ``/healthz``: plain attribute
        reads, at worst one update stale, composed with the hub's."""
        out = {"stage": "edge", "sessions": len(self._table),
               "served": self._served, "rejected": self._rejected,
               "shed": self._shed, "open": not self._closed}
        if self._hub is not None:
            hub_state = self._hub.admission_state()
            out["open"] = bool(out["open"] and hub_state["open"])
            out["hub"] = hub_state
        return out

    def _collect(self) -> dict:
        """Registry collector: per-QoS-class session gauges (the class
        set is the preset table's) and the admission counters labeled by
        loop, read off the attributes :meth:`admission_state` reports, so
        they are right with the gate off too."""
        loop = self.profiler.name
        gauges: dict = {"edge.sessions": float(len(self._table))}
        counts: dict = {}
        for sess in list(self._table.values()):
            counts[sess.qos] = counts.get(sess.qos, 0) + 1
        for qos in QOS_PRESETS:
            gauges[f"edge.sessions{{class={qos}}}"] = float(
                counts.get(qos, 0))
        counters = {
            f"edge.served{{loop={loop}}}": self._served,
            f"edge.admitted{{loop={loop}}}": self._admitted,
            f"edge.rejected{{loop={loop}}}": self._rejected,
            f"edge.shed{{loop={loop}}}": self._shed,
        }
        return {"counters": counters, "gauges": gauges}


def serve_edge(host: str, port: int, *, hub=None, fanouts=None,
               reconcile_replica=None, snapshot_source=None,
               replica_node=None, mode_of=None, qos_of=None, group_of=None,
               max_sessions: Optional[int] = None, ready_cb=None,
               drain_timeout: Optional[float] = DEFAULT_DRAIN_TIMEOUT,
               tick: float = EDGE_TICK,
               name: Optional[str] = None) -> None:
    """Bind and run one :class:`EdgeLoop` on the calling thread: the
    event-driven twin of :func:`~..sidecar.serve_tcp` (``max_sessions``
    bounds the loop; ``ready_cb(port)`` fires once bound)."""
    loop = EdgeLoop(hub, fanouts=fanouts,
                    reconcile_replica=reconcile_replica,
                    snapshot_source=snapshot_source,
                    replica_node=replica_node, mode_of=mode_of,
                    qos_of=qos_of, group_of=group_of,
                    drain_timeout=drain_timeout,
                    max_sessions=max_sessions, tick=tick, name=name)
    loop.bind(host, port)
    loop.serve(ready_cb)
