"""One-to-many fan-out: hash once, serve every peer windowed writev.

The port's copy of ``dat_replication_protocol_tpu/fanout/server.py``.
:class:`FanoutServer` streams one :class:`~.log.BroadcastLog` to many
downstream peers at independent offsets:

* **The write path is O(1) in peers.**  :meth:`FanoutServer.publish`
  appends to the log and notes a latency mark: no per-peer loop, no
  per-peer allocation.  All digest work happens wherever the *source*
  session decodes (``DigestPipeline`` / ``ReplicationHub`` on kernel
  B1), exactly once, whatever the peer count.
* **Per-peer bookkeeping lives in the dispatcher.**  One thread walks
  peers with backlog and an open flow-control window and hands each a
  scatter-gather slice run (one batched gather on fd peers, a ``sink``
  callable otherwise).  The dispatcher never touches frame payloads: it
  moves ``memoryview`` slices the log already holds.  Fd peers are
  served through the wire pump's gather (``session/pump.py``
  :func:`send_spans_nb`: the slices go to ``sendmmsg``/``writev`` as
  (address, length) spans with the GIL released, up to 16 x ``max_iov``
  of them a turn); ``FanoutServer(native=False)`` serves them with one
  ``os.writev`` of ``max_iov`` slices instead, the plain version.
* **Per-peer flow-control windows** (``window_bytes`` of unacked
  in-flight data, ``max_iov`` slices per writev): a slow peer's window
  closes and only its own stream pauses.
* **Three-stage overload contract**: *admission* (``max_peers``,
  :class:`FanoutBusy`), *window stall* (a slow peer is bounded by its
  own window), *shed* (a peer making no progress for ``stall_timeout``
  seconds, a byzantine acker, a dead transport, or the laggard the
  retention budget trimmed past is shed with a structured
  :class:`PeerShed`; the broadcast never slows).

Late joiners attach at any retained offset (:meth:`BroadcastLog.attach`);
past the window they get the structured :class:`~.log.SnapshotNeeded`
instead of wrong bytes, and when the deployment serves the snapshot
bootstrap (``snapshot_hint``) the refusal carries the redirect.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Optional

from ..obs.events import DeferredEmitQueue as _DeferredEmitQueue
from ..obs.events import emit as _emit
from ..obs.metrics import (
    OBS as _OBS,
    REGISTRY as _REGISTRY,
    counter as _counter,
    gauge as _gauge,
    histogram as _histogram,
)
from ..obs.tracing import trace_span as _trace_span
from ..obs.watermarks import WATERMARKS as _WATERMARKS
from ..obs import wirecost as _wirecost
from ..session import pump as _pump
from .log import BroadcastLog, SnapshotNeeded

__all__ = ["FanoutServer", "FanoutPeer", "FanoutBusy", "PeerShed"]

# fanout telemetry (the reference's `fanout.*` catalog)
_M_PEERS = _gauge("fanout.peers")
_M_ATTACHED = _counter("fanout.peers.attached")
_M_DETACHED = _counter("fanout.peers.detached")
_M_REJECTED = _counter("fanout.rejected")
_M_SHED = _counter("fanout.peer.shed")
_M_SENT = _counter("fanout.sent.bytes")
_M_WRITEV = _counter("fanout.dispatch.writev")
_M_TURNS = _counter("fanout.dispatch.turns")
_H_FRAME_LAT = _histogram("fanout.frame.latency")

_WAKE_FALLBACK = 0.05
# append->delivery latency marks kept for attribution; peers that lag
# past the ring simply miss those samples (bounded memory by design)
_MARK_RING = 1024
_PEER_LAT_RING = 512

# fleet-plane link for the shared broadcast wire: ONE marks
# ring for the publish path (O(1) in peers by contract); per-peer links
# alias it via marks_from so every peer's lag-in-seconds reads the same
# sender clock
_WM_LINK = "fanout"


class FanoutBusy(RuntimeError):
    """Structured admission rejection: the fan-out is at capacity."""

    def __init__(self, message: str, *, peers: int, max_peers: int):
        super().__init__(message)
        self.peers = peers
        self.max_peers = max_peers


class PeerShed(RuntimeError):
    """This peer was shed by the fan-out's overload policy.  ``reason``
    is the policy arm (``stall`` / ``byzantine`` / ``retention`` /
    ``disconnect``); ``offset`` is the peer's send position when shed."""

    def __init__(self, key: str, reason: str, offset: int):
        super().__init__(
            f"peer {key!r} shed by fan-out ({reason}, at byte {offset})")
        self.key = key
        self.reason = reason
        self.offset = offset


class _PeerState:
    """Per-peer edge state.  Window/offset fields are mutated only
    under the server lock; the transport handle is used only by the
    dispatcher thread."""

    __slots__ = (
        "key", "cursor", "sent", "window_bytes", "max_iov",
        "fd", "sink", "explicit_ack", "cv",
        "last_progress", "shed", "gone", "done",
        "sent_bytes", "writev_calls", "attached_at",
        "lat", "mark_seq",
    )

    def __init__(self, key: str, cursor, *, window_bytes: int,
                 max_iov: int, fd: Optional[int],
                 sink: Optional[Callable], explicit_ack: bool,
                 lock: threading.Lock):
        self.key = key
        self.cursor = cursor
        self.sent = cursor.acked          # bytes handed to the transport
        self.window_bytes = window_bytes  # unacked in-flight bound
        self.max_iov = max_iov
        self.fd = fd
        self.sink = sink
        self.explicit_ack = explicit_ack
        self.cv = threading.Condition(lock)
        self.last_progress = time.monotonic()
        self.shed: Optional[str] = None
        self.gone = False
        self.done = False                 # sealed end fully delivered
        self.sent_bytes = 0
        self.writev_calls = 0
        self.attached_at = time.monotonic()
        self.lat: deque = deque(maxlen=_PEER_LAT_RING)
        self.mark_seq = 0                 # next latency mark to consume

    def window_remaining(self, acked: int) -> int:
        return self.window_bytes - (self.sent - acked)


class FanoutPeer:
    """A peer's handle on the fan-out (returned by
    :meth:`FanoutServer.attach_peer`)."""

    def __init__(self, server: "FanoutServer", state: _PeerState):
        self._server = server
        self._state = state

    @property
    def key(self) -> str:
        return self._state.key

    @property
    def shed_reason(self) -> Optional[str]:
        return self._state.shed

    @property
    def sent(self) -> int:
        return self._state.sent

    def ack(self, offset: int) -> None:
        """Confirm delivery below ``offset`` (explicit-ack peers only —
        the app-level ack for transports where kernel acceptance is not
        delivery).  A regressing or ahead-of-production ack is
        byzantine and sheds THIS peer."""
        self._server._ack_peer(self._state, offset)

    def wait_done(self, timeout: Optional[float] = 30.0) -> bool:
        """Block until the sealed log is fully delivered to this peer,
        it is shed, or ``timeout`` elapses.  Returns ``done``."""
        return self._server._wait_peer_done(self._state, timeout)

    def raise_if_shed(self) -> None:
        st = self._state
        if st.shed is not None:
            raise PeerShed(st.key, st.shed, st.sent)

    def stats(self) -> dict:
        return self._server._peer_stats(self._state)

    def close(self) -> None:
        """Detach; the peer's acked offset stops pinning the log.
        Idempotent."""
        self._server._detach(self._state)

    def __enter__(self) -> "FanoutPeer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FanoutServer:
    """See module docstring.  One server per :class:`BroadcastLog`."""

    def __init__(
        self,
        log: Optional[BroadcastLog] = None,
        *,
        retention_budget: int = 64 << 20,
        max_peers: int = 4096,
        window_bytes: int = 1 << 20,
        max_iov: int = 64,
        stall_timeout: float = 30.0,
        linger_s: float = 0.0005,
        snapshot_hint: Optional[dict] = None,
        native: bool = True,
    ):
        self.log = log if log is not None else BroadcastLog(
            retention_budget=retention_budget)
        self.max_peers = int(max_peers)
        self.window_bytes = int(window_bytes)
        self.max_iov = int(max_iov)
        self.stall_timeout = float(stall_timeout)
        self._linger_s = float(linger_s)
        # where the snapshot bootstrap answers what this log cannot:
        # a dict like {"port": N, "cap": CAP_SNAPSHOT}
        # attached to every SnapshotNeeded raised at attach, so a
        # trimmed-past joiner learns the redirect IN the refusal —
        # no out-of-band config.  Settable after construction (the
        # sidecar binds the snapshot listener late).
        self.snapshot_hint = snapshot_hint
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._peers: dict[str, _PeerState] = {}
        # datlint: guarded-by(self._lock): self._peers
        # shed events queued under the lock, emitted by
        # _drain_shed_events once the holder releases (the event sink
        # can block; blocking under the server lock stalls everyone)
        self._shed_events = _DeferredEmitQueue("fanout.shed", self._lock)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # owned fds of gone/shed peers, parked for the dispatcher to
        # close (only the writing thread may close — see _reap_dead_fds)
        self._dead_fds: list[int] = []
        # append->delivery latency marks: (end_offset, t) ring + an
        # absolute base so peers index marks with a plain counter
        self._marks: deque = deque(maxlen=_MARK_RING)
        self._mark_base = 0
        self.log.set_append_hook(self._on_append)
        self._collector_fn = self._collect
        _REGISTRY.register_collector("fanout", self._collector_fn)
        # the byte mover of fd peers: one gather batch a turn on the
        # native route, os.writev with native=False; every window, ack
        # and shed decision is the same on both
        self._gather = _pump.SpanGather() if native else None
        # one native batch carries up to 16 messages of max_iov spans, so
        # a native turn may serve more slices than one os.writev could
        self._serve_iov_factor = 16 if native else 1
        # the dispatcher starts NOW, not at first attach: it is also
        # the retention enforcer, and a source can publish gigabytes
        # before the first subscriber ever attaches — budget pressure
        # must trim regardless of peer count (the write path itself
        # stays O(1) in peers and never trims)
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="fanout-dispatch",
            daemon=True)
        self._thread.start()

    # -- writer section (O(1) in peers) --------------------------------------

    def publish(self, data) -> None:
        """Append produced wire bytes to the shared log and note a
        latency mark.  The broadcast write path: no per-peer loop, no
        per-peer allocation — peers are the dispatcher's business.
        The mark update is O(1) under the server lock (the dispatcher
        indexes the ring by absolute sequence; an unlocked evict would
        shift its base mid-read)."""
        self.log.append(data)
        end = self.log.end
        now = time.monotonic()
        with self._lock:
            if len(self._marks) == self._marks.maxlen:
                self._mark_base += 1
            self._marks.append((end, now))
        if _OBS.on:
            _WATERMARKS.mark(_WM_LINK, end)
            self._lit_cost_published(len(data))

    # -- wire cost lit helpers ------------------------------------------------
    # The fan-out choke points fork once on `_OBS.on`; these helpers hold
    # the plane's symbols, so the hot paths reference none.  The fan-out
    # ledger is the amplification pair: source bytes in, per-peer
    # delivered bytes out (the session encoder that produced the bytes
    # already attributed their frame classes).

    def _lit_cost_published(self, nbytes: int) -> None:
        _wirecost.note_source(_WM_LINK, nbytes)

    def _lit_cost_served(self, peer: str, nbytes: int) -> None:
        _wirecost.note_delivered(_WM_LINK, peer, nbytes)

    def seal(self) -> None:
        """No more bytes: peers complete once fully delivered."""
        self.log.seal()

    def _on_append(self) -> None:
        with self._lock:
            self._work.notify_all()

    # -- admission / lifecycle ----------------------------------------------

    def attach_peer(self, key: str, *, fd: Optional[int] = None,
                    sink: Optional[Callable] = None,
                    offset: Optional[int] = None,
                    window_bytes: Optional[int] = None,
                    max_iov: Optional[int] = None,
                    explicit_ack: bool = False) -> FanoutPeer:
        """Admit one downstream peer at ``offset`` (default: earliest
        retained byte).

        Exactly one transport must be given: ``fd`` (streamed with the
        non-blocking gather, or ``os.writev`` on a ``native=False``
        server — the scatter-gather zero-copy path)
        or ``sink`` (a callable ``sink(views) -> accepted_bytes``; 0
        means would-block).  ``explicit_ack`` defers log trimming to
        app-level :meth:`FanoutPeer.ack` calls instead of transport
        acceptance.

        Raises :class:`FanoutBusy` at ``max_peers`` (admission — stage
        one of the overload contract) and the structured
        :class:`~.log.SnapshotNeeded` for an offset below the retained
        window — carrying ``snapshot_hint`` when set, so the caller can
        redirect the joiner to the bootstrap protocol."""
        if (fd is None) == (sink is None):
            raise ValueError("exactly one of fd/sink is required")
        if not isinstance(key, str) or not key or any(
                c in key for c in "{},=\"\n\r"):
            # keys ride telemetry label sets ({peer=KEY}) — refuse
            # structural characters at the boundary (hub precedent)
            raise ValueError(
                f"peer key {key!r} must be a non-empty string containing "
                'none of {},=" or newlines')
        if offset is not None:
            # coerce HERE so log.attach's only remaining ValueError is
            # the duplicate-cursor refusal (translated below) — a bad
            # offset type must surface as itself, not as duplicate-key
            offset = int(offset)
        if self._closed:
            # racy fast-fail (the in-lock check below is authoritative):
            # a closed server must refuse BEFORE the log can answer a
            # stale offset with SnapshotNeeded + hint — misdirecting a
            # joiner into a snapshot fetch it cannot use
            raise RuntimeError("fan-out server is closed")
        peers_seen = len(self._peers)
        if peers_seen >= self.max_peers and key not in self._peers:
            # (duplicate keys fall through to the duplicate-cursor
            # refusal below — a caller bug outranks the capacity
            # verdict, as the pre-fast-fail contract had it)
            # same racy fast-fail for admission: at capacity, refusal
            # must stay the CHEAP first gate — before the cursor
            # attach, the fd dup, and before a stale offset can be
            # answered with SnapshotNeeded + hint (amplifying load
            # with a snapshot fetch the full server would then reject)
            busy = FanoutBusy(
                f"fan-out at capacity ({peers_seen}/"
                f"{self.max_peers} peers)",
                peers=peers_seen, max_peers=self.max_peers)
            if _OBS.on:
                _M_REJECTED.inc()
                _emit("fanout.reject", key=key, peers=busy.peers,
                      max_peers=self.max_peers)
            raise busy
        # register the log cursor FIRST, outside the server lock: the
        # log serializes on its own lock, and its SnapshotNeeded
        # refusal path emits — neither may run under the server lock
        # (the blocking-under-lock contract).  A duplicate key
        # fails here too (every peer owns a same-keyed cursor).
        try:
            cursor = self.log.attach(key, offset)
        except SnapshotNeeded as e:
            # the one refusal the stack can now ANSWER: attach the
            # bootstrap hint so the joiner redirects to the snapshot
            # protocol instead of being stranded
            e.hint = self.snapshot_hint
            raise
        except ValueError:
            # every attached peer owns a same-keyed log cursor, so the
            # log's duplicate-cursor refusal IS the duplicate-peer
            # check — restate it at this API's level
            raise ValueError(
                f"peer key {key!r} already attached") from None
        busy = None
        admitted = False
        owned_fd = None
        try:
            if fd is not None:
                # the server OWNS a duplicate: the caller may close its
                # fd at any time (teardown races the dispatcher's
                # writev), and a closed number can be reused by the
                # kernel for an unrelated connection — the dup keeps our
                # writes pointed at THIS peer's socket until the
                # dispatcher itself reaps it (_reap_dead_fds).  Inside
                # the rollback scope: an EMFILE here must detach the
                # provisional cursor, or the key is unusable forever.
                owned_fd = os.dup(fd)
                os.set_blocking(owned_fd, False)
            with self._lock:
                if self._closed:
                    raise RuntimeError("fan-out server is closed")
                if len(self._peers) >= self.max_peers:
                    # built under the lock (consistent count), emitted
                    # and raised OUTSIDE it
                    busy = FanoutBusy(
                        f"fan-out at capacity ({len(self._peers)}/"
                        f"{self.max_peers} peers)",
                        peers=len(self._peers), max_peers=self.max_peers)
                else:
                    st = _PeerState(
                        key, cursor,
                        window_bytes=(self.window_bytes
                                      if window_bytes is None
                                      else int(window_bytes)),
                        max_iov=(self.max_iov if max_iov is None
                                 else int(max_iov)),
                        fd=owned_fd, sink=sink,
                        explicit_ack=explicit_ack,
                        lock=self._lock)
                    # skip latency marks fully delivered pre-attach
                    st.mark_seq = self._mark_base + len(self._marks)
                    self._peers[key] = st
                    peers_now = len(self._peers)
                    attach_offset = cursor.acked
                    if _OBS.on:
                        # gauge set under the lock: concurrent
                        # attach/detach post-lock sets interleave out
                        # of order and latch a stale count (the EVENT
                        # still emits outside — only it can block)
                        _M_PEERS.set(peers_now)
                    self._work.notify_all()
                    # fleet-plane watermarks: this peer's wire is one
                    # link — append is the shared log's frontier,
                    # delivered is the peer's transport position;
                    # seconds come from the shared publish marks ring
                    # (marks_from)
                    log = self.log
                    _WATERMARKS.track("append", f"fanout/{key}",
                                      lambda: log.end,
                                      marks_from=_WM_LINK)
                    _WATERMARKS.track("delivered", f"fanout/{key}",
                                      lambda st=st: st.sent)
                    admitted = True
        finally:
            if not admitted:
                # roll the provisional cursor (and owned fd) back out
                if owned_fd is not None:
                    os.close(owned_fd)
                self.log.detach(cursor)
        if busy is not None:
            if _OBS.on:
                _M_REJECTED.inc()
                _emit("fanout.reject", key=key, peers=busy.peers,
                      max_peers=self.max_peers)
            raise busy
        if _OBS.on:
            _M_ATTACHED.inc()
            _emit("fanout.attach", key=key, offset=attach_offset,
                  peers=peers_now)
        return FanoutPeer(self, st)

    def _peer_state(self, key: str) -> _PeerState:
        """THE peer-keyed accessor: every key-addressed reach into
        per-peer state goes through here (hub-isolation precedent)."""
        return self._peers[key]

    def _detach(self, st: _PeerState) -> None:
        with self._lock:
            if st.gone:
                return
            st.gone = True
            self._park_fd_locked(st)
            if self._peers.get(st.key) is st:
                del self._peers[st.key]
            if _OBS.on:
                # under the lock for the same stale-interleaving reason
                # as the attach-side set
                _M_PEERS.set(len(self._peers))
            st.cv.notify_all()
            self._work.notify_all()
        # emit outside the lock (the event sink can block); st.gone
        # above makes this path single-shot, so the event fires once
        if _OBS.on:
            _M_DETACHED.inc()
            _emit("fanout.detach", key=st.key, sent=st.sent,
                  shed=st.shed)
        _WATERMARKS.untrack(f"fanout/{st.key}")
        self.log.detach(st.cursor)

    def _ack_peer(self, st: _PeerState, offset: int) -> None:
        shed_reason = None
        with self._lock:
            if st.gone or st.shed is not None:
                return
            if offset > st.sent:
                # acking bytes never sent is byzantine even when the
                # log (which only knows production) would accept it
                self._shed_locked(st, "byzantine")
                shed_reason = "byzantine"
        if shed_reason is None:
            # the log serializes on its own lock (and its refusal/trim
            # paths emit) — call it with the server lock RELEASED;
            # racing acks were already byzantine-on-regression before
            try:
                self.log.ack(st.cursor, offset)
            except SnapshotNeeded:
                # an honest ack from a cursor the retention budget
                # already trimmed past: a laggard, not an attacker
                shed_reason = "retention"
            except ValueError:
                # a regressing ack is byzantine
                shed_reason = "byzantine"
            if shed_reason is None:
                with self._lock:
                    st.last_progress = time.monotonic()
                    self._work.notify_all()
            else:
                with self._lock:
                    self._shed_locked(st, shed_reason)
        self._drain_shed_events()
        if shed_reason is not None:
            raise PeerShed(st.key, shed_reason, st.sent)

    def _wait_peer_done(self, st: _PeerState,
                        timeout: Optional[float]) -> bool:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not (st.done or st.shed is not None or st.gone
                       or self._closed):
                if deadline is not None and time.monotonic() >= deadline:
                    break
                st.cv.wait(_WAKE_FALLBACK)
            return st.done

    # -- the dispatcher (the only thread that touches transports) -----------

    def _dispatch_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    while not (self._closed or self._turn_ready_locked()
                               or self._retention_due()):
                        self._work.wait(_WAKE_FALLBACK)
                    if self._closed:
                        return
                    turn = self._compose_turn_locked()
                progressed = 0
                if turn:
                    with _trace_span("fanout.dispatch", peers=len(turn)):
                        for st, want in turn:
                            progressed += self._serve_peer(st, want)
                    if _OBS.on:
                        _M_TURNS.inc()
                self.log.enforce_retention()
                self._scan_stalls()
                self._reap_dead_fds()
                self._drain_shed_events()  # per-turn catch-all
                if not progressed:
                    # every serveable peer would-blocked (or there was
                    # nothing to serve): back off instead of spinning —
                    # kernel buffers drain on their own clock
                    time.sleep(max(self._linger_s, 0.002)
                               if turn else self._linger_s)
        except BaseException as exc:  # noqa: BLE001 — fanned out below
            # emit BEFORE taking the lock: the event sink can block,
            # and the peers notified below contend on this lock
            _emit("fanout.error", error=f"{type(exc).__name__}: {exc}")
            with self._lock:
                for key in list(self._peers):
                    st = self._peer_state(key)
                    if st.shed is None:
                        st.shed = "dispatcher-error"
                    st.cv.notify_all()

    def _retention_due(self) -> bool:
        """The dispatcher must wake for budget pressure even with zero
        serveable peers — a source can publish gigabytes before the
        first subscriber attaches, and the write path never trims."""
        return self.log.retained_bytes > self.log.retention_budget

    def _turn_ready_locked(self) -> bool:
        end = self.log.end
        sealed = self.log.sealed
        for st in self._peers.values():
            if st.shed is not None or st.gone:
                continue
            if st.sent < end and \
                    st.window_remaining(st.cursor.acked) > 0:
                return True
            if sealed and st.sent >= end and not st.done:
                return True
        return False

    def _compose_turn_locked(self) -> list:
        """Pick (peer, byte budget) pairs for this turn: peers with
        backlog and an open window.  O(peers) bookkeeping — payload
        bytes are never touched here or anywhere in the dispatcher."""
        end = self.log.end
        sealed = self.log.sealed
        turn = []
        for st in self._peers.values():
            if st.shed is not None or st.gone:
                continue
            if sealed and st.sent >= end and not st.done:
                st.done = True
                st.cv.notify_all()
                continue
            if st.sent >= end:
                continue
            want = min(end - st.sent,
                       st.window_remaining(st.cursor.acked))
            if want > 0:
                turn.append((st, want))
        return turn

    def _serve_peer(self, st: _PeerState, want: int) -> int:
        """One windowed scatter-gather push to one peer — runs outside
        the server lock; only the dispatcher thread calls transports.
        Returns the bytes the transport accepted."""
        # only fd peers on the native route take the longer slice run
        # (one batch); sink peers keep their declared max_iov bound
        factor = self._serve_iov_factor if st.sink is None else 1
        try:
            views = self.log.read_slices(st.sent, want,
                                         st.max_iov * factor)
        except SnapshotNeeded:
            with self._lock:
                self._shed_locked(st, "retention")
            self._drain_shed_events()
            return 0
        if not views:
            return 0
        # capture once: a marking thread may park st.fd (-> None) any
        # time; the captured number stays open until THIS thread reaps
        fd = st.fd
        try:
            if st.sink is None:
                if fd is None:
                    return 0  # parked between compose and serve
                if self._gather is not None:
                    # the gather: log-segment addresses go to the kernel
                    # with the GIL released; would-block comes back as a
                    # short accept and a dead peer as OSError, the
                    # os.writev contract the bookkeeping below is
                    # written against
                    n_spans = self._gather.fill(views)
                    try:
                        accepted = _pump.send_spans_nb(
                            fd, self._gather, n_spans)
                    finally:
                        # drop the span pins BEFORE the views are
                        # released below (a pinned view cannot be)
                        self._gather.release()
                else:
                    try:
                        # wire-peer fds are O_NONBLOCK (attach dups the
                        # fd and set_blocking(False)s it): EAGAIN comes
                        # straight back as a short turn, never a stall
                        # datlint: allow-blocking-reachable(os-io)
                        accepted = os.writev(fd, views[:st.max_iov])
                    except (BlockingIOError, InterruptedError):
                        accepted = 0
            else:
                # sink peers are the in-process delivery surface (tests,
                # local taps); the attach contract puts the sink's
                # promptness on the attacher — it runs ON the broadcast
                # turn, and a stalling sink stalls only its own server's
                # fairness window, which the tests exercise.
                # datlint: allow-callback-escape
                accepted = int(st.sink(views))
        except OSError:
            # EPIPE/ECONNRESET/EBADF: the peer's transport died — shed
            # it as a disconnect; nobody else notices
            with self._lock:
                self._shed_locked(st, "disconnect")
            self._drain_shed_events()
            return 0
        finally:
            for v in views:
                v.release()
        if accepted <= 0:
            return 0
        now = time.monotonic()
        with self._lock:
            st.sent += accepted
            st.sent_bytes += accepted
            st.writev_calls += 1
            st.last_progress = now
            self._consume_marks_locked(st, now)
            do_ack = (not st.explicit_ack and st.shed is None
                      and not st.gone)
            ack_to = st.sent
        if do_ack:
            # the log serializes on its own lock (and its trim path
            # emits) — ack with the server lock RELEASED; only this
            # dispatcher thread acks implicit-ack peers, so ack_to is
            # monotone
            try:
                self.log.ack(st.cursor, ack_to)
            except SnapshotNeeded:
                with self._lock:
                    self._shed_locked(st, "retention")
                self._drain_shed_events()
        if _OBS.on:
            _M_SENT.inc(accepted)
            _M_WRITEV.inc()
            self._lit_cost_served(st.key, accepted)
        return accepted

    def _consume_marks_locked(self, st: _PeerState, now: float) -> None:
        # latency attribution: marks this peer's send position has now
        # fully covered become samples; marks that fell off the ring
        # are skipped (the peer lagged past attribution, not delivery)
        if st.mark_seq < self._mark_base:
            st.mark_seq = self._mark_base
        while st.mark_seq < self._mark_base + len(self._marks):
            off, t = self._marks[st.mark_seq - self._mark_base]
            if off > st.sent:
                break
            lat = now - t
            st.lat.append(lat)
            if _OBS.on:
                _H_FRAME_LAT.observe(lat)
            st.mark_seq += 1

    def _scan_stalls(self) -> None:
        """Stage three of the overload contract: a peer with backlog
        making no progress for ``stall_timeout`` is shed (the heaviest
        offender by construction — it is the one pinning the log)."""
        now = time.monotonic()
        with self._lock:
            end = self.log.end
            for key in list(self._peers):
                st = self._peer_state(key)
                if st.shed is not None or st.gone or st.sent >= end:
                    continue
                if now - st.last_progress > self.stall_timeout:
                    self._shed_locked(st, "stall")
        self._drain_shed_events()

    def _park_fd_locked(self, st: _PeerState) -> None:
        """Hand a dead peer's owned fd to the dispatcher for closing.
        Marking threads never close: the dispatcher may be mid-writev
        on this very fd, and a concurrent close would free the number
        for kernel reuse under its write."""
        if st.fd is not None:
            self._dead_fds.append(st.fd)
            st.fd = None

    def _reap_dead_fds(self) -> None:
        """Close parked fds — dispatcher thread only, so a close can
        never race this same thread's writev."""
        with self._lock:
            dead, self._dead_fds = self._dead_fds, []
        for fd in dead:
            try:
                os.close(fd)
            except OSError:
                pass

    def _shed_locked(self, st: _PeerState, reason: str) -> None:
        if st.shed is not None or st.gone:
            return
        st.shed = reason
        st.cursor.invalidated = True  # stop pinning the trim floor
        self._park_fd_locked(st)
        st.cv.notify_all()
        if _OBS.on:
            _M_SHED.inc()
        # the EVENT is deferred: queued here (fields captured while
        # consistent), emitted by _drain_shed_events after release
        self._shed_events.queue_locked(
            key=st.key, reason=reason, sent=st.sent,
            peers=len(self._peers))

    def _drain_shed_events(self) -> None:
        """Emit queued shed events with the server lock RELEASED.
        Called by every path that can shed, plus once per dispatcher
        turn as the catch-all."""
        self._shed_events.flush()

    # -- snapshots / lifecycle ----------------------------------------------

    def _peer_stats_locked(self, st: _PeerState) -> dict:
        lat = sorted(st.lat)
        return {
            "sent_bytes": st.sent_bytes,
            "offset": st.sent,
            "acked": st.cursor.acked,
            "backlog_bytes": max(0, self.log.end - st.sent),
            "writev_calls": st.writev_calls,
            "shed": st.shed,
            "done": st.done,
            "lat_p50_ms": round(lat[len(lat) // 2] * 1e3, 3) if lat else None,
            "lat_p99_ms": round(
                lat[min(len(lat) - 1, int(0.99 * len(lat)))] * 1e3, 3)
            if lat else None,
        }

    def _peer_stats(self, st: _PeerState) -> dict:
        with self._lock:
            return self._peer_stats_locked(st)

    def peers_snapshot(self) -> dict:
        """{key: per-peer stats} for every attached peer — the
        ``peers`` breakdown the sidecar's ``--stats-fd`` lines carry in
        fan-out mode."""
        with self._lock:
            return {key: self._peer_stats_locked(self._peer_state(key))
                    for key in self._peers}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "peers": len(self._peers),
                "retained_bytes": self.log.retained_bytes,
                "log_start": self.log.start,
                "log_end": self.log.end,
                "sealed": self.log.sealed,
            }

    def admission_state(self) -> dict:
        """Lock-free admission view for ``/healthz``: plain
        attribute reads, at worst one update stale — the health probe
        must never block behind the dispatcher's lock (the hub's
        ``admission_state`` contract, restated for peers)."""
        peers = len(self._peers)
        return {
            "open": not self._closed and peers < self.max_peers,
            "peers": peers,
            "max_peers": self.max_peers,
            "sealed": self.log.sealed,
        }

    def _collect(self) -> dict:
        """Registry collector: labeled per-peer entries for peers
        currently attached (bounded cardinality by construction — the
        labeled-collector machinery)."""
        counters: dict = {}
        gauges: dict = {}
        with self._lock:
            gauges["fanout.peers"] = float(len(self._peers))
            end = self.log.end
            for key in self._peers:
                st = self._peer_state(key)
                label = f"{{peer={key}}}"
                counters["fanout.peer.sent_bytes" + label] = st.sent_bytes
                counters["fanout.peer.writev" + label] = st.writev_calls
                gauges["fanout.peer.backlog_bytes" + label] = \
                    float(max(0, end - st.sent))
        return {"counters": counters, "gauges": gauges}

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every live peer has the sealed log fully
        delivered (or is shed); returns True on full delivery."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                live = [st for st in self._peers.values()
                        if st.shed is None and not st.gone]
                if self.log.sealed and all(st.done for st in live):
                    return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.002)

    def close(self) -> None:
        """Stop the dispatcher and release the collector; attached
        peers observe ``shed``-free ``gone`` semantics via their
        handles.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for key in list(self._peers):
                self._peer_state(key).cv.notify_all()
            self._work.notify_all()
            thread = self._thread
        self.log.set_append_hook(None)
        if thread is not None:
            thread.join(timeout=5)
        # the dispatcher is down: closing owned fds cannot race it now
        with self._lock:
            for key in list(self._peers):
                self._park_fd_locked(self._peer_state(key))
            dead, self._dead_fds = self._dead_fds, []
        for fd in dead:
            try:
                os.close(fd)
            except OSError:
                pass
        with self._lock:
            keys = list(self._peers)
        for key in keys:
            _WATERMARKS.untrack(f"fanout/{key}")
        _WATERMARKS.untrack(_WM_LINK)
        _REGISTRY.unregister_collector("fanout", self._collector_fn)

    def __enter__(self) -> "FanoutServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
