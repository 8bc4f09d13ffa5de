"""The shared replication engine: admission, windows, fair batching,
shedding.

The port of ``dat_replication_protocol_tpu/hub/engine.py``.  One
:class:`ReplicationHub` owns one
:class:`~..backend.cuda_backend.DigestPipeline` (kernel B1 on one card,
or B1 on every rank of a mesh) and multiplexes every registered session
onto it:

* **Edge state, shared engine.**  Each session keeps its own queues,
  window accounting and stats in a :class:`_SessionState`; the pipeline
  sees only composed batches.  Completions carry the session's state in
  their tag and route back without a shared lookup.
* **Admission.**  ``register()`` raises a structured :class:`HubBusy`
  once the session count or half the parked-bytes budget is reached.
* **Per-session windows.**  ``submit()`` blocks the calling session's
  thread while its parked work (queued, in the pipeline, undelivered)
  fills its window; a slow consumer stalls only its own window, and the
  dispatcher never runs a session's callback.
* **Weighted-fair batching.**  Each batch takes a weight-proportional
  quota from every session with work, round-robin, then fills what is
  left greedily.
* **Shedding.**  Past the parked budget (or, with ``latency_shed_s``, a
  recent dispatch-turn p99 above it while parked bytes exceed half the
  budget) the session holding the most parked bytes is shed: its queue
  is dropped, its in-flight completions are discarded on arrival, its
  thread sees :class:`SessionShed` and one ``hub.shed`` event names it.

No lock is held across a device dispatch: batches are composed under
``self._lock`` and handed to the pipeline outside it, and shed events
leave through a :class:`~..obs.events.DeferredEmitQueue` once the lock
is released.  Per-session state is reached only through
:meth:`ReplicationHub._session_state` or a handle taken from it.

**The device.**  The dispatcher thread is the only one that calls the
pipeline.  It sets its CUDA device before its first launch, and a hub
on a card loads B1's library when it is built, so the first turn does
not carry the kernel build (which could trip the latency shed arm).  A
pipeline that fails (B1 does not build or launch, a collective fails)
ends the dispatcher; every session then sees :class:`HubError`.  There
is no second engine to fall back to.

**The mesh.**  ``mesh=`` shards every composed batch over a
``torch.distributed`` mesh with :func:`..parallel.mesh.sharded_hash_begin`
(kernel B1 on each rank).  ``"auto"`` is
:func:`..parallel.mesh.make_mesh` over the initialized process group,
an int pins its size, a :class:`~..parallel.mesh.Mesh` is used as it
is; without an initialized group it raises, as ``make_mesh`` does.  The
port runs one process a device, so the hub runs on rank 0 and sends each
batch's payloads to the other ranks before the call, and every rank >= 1
runs :func:`mesh_follower`, which makes the same call for each batch and
returns on the stop message the dispatcher sends once the hub is closed.
The dispatcher issues every collective of rank 0, the stop too, so the
followers see them in one order.  A dispatcher that fails instead tears
the group down: a failure can come between a batch's collectives, and a
stop message would then meet a follower inside the batch.  The
followers' collectives raise (``gloo`` at once; ``nccl`` at the group's
timeout, unless the launcher ends them first).  A one-rank mesh needs
no follower.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

import torch

from ..obs.device import note_engine as _note_engine
from ..obs.events import DeferredEmitQueue as _DeferredEmitQueue
from ..obs.events import emit as _emit
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import REGISTRY as _REGISTRY
from ..obs.metrics import counter as _counter
from ..obs.metrics import gauge as _gauge
from ..obs.metrics import histogram as _histogram

__all__ = [
    "ReplicationHub",
    "HubSession",
    "HubBusy",
    "HubError",
    "SessionShed",
    "mesh_follower",
]

# the reference's hub.* catalog (OBSERVABILITY.md)
_M_SESSIONS = _gauge("hub.sessions")
_M_PARKED = _gauge("hub.parked.bytes")
_M_ADMITTED = _counter("hub.admitted")
_M_REJECTED = _counter("hub.rejected")
_M_SHED = _counter("hub.shed")
_M_BATCHES = _counter("hub.dispatch.batches")
_M_ITEMS = _counter("hub.dispatch.items")
_M_BYTES = _counter("hub.dispatch.bytes")
_M_DROPPED = _counter("hub.completions.dropped")
_H_LATENCY = _histogram("hub.dispatch.latency")

# wakeups are condition notifies; this bounds a wait only if one is lost
_WAKE_FALLBACK = 0.05

# characters a session key may not hold: keys ride label sets
# ({session=KEY}) and JSON breakdowns
_BAD_KEY_CHARS = "{},=\"\n\r"


class HubBusy(RuntimeError):
    """Structured admission rejection: the hub is at capacity.  Carries
    the decision's inputs (``sessions``/``max_sessions``,
    ``parked_bytes``/``parked_budget``) so a caller can answer with a
    retry hint instead of letting queues grow."""

    def __init__(self, message: str, *, sessions: int, max_sessions: int,
                 parked_bytes: int, parked_budget: int):
        super().__init__(message)
        self.sessions = sessions
        self.max_sessions = max_sessions
        self.parked_bytes = parked_bytes
        self.parked_budget = parked_budget


class SessionShed(RuntimeError):
    """This session was shed by the hub.  ``reason`` is the policy arm
    (``parked-budget`` or ``dispatch-latency``); ``parked_bytes`` is what
    the session held when shed."""

    def __init__(self, key: str, reason: str, parked_bytes: int):
        super().__init__(
            f"session {key!r} shed by hub ({reason}, "
            f"{parked_bytes} parked bytes)")
        self.key = key
        self.reason = reason
        self.parked_bytes = parked_bytes


class HubError(RuntimeError):
    """The shared engine failed (the dispatcher died) or the hub is
    closed; every session observes the same error."""


class _SessionState:
    """Per-session edge state, mutated only under the hub lock and
    reached only through the hub's session-keyed accessor or a handle
    taken from it."""

    __slots__ = (
        "key", "weight", "cv", "q", "q_items", "q_bytes",
        "out_items", "out_bytes", "comp", "comp_items", "comp_bytes",
        "submitted", "submitted_bytes", "delivered", "delivered_bytes",
        "dispatches", "shed", "shed_parked", "gone", "flush_goal",
        "nowait",
    )

    def __init__(self, key: str, weight: float, lock: threading.Lock,
                 nowait: bool = False):
        self.key = key
        self.weight = weight
        self.nowait = nowait
        self.cv = threading.Condition(lock)
        self.q: deque = deque()   # (kind, item, cb, tag, nbytes)
        self.q_items = 0
        self.q_bytes = 0
        self.out_items = 0        # in the shared pipeline
        self.out_bytes = 0
        self.comp: deque = deque()  # (cb, tag, digest, nbytes)
        self.comp_items = 0
        self.comp_bytes = 0
        self.submitted = 0
        self.submitted_bytes = 0
        self.delivered = 0
        self.delivered_bytes = 0
        self.dispatches = 0       # batches this session contributed to
        self.shed: Optional[str] = None
        self.shed_parked = 0      # parked bytes when shed
        self.gone = False
        self.flush_goal: Optional[int] = None

    @property
    def parked_bytes(self) -> int:
        return self.q_bytes + self.out_bytes + self.comp_bytes

    @property
    def parked_items(self) -> int:
        return self.q_items + self.out_items + self.comp_items


class HubSession:
    """A session's handle on the hub, and a drop-in ``pipeline`` for
    :class:`~..backend.cuda_backend.CudaDecoder` / ``CudaEncoder``: the
    ``submit`` / ``submit_stream`` / ``flush`` surface of
    :class:`~..backend.cuda_backend.DigestPipeline`, with the work
    batched across sessions behind it.  Completions are delivered on the
    session's own thread (inside ``submit``/``flush``), in submit order,
    so a callback that blocks parks only this session."""

    def __init__(self, hub: "ReplicationHub", state: _SessionState):
        self._hub = hub
        self._state = state

    @property
    def key(self) -> str:
        return self._state.key

    @property
    def shed_reason(self) -> Optional[str]:
        return self._state.shed

    def submit(self, payload, on_digest: Callable, tag=None) -> None:
        self._hub._submit_run(
            self._state,
            (("payload", payload, on_digest, tag, len(payload)),),
            len(payload))

    def submit_many(self, payloads, on_digest: Callable,
                    tag_base: int = 0) -> None:
        """Submit a run of payloads (tags ``tag_base .. tag_base + n - 1``)
        with one window check and one lock round trip.  The run is
        admitted whole once the window has any room, as one oversized
        item is; an empty run does nothing."""
        entries = [("payload", p, on_digest, tag_base + k, len(p))
                   for k, p in enumerate(payloads)]
        if entries:
            self._hub._submit_run(self._state, entries,
                                  sum(e[4] for e in entries))

    def submit_stream(self, stream, on_digest: Callable, tag=None) -> None:
        nbytes = int(getattr(stream, "length", 0))
        self._hub._submit_run(
            self._state, (("stream", stream, on_digest, tag, nbytes),),
            nbytes)

    def flush(self) -> None:
        self._hub._flush_session(self._state)

    # -- the nowait surface (an event loop's sessions) ----------------------

    def poll(self) -> int:
        """Deliver whatever digests have routed back, on this thread, in
        submit order, without waiting; returns how many.  Raises
        :class:`SessionShed` / :class:`HubError` as ``submit`` does."""
        return self._hub._poll_session(self._state)

    @property
    def has_completions(self) -> bool:
        """Lock-free: completions wait for :meth:`poll` (a plain
        attribute read, at worst one update stale)."""
        return self._state.comp_items > 0

    def window_room(self) -> bool:
        """Lock-free mirror of the submit window check: an event loop
        stops reading a session's socket while this is False, so the
        socket buffer absorbs the overload instead of a blocked thread."""
        st, hub = self._state, self._hub
        return st.parked_items < hub.window_items and (
            st.parked_bytes < hub.window_bytes or st.parked_items == 0)

    @property
    def drained(self) -> bool:
        """Lock-free: nothing queued, in the pipeline or undelivered."""
        return self._state.parked_items == 0

    def close(self) -> None:
        """Unregister: queued work is dropped, in-flight completions are
        discarded on arrival.  Idempotent."""
        self._hub._unregister(self._state)

    def stats(self) -> dict:
        return self._hub._session_stats(self._state)

    def __enter__(self) -> "HubSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _resolve_mesh(mesh, device):
    """``mesh=`` as a :class:`~..parallel.mesh.Mesh`: ``"auto"`` is the
    whole initialized group, an int pins its size.  Raises when no group
    is initialized, and on a rank other than 0."""
    from ..parallel import mesh as pmesh

    if isinstance(mesh, pmesh.Mesh):
        m = mesh
    elif mesh == "auto":
        m = pmesh.make_mesh(device=device)
    elif isinstance(mesh, int) and not isinstance(mesh, bool):
        m = pmesh.make_mesh(mesh, device=device)
    else:
        raise ValueError(f"mesh must be 'auto', an int or a Mesh, got "
                         f"{mesh!r}")
    if m.rank != 0:
        raise ValueError(f"the hub runs on rank 0; rank {m.rank} runs "
                         "hub.mesh_follower(mesh)")
    return m


def _mesh_hash_begin(mesh):
    """The cross-session batch over the mesh: each batch's payloads go
    to the other ranks first, then every rank hashes its shard on B1."""
    from ..parallel import mesh as pmesh

    def begin(payloads):
        if mesh.size > 1:
            pmesh.broadcast_payloads(mesh, payloads)
        return pmesh.sharded_hash_begin(mesh, payloads)

    return begin


def mesh_follower(mesh) -> int:
    """Run a rank >= 1's half of a mesh hub: receive each batch rank 0's
    hub composes and make the same :func:`..parallel.mesh.
    sharded_hash_begin` call, until the stop message of the hub's
    ``close()``.  Returns the number of batches hashed."""
    from ..parallel import mesh as pmesh

    if mesh.rank == 0:
        raise ValueError("rank 0 runs the hub, not a follower")
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    batches = 0
    while True:
        payloads = pmesh.receive_payloads(mesh)
        if payloads is None:
            return batches
        pmesh.sharded_hash_begin(mesh, payloads)()
        batches += 1


class ReplicationHub:
    """See the module docstring.  One hub per process; sessions come and
    go through :meth:`register` and :meth:`HubSession.close`.

    ``device`` (default ``"cuda"``) is the card the hub's pipeline
    hashes on; ``hash_begin`` replaces the engine (the
    :func:`..ops.blake2b.blake2b_batch_begin` contract); ``mesh``
    (``"auto"``, an int or a ``Mesh``) shards every batch over a process
    group instead.
    """

    def __init__(
        self,
        *,
        hash_begin: Optional[Callable] = None,
        mesh=None,
        device="cuda",
        max_sessions: int = 1024,
        parked_budget: int = 256 << 20,
        window_items: int = 4096,
        window_bytes: int = 32 << 20,
        max_batch: int = 1024,
        max_batch_bytes: int = 1 << 30,
        linger_s: float = 0.002,
        latency_shed_s: Optional[float] = None,
    ):
        from ..backend.cuda_backend import DigestPipeline
        from ..utils.device import resolve_device

        self._mesh = None
        self._device: Optional[torch.device] = None
        if mesh is not None:
            if hash_begin is not None:
                raise ValueError("pass mesh= or hash_begin=, not both")
            self._mesh = _resolve_mesh(mesh, device)
            self._device = self._mesh.device
            hash_begin = _mesh_hash_begin(self._mesh)
            if _OBS.on:
                _note_engine("digest.hash", "mesh-sharded",
                             devices=self._mesh.size)
        elif hash_begin is None:
            self._device = resolve_device(device)
        if self._device is not None and self._device.type == "cuda":
            # build and load B1 now: a first turn that carried the
            # build could trip the dispatch-latency shed arm
            from ..ops import _build

            _build.load("blake2b")
        # the hub owns batching: one dispatch per composed batch
        self._pipeline = DigestPipeline(
            hash_begin=hash_begin, max_batch=max_batch,
            max_batch_bytes=max_batch_bytes,
            device=self._device if self._device is not None else "cpu")
        self.max_sessions = int(max_sessions)
        self.parked_budget = int(parked_budget)
        self.window_items = int(window_items)
        self.window_bytes = int(window_bytes)
        self._max_batch = int(max_batch)
        self._max_batch_bytes = int(max_batch_bytes)
        self._linger_s = float(linger_s)
        self.latency_shed_s = latency_shed_s

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._sessions: dict[str, _SessionState] = {}
        # shed events queued under the lock, emitted once it is released
        self._shed_events = _DeferredEmitQueue("hub.shed", self._lock)
        # datlint: guarded-by(self._lock): self._sessions
        self._next_id = 0
        self._rr = 0
        self._q_items = 0            # queued, not yet in the pipeline
        self._q_bytes = 0
        self._parked_bytes = 0       # queued + in the pipeline + undelivered
        self._oldest_ts: Optional[float] = None
        self._routed: list = []     # the dispatcher thread's (see _route)
        # recent dispatch-turn latencies: the latency arm reads this
        # window's p99, not one slow turn
        self._lat_ring: deque = deque(maxlen=64)
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._failed: Optional[BaseException] = None
        # bound once: close() unregisters by identity, so a closing hub
        # never removes its successor's collector
        self._collector_fn = self._collect
        _REGISTRY.register_collector("hub", self._collector_fn)

    @property
    def mesh(self):
        """The mesh the hub shards batches over, or None."""
        return self._mesh

    # -- registration / admission -------------------------------------------

    def register(self, key: Optional[str] = None,
                 weight: float = 1.0, *,
                 nowait: bool = False) -> HubSession:
        """Admit one session; raises :class:`HubBusy` when the session
        count or half the parked budget is reached.

        ``nowait=True`` registers an event-driven session: ``submit`` and
        ``flush`` never block and never deliver inline; completions are
        drained by :meth:`HubSession.poll`, and the caller enforces the
        window by gating its reads on :meth:`HubSession.window_room`.
        Admission and shedding are the same."""
        if weight <= 0:
            raise ValueError("session weight must be > 0")
        if key is not None and (not key or any(
                c in key for c in _BAD_KEY_CHARS)):
            raise ValueError(
                f"session key {key!r} must be non-empty and contain "
                'none of {},=" or newlines')
        busy = None
        with self._lock:
            self._check_alive_locked()
            if key is None:
                key = f"s{self._next_id}"
            self._next_id += 1
            if key in self._sessions:
                raise ValueError(f"session key {key!r} already registered")
            # admission closes at half the shed budget: refusing a
            # newcomer is cheap, shedding a live session is not
            if len(self._sessions) >= self.max_sessions or \
                    self._parked_bytes >= self.parked_budget // 2:
                busy = HubBusy(
                    f"hub at capacity ({len(self._sessions)}/"
                    f"{self.max_sessions} sessions, "
                    f"{self._parked_bytes}/{self.parked_budget} parked "
                    f"bytes)",
                    sessions=len(self._sessions),
                    max_sessions=self.max_sessions,
                    parked_bytes=self._parked_bytes,
                    parked_budget=self.parked_budget,
                )
            else:
                st = _SessionState(key, float(weight), self._lock,
                                   nowait=nowait)
                self._sessions[key] = st
                sessions_now = len(self._sessions)
                if _OBS.on:
                    _M_SESSIONS.set(sessions_now)
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._dispatch_loop, name="hub-dispatch",
                        daemon=True)
                    self._thread.start()
        if busy is not None:
            if _OBS.on:
                _M_REJECTED.inc()
                _emit("hub.reject", key=key, sessions=busy.sessions,
                      max_sessions=self.max_sessions,
                      parked_bytes=busy.parked_bytes,
                      parked_budget=self.parked_budget)
            raise busy
        if _OBS.on:
            _M_ADMITTED.inc()
            _emit("hub.admit", key=key, weight=float(weight),
                  sessions=sessions_now)
        return HubSession(self, st)

    def _session_state(self, key: str) -> _SessionState:
        """The session-keyed accessor: every reach into per-session state
        by key goes through here."""
        return self._sessions[key]

    def _unregister(self, st: _SessionState) -> None:
        done_stats = None
        with self._lock:
            if st.gone:
                return
            st.gone = True
            # queued and undelivered work leaves the parked set now;
            # in-pipeline bytes leave as their completions route back
            self._q_items -= st.q_items
            self._q_bytes -= st.q_bytes
            self._parked_bytes -= st.q_bytes + st.comp_bytes
            st.q.clear()
            st.q_items = st.q_bytes = 0
            st.comp.clear()
            st.comp_items = st.comp_bytes = 0
            if self._sessions.get(st.key) is st:
                del self._sessions[st.key]
            st.cv.notify_all()
            self._work.notify_all()
            if _OBS.on:
                _M_SESSIONS.set(len(self._sessions))
                _M_PARKED.set(self._parked_bytes)
                done_stats = self._session_stats_locked(st)
        if done_stats is not None:
            _emit("hub.session.done", key=st.key, shed=st.shed,
                  **{k: v for k, v in done_stats.items()
                     if k in ("submitted", "delivered", "submitted_bytes",
                              "dispatches")})

    # -- the session side (runs on the session's own thread) ----------------

    def _submit_run(self, st: _SessionState, entries, run_bytes: int) -> None:
        """Admit a run of entries into the session's queue with one lock
        round trip; blocks, delivering ready completions meanwhile, while
        the session's window is full."""
        try:
            self._submit_run_inner(st, entries, run_bytes, len(entries))
        finally:
            # a shed this submit caused leaves with the lock released
            self._drain_shed_events()

    def _enqueue_locked(self, st: _SessionState, entries, run_bytes: int,
                        n: int) -> None:
        st.q.extend(entries)
        st.q_items += n
        st.q_bytes += run_bytes
        st.submitted += n
        st.submitted_bytes += run_bytes
        was_idle = self._q_items == 0
        self._q_items += n
        self._q_bytes += run_bytes
        self._parked_bytes += run_bytes
        if self._oldest_ts is None:
            self._oldest_ts = time.monotonic()
        if _OBS.on:
            _M_PARKED.set(self._parked_bytes)
        self._maybe_shed_locked()
        self._check_session_alive_locked(st)
        # wake the dispatcher only on the transitions it acts on
        if was_idle or self._q_items >= self._max_batch:
            self._work.notify_all()

    def _submit_run_inner(self, st: _SessionState, entries,
                          run_bytes: int, n: int) -> None:
        if st.nowait:
            # never wait, never deliver inline: the caller gated its read
            # on window_room() before decoding these entries
            with self._lock:
                self._check_session_alive_locked(st)
                self._enqueue_locked(st, entries, run_bytes, n)
            return
        while True:
            with self._lock:
                self._check_session_alive_locked(st)
                ready = self._pop_completions_locked(st)
                if not ready:
                    # a run (or one oversized item) is admitted whole once
                    # the window has any room, so an empty window never
                    # deadlocks
                    if st.parked_items < self.window_items and (
                            st.parked_bytes < self.window_bytes
                            or st.parked_items == 0):
                        self._enqueue_locked(st, entries, run_bytes, n)
                        return
                    st.cv.wait(_WAKE_FALLBACK)
                    continue
            self._deliver(st, ready)

    def _flush_session(self, st: _SessionState) -> None:
        """Block until every item this session submitted before the call
        has had its digest delivered: the per-session flush-before-
        finalize barrier."""
        with self._lock:
            self._check_session_alive_locked(st)
            st.flush_goal = st.submitted
            self._work.notify_all()
        if st.nowait:
            # the barrier moves to the caller (it defers finalize until
            # drained); the goal makes the dispatcher drain promptly
            return
        try:
            while True:
                with self._lock:
                    ready = self._pop_completions_locked(st)
                    if not ready:
                        self._check_session_alive_locked(st)
                        if st.delivered >= (st.flush_goal or 0):
                            return
                        st.cv.wait(_WAKE_FALLBACK)
                        continue
                self._deliver(st, ready)
        finally:
            with self._lock:
                st.flush_goal = None

    def _poll_session(self, st: _SessionState) -> int:
        with self._lock:
            ready = self._pop_completions_locked(st)
            if not ready:
                # an idle nowait session learns of a shed or close here
                self._check_session_alive_locked(st)
                return 0
        self._deliver(st, ready)
        return len(ready)

    def _pop_completions_locked(self, st: _SessionState) -> list:
        if not st.comp:
            return []
        ready = list(st.comp)
        st.comp.clear()
        st.comp_items = 0
        freed = st.comp_bytes
        st.comp_bytes = 0
        # counted at pop time: the popping thread is the delivering one
        st.delivered += len(ready)
        st.delivered_bytes += freed
        self._parked_bytes -= freed
        if _OBS.on:
            _M_PARKED.set(self._parked_bytes)
        return ready

    @staticmethod
    def _deliver(st: _SessionState, ready: list) -> None:
        # callbacks run on the session's own thread with no hub lock held
        for cb, tag, digest, nbytes in ready:
            if tag is None:
                cb(digest)
            else:
                cb(tag, digest)

    def _check_alive_locked(self) -> None:
        if self._failed is not None:
            raise HubError(
                f"hub dispatcher failed: {self._failed!r}") from self._failed
        if self._closed:
            raise HubError("hub is closed")

    def _check_session_alive_locked(self, st: _SessionState) -> None:
        self._check_alive_locked()
        if st.shed is not None:
            raise SessionShed(st.key, st.shed, st.shed_parked)
        if st.gone:
            raise HubError(f"session {st.key!r} is closed")

    # -- the dispatcher (the only thread that calls the pipeline) -----------

    def _dispatch_loop(self) -> None:
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while True:
                with self._lock:
                    while not (self._closed or self._failed
                               or self._turn_ready_locked()):
                        self._work.wait(self._wait_s_locked())
                    if self._closed or self._failed:
                        break
                    batch = self._compose_locked()
                    engine_flush = self._flush_needed_locked()
                t0 = time.monotonic()
                turn_bytes = 0
                for entry_st, kind, item, cb, tag, nbytes in batch:
                    routed = (entry_st, cb, tag, nbytes)
                    if kind == "payload":
                        self._pipeline.submit(item, self._route, routed)
                    else:
                        self._pipeline.submit_stream(item, self._route,
                                                     routed)
                    turn_bytes += nbytes
                if batch:
                    self._pipeline.dispatch()
                with self._lock:
                    drain_idle = (self._q_items == 0
                                  and self._pipeline.inflight > 0)
                if engine_flush or drain_idle:
                    # the queue is dry or a session waits at its barrier:
                    # drain the readback so windows and barriers release
                    self._pipeline.flush()
                self._distribute_routed()
                if batch or engine_flush:
                    latency = time.monotonic() - t0
                    self._lat_ring.append(latency)
                    if _OBS.on:
                        _H_LATENCY.observe(latency)
                        if batch:
                            _M_BATCHES.inc()
                            _M_ITEMS.inc(len(batch))
                            _M_BYTES.inc(turn_bytes)
                    ordered = sorted(self._lat_ring)
                    p99 = ordered[min(len(ordered) - 1,
                                      int(0.99 * len(ordered)))]
                    with self._lock:
                        self._maybe_shed_locked(latency_p99=p99)
                self._drain_shed_events()
            if self._has_followers():
                # closed between batches: the followers take the stop
                from ..parallel import mesh as pmesh

                pmesh.broadcast_stop(self._mesh)
        except BaseException as exc:  # noqa: BLE001 — fanned out below
            # emitted before the lock: the sink can block
            _emit("hub.error", error=f"{type(exc).__name__}: {exc}")
            with self._lock:
                self._failed = exc
                for key in list(self._sessions):
                    self._session_state(key).cv.notify_all()
                self._work.notify_all()
            if self._has_followers():
                # the followers may be inside a batch's collectives: a
                # torn-down group closes its connections (gloo at once
                # once nothing holds it; nccl peers at its timeout)
                import torch.distributed as dist

                dist.destroy_process_group(self._mesh.group)

    def _has_followers(self) -> bool:
        return self._mesh is not None and self._mesh.size > 1

    def _turn_ready_locked(self) -> bool:
        if self._flush_needed_locked():
            return True
        if self._q_items == 0:
            return self._pipeline.inflight > 0
        if self._q_items >= self._max_batch or \
                self._q_bytes >= self._max_batch_bytes:
            return True
        return (self._oldest_ts is not None
                and time.monotonic() - self._oldest_ts >= self._linger_s)

    def _wait_s_locked(self) -> float:
        if self._oldest_ts is not None:
            remaining = self._linger_s - (time.monotonic() - self._oldest_ts)
            if remaining > 0:
                return min(_WAKE_FALLBACK, remaining)
        return _WAKE_FALLBACK

    def _flush_needed_locked(self) -> bool:
        for st in self._sessions.values():
            # a shed session's goal can never be met; its own thread is
            # about to see SessionShed and clear it
            if st.flush_goal is not None and st.shed is None and \
                    st.delivered + st.comp_items < st.flush_goal:
                return True
        return False

    def _compose_locked(self) -> list:
        """The weighted-fair cross-session batch: one quota pass in
        proportion to weight, round-robin from a rotating start, then a
        greedy fill.  Moves accounting from queued to outstanding; the
        caller dispatches outside the lock."""
        order = [st for st in self._sessions.values()
                 if st.q_items and st.shed is None]
        if not order:
            return []
        start = self._rr % len(order)
        order = order[start:] + order[:start]
        self._rr += 1
        total_w = sum(st.weight for st in order)
        items_left = self._max_batch
        bytes_left = self._max_batch_bytes
        batch: list = []

        def take(st: _SessionState, limit: int) -> int:
            nonlocal items_left, bytes_left
            n = 0
            while n < limit and items_left and st.q:
                nbytes = st.q[0][4]
                if st.q[0][0] == "payload" and nbytes > bytes_left \
                        and batch:
                    break  # an oversized item waits for its own batch
                kind, item, cb, tag, nbytes = st.q.popleft()
                st.q_items -= 1
                st.q_bytes -= nbytes
                st.out_items += 1
                st.out_bytes += nbytes
                self._q_items -= 1
                self._q_bytes -= nbytes
                batch.append((st, kind, item, cb, tag, nbytes))
                items_left -= 1
                if kind == "payload":
                    bytes_left -= nbytes
                n += 1
            return n

        for st in order:  # quota pass
            quota = max(1, int(self._max_batch * st.weight / total_w))
            if take(st, quota):
                st.dispatches += 1
        for st in order:  # greedy fill
            if items_left <= 0 or bytes_left <= 0:
                break
            take(st, items_left)
        self._oldest_ts = time.monotonic() if self._q_items else None
        return batch

    def _route(self, routed, digest: bytes) -> None:
        """Pipeline completion -> the dispatcher's own buffer (only the
        dispatcher calls the pipeline, so no lock);
        :meth:`_distribute_routed` moves it to the sessions in one locked
        pass a turn."""
        self._routed.append((routed, digest))

    def _distribute_routed(self) -> None:
        routed, self._routed = self._routed, []
        if not routed:
            return
        dropped = 0
        with self._lock:
            touched = set()
            for (st, cb, tag, nbytes), digest in routed:
                st.out_items -= 1
                st.out_bytes -= nbytes
                if st.gone or st.shed is not None:
                    # nobody listens: its bytes leave the parked set here
                    self._parked_bytes -= nbytes
                    dropped += 1
                else:
                    st.comp.append((cb, tag, digest, nbytes))
                    st.comp_items += 1
                    st.comp_bytes += nbytes
                touched.add(st)
            for st in touched:
                st.cv.notify_all()
            if dropped and _OBS.on:
                _M_DROPPED.inc(dropped)
                _M_PARKED.set(self._parked_bytes)

    # -- overload policy ----------------------------------------------------

    def _maybe_shed_locked(self,
                           latency_p99: Optional[float] = None) -> None:
        over_budget = self._parked_bytes > self.parked_budget
        slow = (latency_p99 is not None
                and self.latency_shed_s is not None
                and latency_p99 > self.latency_shed_s
                and self._parked_bytes > self.parked_budget // 2)
        if not (over_budget or slow):
            return
        reason = "parked-budget" if over_budget else "dispatch-latency"
        live = [st for st in self._sessions.values() if st.shed is None]
        if not live:
            return
        victim = max(live, key=lambda st: st.parked_bytes)
        self._shed_locked(victim, reason)

    def _shed_locked(self, st: _SessionState, reason: str) -> None:
        held = st.parked_bytes
        st.shed = reason
        st.shed_parked = held
        # queued and undelivered leave the parked set now; in-pipeline
        # bytes leave as their discarded completions route back
        self._q_items -= st.q_items
        self._q_bytes -= st.q_bytes
        self._parked_bytes -= st.q_bytes + st.comp_bytes
        st.q.clear()
        st.q_items = st.q_bytes = 0
        st.comp.clear()
        st.comp_items = st.comp_bytes = 0
        st.cv.notify_all()
        if _OBS.on:
            _M_SHED.inc()
            _M_PARKED.set(self._parked_bytes)
        self._shed_events.queue_locked(
            key=st.key, reason=reason, parked_bytes=held,
            sessions=len(self._sessions))

    def _drain_shed_events(self) -> None:
        """Emit queued shed events with the hub lock released (the
        submit path, and once a dispatcher turn)."""
        self._shed_events.flush()

    # -- snapshots / lifecycle ----------------------------------------------

    def _session_stats_locked(self, st: _SessionState) -> dict:
        return {
            "parked_bytes": st.parked_bytes,
            "submitted": st.submitted,
            "submitted_bytes": st.submitted_bytes,
            "delivered": st.delivered,
            "dispatches": st.dispatches,
            "shed": st.shed,
        }

    def _session_stats(self, st: _SessionState) -> dict:
        with self._lock:
            return self._session_stats_locked(st)

    def sessions_snapshot(self) -> dict:
        """``{key: per-session stats}`` for every live session: the
        ``sessions`` breakdown of the sidecar's ``--stats-fd`` lines."""
        with self._lock:
            return self._sessions_snapshot_locked()

    def _sessions_snapshot_locked(self) -> dict:
        return {key: self._session_stats_locked(self._session_state(key))
                for key in self._sessions}

    def snapshot(self) -> dict:
        from ..session.pump import effective_pump_route

        pump_route = effective_pump_route()
        with self._lock:
            return self._snapshot_locked(pump_route)

    def _snapshot_locked(self, pump_route: str) -> dict:
        return {
            "sessions": len(self._sessions),
            "parked_bytes": self._parked_bytes,
            "queued_items": self._q_items,
            "pump_route": pump_route,
            "failed": (None if self._failed is None
                       else f"{type(self._failed).__name__}: "
                            f"{self._failed}"),
        }

    def stats_sections(self) -> tuple:
        """``(snapshot(), sessions_snapshot())`` from ONE hold of the hub
        lock, so a stats record's session count and its breakdown agree
        (taken apart, a session can register or close between them)."""
        from ..session.pump import effective_pump_route

        pump_route = effective_pump_route()
        with self._lock:
            return (self._snapshot_locked(pump_route),
                    self._sessions_snapshot_locked())

    def admission_state(self) -> dict:
        """Lock-free admission view for ``/healthz``: plain attribute
        reads, at worst one update stale, so a probe never waits behind
        a wedged dispatcher holding the hub lock."""
        sessions = len(self._sessions)
        parked = self._parked_bytes
        return {
            "open": (not self._closed and self._failed is None
                     and sessions < self.max_sessions
                     and parked < self.parked_budget // 2),
            "sessions": sessions,
            "max_sessions": self.max_sessions,
            "parked_bytes": parked,
            "parked_budget": self.parked_budget,
            "failed": self._failed is not None,
        }

    def _collect(self) -> dict:
        """Registry collector: labeled per-session entries for the live
        sessions (dead ones stop appearing)."""
        counters: dict = {}
        gauges: dict = {}
        with self._lock:
            gauges["hub.sessions"] = float(len(self._sessions))
            for key in self._sessions:
                st = self._session_state(key)
                label = f"{{session={key}}}"
                gauges["hub.session.parked_bytes" + label] = \
                    float(st.parked_bytes)
                counters["hub.session.submitted" + label] = st.submitted
                counters["hub.session.delivered" + label] = st.delivered
                counters["hub.session.dispatches" + label] = st.dispatches
        return {"counters": counters, "gauges": gauges}

    def wait_failed(self, timeout: Optional[float] = None):
        """Block until the dispatcher fails or the hub is closed (or
        ``timeout`` passes); the dispatcher's exception, or None."""
        with self._lock:
            self._work.wait_for(
                lambda: self._failed is not None or self._closed, timeout)
            return self._failed

    def close(self) -> None:
        """Stop the dispatcher and release the collector.  On a mesh of
        more than one rank the followers get their stop message (or, if
        the dispatcher failed, the group is torn down) before this
        returns.  Sessions still registered see :class:`HubError` on
        their next call."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            for key in list(self._sessions):
                self._session_state(key).cv.notify_all()
            self._work.notify_all()
            thread = self._thread
        if thread is not None:
            # a mesh dispatcher ends its last turn and then messages the
            # followers; the caller may destroy the group after close(),
            # so wait for it (a stuck collective raises at the group's
            # timeout)
            thread.join(timeout=None if self._has_followers() else 5)
        _REGISTRY.unregister_collector("hub", self._collector_fn)
        if thread is None and self._has_followers():
            # no dispatcher ever ran: no collective of it to race
            from ..parallel import mesh as pmesh

            pmesh.broadcast_stop(self._mesh)

    def __enter__(self) -> "ReplicationHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
