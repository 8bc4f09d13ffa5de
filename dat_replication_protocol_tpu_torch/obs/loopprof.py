"""The event loop's flight deck: per-turn phase accounting, loop-lag
watermarks, and a sampling turn profiler for the edge loop.

The port's copy of ``dat_replication_protocol_tpu/obs/loopprof.py``;
stdlib only.  It measures what each turn of
:class:`~..edge.loop.EdgeLoop` spent, turn by turn and phase by phase,
and exports the one number that tells an operator whether the loop is
keeping up: **loop lag**.

Every mutating call below is made from the loop's own thread; readers
(``/healthz``, the registry collector) take plain attribute reads that
are at worst one turn stale, the contract of
:meth:`EdgeLoop.admission_state`.

* **Phase accounting**: each lit turn is split into the loop's six
  phases (:data:`PHASES`): poll-wait, accept, read, hub-drain, tx and
  the overload ladder (rejection, shed and teardown work).  Per-phase
  seconds feed fixed-bucket histograms (``edge.turn.*_s``) and
  change-only ``edge.turn`` spans in the span ring, so a loop turn
  renders as one box in the Chrome trace export.  Idle turns (the
  selector timed out and nothing happened) coalesce into the NEXT
  active span, so consecutive recorded spans tile the loop's wall time
  exactly: ``span[i+1].ts == span[i].ts + span[i].dur``.
* **Loop lag**: a turn's lag is its non-poll work beyond one tick of
  grace, ``max(0.0, work_s - tick)``.  The selector's timeout is the
  loop's sanctioned wait, so a healthy turn clamps to exactly ``0.0``
  while a stalled turn reads its overrun.  The live view extrapolates
  mid-turn, and ``oldest_ready_s`` ages the readiness batch the loop is
  still working through.  Exported through
  :class:`~.watermarks.WatermarkBoard` as ``edge.loop.lag{loop=}``
  gauges and the ``loops`` snapshot section.
* **Turn profiler**: every ``sample_every``-th active turn, and every
  turn whose lag is positive, captures the top-K heaviest sessions by
  callback seconds and bytes moved, keyed by the session keys; the
  capture rides the span's ``top`` field.

The dark path is one attribute load: the dispatcher forks on ``OBS.on``
once a turn and the dark twin never touches this module.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from .metrics import OBS as _OBS, counter as _counter, \
    histogram as _histogram
from .tracing import SPANS as _SPANS, _span_ids

__all__ = ["LoopProfiler", "PHASES", "SAMPLE_EVERY", "TOP_K"]

# the loop's phase vocabulary: string literals at every accounting call
PHASES = ("poll-wait", "accept", "read", "hub-drain", "tx",
          "overload-ladder")

# one active turn in 32 carries a top-K capture; overrun turns always do
SAMPLE_EVERY = 32
TOP_K = 3

# per-loop work ring for the loop-local p99
_WORK_RING = 512

# a loop is "behind its tick" for /healthz once its live lag exceeds
# half a tick beyond the one-tick grace already inside the lag formula
# (in all, more than 1.5 ticks of non-poll work): a single 1 ms overrun
# does not flap the probe
_BEHIND_FRACTION = 0.5

_H_POLL = _histogram("edge.turn.poll_wait_s")
_H_ACCEPT = _histogram("edge.turn.accept_s")
_H_READ = _histogram("edge.turn.read_s")
_H_HUB = _histogram("edge.turn.hub_drain_s")
_H_TX = _histogram("edge.turn.tx_s")
_H_OVERLOAD = _histogram("edge.turn.overload_ladder_s")
_H_WORK = _histogram("edge.turn.work_s")
_M_TURNS = _counter("edge.loop.turns")

_PHASE_HIST = {
    "accept": _H_ACCEPT,
    "read": _H_READ,
    "hub-drain": _H_HUB,
    "tx": _H_TX,
    "overload-ladder": _H_OVERLOAD,
}


def _quantile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class LoopProfiler:
    """One per :class:`~..edge.loop.EdgeLoop`; every mutator runs on the
    loop thread (one writer, lock-free readers).

    Turn protocol, called by the lit dispatcher::

        prof.turn_begin(t0)          # before select()
        prof.poll_done(t1, nready)   # select() returned
        prof.phase("accept", dt)     # phase work of no session
        prof.account("read", key, dt, nbytes)  # one session's work
        prof.turn_done(t2, sessions=len(table))
    """

    def __init__(self, name: str, *, tick: float,
                 sample_every: int = SAMPLE_EVERY,
                 top_k: int = TOP_K) -> None:
        self.name = name
        self.tick = float(tick)
        self.sample_every = max(1, int(sample_every))
        self.top_k = max(1, int(top_k))
        # the lock-free reader surface (plain attributes, one turn stale)
        self.turns = 0
        self.active_turns = 0
        self.lag_s = 0.0
        self.lag_max_s = 0.0
        self.in_work = False
        self.running = False
        # the turn in progress (loop thread only)
        self._t0 = 0.0            # turn start (before select)
        self._work_t0 = 0.0       # select returned; work begins
        self._poll_s = 0.0
        self._ready_since: Optional[float] = None
        self._phases: dict[str, float] = {}
        self._sessions: dict[str, list] = {}
        # change-only span tiling
        self._anchor: Optional[float] = None
        self._idle_turns = 0
        self._idle_poll_s = 0.0
        self._work_ring: deque = deque(maxlen=_WORK_RING)

    # -- registration --------------------------------------------------------

    def attach(self) -> None:
        """Register this loop on the watermark board (serve start)."""
        from .watermarks import WATERMARKS
        self.running = True
        WATERMARKS.track_loop(self.name, self.export)

    def detach(self, now: Optional[float] = None) -> None:
        """Flush the trailing idle span and leave the board (loop
        shutdown).  Idempotent."""
        from .watermarks import WATERMARKS
        self.running = False
        self.flush(time.monotonic() if now is None else now)
        WATERMARKS.untrack_loop(self.name)

    # -- the turn protocol (loop thread only) --------------------------------

    def turn_begin(self, t0: float) -> None:
        self._t0 = t0
        if self._anchor is None:
            self._anchor = t0

    def poll_done(self, t_poll: float, nready: int) -> None:
        self._poll_s = max(0.0, t_poll - self._t0)
        self._work_t0 = t_poll
        self._ready_since = t_poll if nready else None
        self.in_work = True

    def phase(self, name: str, seconds: float) -> None:
        """Add phase work of no one session to this turn; ``name`` is a
        :data:`PHASES` literal at the call site."""
        self._phases[name] = self._phases.get(name, 0.0) + seconds

    def account(self, name: str, session: str, seconds: float,
                nbytes: int) -> None:
        """Add phase work of one session (the top-K source); ``name`` is
        a :data:`PHASES` literal, ``session`` the table's session key."""
        self._phases[name] = self._phases.get(name, 0.0) + seconds
        ent = self._sessions.get(session)
        if ent is None:
            ent = self._sessions[session] = [0.0, 0, {}]
        ent[0] += seconds
        ent[1] += int(nbytes)
        ent[2][name] = ent[2].get(name, 0.0) + seconds

    def turn_done(self, t_end: float, sessions: int = 0) -> None:
        """Close the turn: histograms, lag, the change-only span."""
        self.turns += 1
        _M_TURNS.inc()
        phases = self._phases
        poll_s = self._poll_s
        work_s = max(0.0, t_end - self._work_t0)
        lag = max(0.0, work_s - self.tick)
        self.lag_s = lag
        if lag > self.lag_max_s:
            self.lag_max_s = lag
        self.in_work = False
        self._ready_since = None
        _H_POLL.observe(poll_s)
        _H_WORK.observe(work_s)
        for name, sec in phases.items():
            h = _PHASE_HIST.get(name)
            if h is not None and sec > 0.0:
                h.observe(sec)
        active = lag > 0.0 or bool(phases) or bool(self._sessions)
        if not active:
            # an idle turn coalesces into the NEXT active span, so the
            # recorded spans still tile wall time exactly
            self._idle_turns += 1
            self._idle_poll_s += poll_s
            return
        self.active_turns += 1
        self._work_ring.append(work_s)
        fields = {
            "loop": self.name,
            "tick": self.tick,
            "turns": self._idle_turns + 1,
            "sessions": sessions,
            "poll_wait_s": round(self._idle_poll_s + poll_s, 9),
            "work_s": round(work_s, 9),
            "lag_s": round(lag, 9),
        }
        for name in PHASES[1:]:
            fields[name.replace("-", "_") + "_s"] = round(
                phases.get(name, 0.0), 9)
        if lag > 0.0 or self.active_turns % self.sample_every == 0:
            fields["top"] = self._top()
        anchor = self._anchor if self._anchor is not None else self._t0
        _SPANS.record("edge.turn", anchor, t_end - anchor,
                      next(_span_ids), None, threading.get_ident(),
                      fields)
        self._anchor = t_end
        self._idle_turns = 0
        self._idle_poll_s = 0.0
        self._phases = {}
        self._sessions = {}

    def flush(self, now: float) -> None:
        """Record the trailing idle span (shutdown): coverage runs to the
        loop's last turn even when it ended quiet."""
        if self._anchor is None or not self._idle_turns:
            return
        _SPANS.record("edge.turn", self._anchor,
                      max(0.0, now - self._anchor), next(_span_ids),
                      None, threading.get_ident(),
                      {"loop": self.name, "tick": self.tick,
                       "turns": self._idle_turns, "sessions": 0,
                       "poll_wait_s": round(self._idle_poll_s, 9),
                       "work_s": 0.0, "lag_s": 0.0})
        self._anchor = now
        self._idle_turns = 0
        self._idle_poll_s = 0.0

    def _top(self) -> list:
        ranked = sorted(self._sessions.items(),
                        key=lambda kv: (kv[1][0], kv[1][1]),
                        reverse=True)[:self.top_k]
        out = []
        for key, (sec, nbytes, by_phase) in ranked:
            phase = max(by_phase.items(), key=lambda kv: kv[1])[0] \
                if by_phase else "read"
            out.append({"session": key, "seconds": round(sec, 9),
                        "bytes": nbytes, "phase": phase})
        return out

    # -- the reader surface --------------------------------------------------

    def live_lag(self, now: Optional[float] = None) -> float:
        """Current lag, extrapolated mid-turn: a probe during a stall
        sees the overrun growing.  Lock-free (any thread)."""
        lag = self.lag_s
        if self.in_work:
            t = time.monotonic() if now is None else now
            lag = max(lag, (t - self._work_t0) - self.tick)
        return max(0.0, lag)

    def oldest_ready_s(self, now: Optional[float] = None) -> float:
        """Age of the oldest ready session the loop has not finished
        dispatching this turn (0.0 between turns)."""
        since = self._ready_since
        if since is None or not self.in_work:
            return 0.0
        t = time.monotonic() if now is None else now
        return max(0.0, t - since)

    def p99_work_s(self) -> float:
        return _quantile(sorted(self._work_ring), 0.99)

    def export(self) -> dict:
        """The watermark board's record (the ``loops`` snapshot section
        and the ``edge.loop.*`` gauges).  ``state: dark`` marks a loop
        whose gate is off, so a reader does not take its zeros for a
        loop that keeps up."""
        now = time.monotonic()
        live = self.live_lag(now)
        return {
            "state": "live" if _OBS.on else "dark",
            "tick": self.tick,
            "turns": self.turns,
            "active_turns": self.active_turns,
            "lag_s": round(live, 9),
            "lag_max_s": round(self.lag_max_s, 9),
            "oldest_ready_s": round(self.oldest_ready_s(now), 9),
            "behind": live > _BEHIND_FRACTION * self.tick,
        }

    def state(self) -> dict:
        """The loop-local summary for ``EdgeLoop.snapshot()``: a p99 of
        this loop's own turns, apart from the process-global histogram."""
        return {
            "name": self.name,
            "turns": self.turns,
            "active_turns": self.active_turns,
            "lag_s": round(self.lag_s, 9),
            "lag_max_s": round(self.lag_max_s, 9),
            "p99_work_s": round(self.p99_work_s(), 9),
            "tick": self.tick,
        }
