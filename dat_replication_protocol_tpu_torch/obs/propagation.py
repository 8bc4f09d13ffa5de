"""Mesh convergence plane: gossip-exchange provenance and divergence
watermarks.

A trimmed copy of ``dat_replication_protocol_tpu/obs/propagation.py``;
stdlib only.  One record shape, one board:

* every :func:`~..cluster.node.gossip_exchange` (both directions, live
  and simulated) calls :func:`record_exchange`, which records ONE
  ``gossip.exchange`` span: peer, round, role (``initiator`` /
  ``responder``), decoded diff size, wire bytes, wall seconds, outcome
  (:data:`OUTCOMES`) and the delivered digest prefixes an offline tool
  rebuilds the propagation tree from;
* the process-global :data:`PROPAGATION` board keeps per-(replica, peer)
  divergence watermarks (the diff the exchange's own peel measured, in
  records and in repair wire bytes) and exports them as labeled gauges
  (``cluster.divergence{replica=,peer=}``,
  ``cluster.divergence_bytes{replica=,peer=}``) through
  :meth:`~.metrics.Registry.register_collector`, beside a
  ``cluster.frontier{replica=}`` gauge: a 52-bit equality fingerprint of
  the content digest (two replicas are converged iff their gauges are
  equal; the magnitude means nothing);
* :meth:`PropagationBoard.snapshot` is the ``propagation`` section of
  the sidecar's ``--stats-fd`` and ``/snapshot`` records.

Nothing here runs unless ``OBS.on``: the exchange engine forks to a dark
twin that names no symbol of this module, so the disabled cost of the
plane is one attribute load.

Events: ``gossip.mesh`` (one per mesh start: ``n``, ``seed``, ``bound``),
``gossip.hold`` (a replica acquired records outside an exchange:
``replica``, ``round``, ``digests``), ``gossip.frontier`` (change-only:
a replica's content digest moved: ``replica``, ``round``, ``digest``,
``records``).  The names are the reference's, so its offline tools read
the port's logs.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Optional

from .events import emit as _emit
from .metrics import OBS as _OBS
from .metrics import REGISTRY as _REGISTRY
from .tracing import SPANS as _SPANS
from .tracing import _span_ids

__all__ = [
    "PROPAGATION",
    "PropagationBoard",
    "record_exchange",
    "note_hold",
    "note_mesh",
    "note_frontier",
    "digest_prefixes",
    "frontier_fingerprint",
    "OUTCOMES",
]

# converged (the peel found an empty diff), progress (the diff moved),
# transport (retryable, no state changed), corruption (a structured
# protocol failure: suspicion accrues), refused (a quarantine refusal)
OUTCOMES = ("converged", "progress", "transport", "corruption",
            "refused")

# hex chars of a canonical digest carried by hold and exchange records:
# 64 of its 256 bits, enough to tell records apart in any real mesh
_DIGEST_HEX = 16

# recent exchange wall-seconds kept for the p50/p99 export (owned by the
# board, not a registry histogram, so reset_for_tests drops it too)
_SECONDS_RING = 512


def digest_prefixes(digests) -> list:
    """Canonical digest rows (the ``(n, 32)`` uint8 array of a
    :class:`~..runtime.reconcile_driver.RatelessReplica`) as the hex16
    prefixes provenance records carry."""
    return [bytes(d).hex()[:_DIGEST_HEX] for d in digests]


def frontier_fingerprint(digest_hex: str) -> float:
    """The ``cluster.frontier`` gauge value: the content digest's first
    52 bits as a float (exact in IEEE-754; compared, never ordered)."""
    return float(int(digest_hex[:13] or "0", 16))


class PropagationBoard:
    """Process-global per-link exchange provenance and divergence
    watermarks (see the module docstring); the instance is
    :data:`PROPAGATION`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # datlint: guarded-by(self._lock): self._links, self._frontier, self._seconds
        # (replica, peer) -> the last exchange of that directed pair
        self._links: dict[tuple, dict] = {}
        # replica -> its last frontier (content digest and count)
        self._frontier: dict[str, dict] = {}
        self._seconds: deque = deque(maxlen=_SECONDS_RING)
        self._collector_fn = self._collect

    # -- recording -----------------------------------------------------------

    def record(self, replica: str, peer: str, *, role: str, rnd: int,
               outcome: str, seconds: float, diff: Optional[int] = None,
               wire_bytes: int = 0, repair_bytes: int = 0,
               error: Optional[str] = None) -> None:
        """Fold one exchange (one direction's view) into the board.
        ``diff`` is the peel result, known only on a completed exchange;
        a failed exchange keeps the pair's previous watermark (the
        divergence did not heal, and a fabricated 0 would read as
        converged)."""
        now = time.monotonic()
        with self._lock:
            rec = self._links.setdefault((replica, peer), {
                "role": role, "round": 0, "outcome": None,
                "divergence_records": None, "divergence_bytes": None,
                "wire_bytes": 0, "seconds": 0.0, "exchanges": 0,
                "failures": 0, "error": None, "_mono": now,
                "_ok_mono": None,
            })
            rec["role"] = role
            rec["round"] = int(rnd)
            rec["outcome"] = outcome
            rec["seconds"] = float(seconds)
            rec["wire_bytes"] = int(wire_bytes)
            rec["error"] = error
            rec["exchanges"] += 1
            rec["_mono"] = now
            if outcome in ("converged", "progress"):
                rec["_ok_mono"] = now
                rec["divergence_records"] = int(diff or 0)
                rec["divergence_bytes"] = int(repair_bytes)
            else:
                rec["failures"] += 1
            if outcome != "refused":
                self._seconds.append(float(seconds))
        _REGISTRY.register_collector("propagation", self._collector_fn)

    def note_frontier(self, replica: str, digest_hex: str,
                      records: int, rnd: int) -> bool:
        """Change-only frontier tracking: True when the replica's content
        digest moved (the caller emits ``gossip.frontier`` only then)."""
        with self._lock:
            prev = self._frontier.get(replica)
            if prev is not None and prev["digest"] == digest_hex:
                return False
            self._frontier[replica] = {"digest": digest_hex,
                                       "records": int(records),
                                       "round": int(rnd)}
        _REGISTRY.register_collector("propagation", self._collector_fn)
        return True

    # -- export --------------------------------------------------------------

    def exchange_p99(self) -> Optional[float]:
        """p99 exchange wall seconds over the recent window (None before
        the first exchange that was not refused)."""
        return self._quantile(0.99)

    def _quantile(self, q: float) -> Optional[float]:
        with self._lock:
            window = sorted(self._seconds)
        if not window:
            return None
        rank = min(len(window) - 1,
                   max(0, math.ceil(q * len(window)) - 1))
        return window[rank]

    def snapshot(self) -> dict:
        """The ``propagation`` section of a sidecar stats record
        (JSON-able): each directed link's last exchange with ages on
        this process's monotonic clock, each replica's frontier, and the
        exchange-seconds quantiles."""
        now = time.monotonic()
        with self._lock:
            links = {f"{r}->{p}": dict(rec)
                     for (r, p), rec in self._links.items()}
            frontier = {k: dict(v) for k, v in self._frontier.items()}
            count = len(self._seconds)
        for rec in links.values():
            rec["age_s"] = round(now - rec.pop("_mono"), 6)
            ok = rec.pop("_ok_mono")
            rec["last_success_age_s"] = (round(now - ok, 6)
                                         if ok is not None else None)
        return {
            "monotonic": now,
            "links": links,
            "frontier": frontier,
            "exchange_seconds": {
                "count": count,
                "p50": self._quantile(0.50),
                "p99": self._quantile(0.99),
            },
        }

    def _collect(self) -> dict:
        """Registry collector: the divergence watermarks as labeled
        gauges (one a live directed pair) and the frontier
        fingerprints."""
        gauges: dict = {}
        with self._lock:
            links = [(k, dict(v)) for k, v in self._links.items()]
            frontier = list(self._frontier.items())
        for (replica, peer), rec in links:
            if rec["divergence_records"] is None:
                continue  # no completed peel yet: unknown, not zero
            gauges[f"cluster.divergence{{replica={replica},peer={peer}}}"] \
                = float(rec["divergence_records"])
            gauges["cluster.divergence_bytes"
                   f"{{replica={replica},peer={peer}}}"] = float(
                rec["divergence_bytes"])
        for replica, rec in frontier:
            gauges[f"cluster.frontier{{replica={replica}}}"] = \
                frontier_fingerprint(rec["digest"])
        return {"gauges": gauges}

    def reset_for_tests(self) -> None:
        """Drop every link, frontier and the seconds window."""
        with self._lock:
            self._links.clear()
            self._frontier.clear()
            self._seconds.clear()


PROPAGATION = PropagationBoard()


# -- the instrumentation surface (callers hold the OBS.on gate) --------------


def record_exchange(replica: str, peer: str, *, role: str, rnd: int,
                    outcome: str, seconds: float,
                    diff: Optional[int] = None, wire_bytes: int = 0,
                    repair_bytes: int = 0, delivered=(),
                    delivered_peer=(), t0: Optional[float] = None,
                    error: Optional[str] = None) -> None:
    """One direction's view of one gossip exchange: the board's
    watermarks and the ``gossip.exchange`` span.

    ``delivered`` are the digest prefixes THIS replica absorbed,
    ``delivered_peer`` the ones it shipped to ``peer``.  ``t0`` is the
    exchange's start on this process's monotonic clock (default: now
    minus ``seconds``).  Callers gate with ``if _OBS.on:``."""
    PROPAGATION.record(replica, peer, role=role, rnd=rnd,
                       outcome=outcome, seconds=seconds, diff=diff,
                       wire_bytes=wire_bytes, repair_bytes=repair_bytes,
                       error=error)
    start = t0 if t0 is not None else time.monotonic() - seconds
    fields = {
        "replica": replica, "peer": peer, "role": role, "round": int(rnd),
        "outcome": outcome, "wire_bytes": int(wire_bytes),
        "repair_bytes": int(repair_bytes),
        "seconds": round(float(seconds), 6),
    }
    if diff is not None:
        fields["diff"] = int(diff)
    if delivered:
        fields["delivered"] = list(delivered)
    if delivered_peer:
        fields["delivered_peer"] = list(delivered_peer)
    if error is not None:
        fields["error"] = error
    _SPANS.record("gossip.exchange", start, float(seconds),
                  next(_span_ids), None, threading.get_ident(), fields)


def note_hold(replica: str, digests, rnd: int = 0) -> None:
    """A replica acquired ``digests`` (hex16 prefixes) outside any
    exchange: initial state, a snapshot bootstrap, a broadcast-feed
    drain."""
    _emit("gossip.hold", replica=replica, round=int(rnd),
          digests=list(digests))


def note_mesh(n: int, seed: int, bound: int) -> None:
    """One mesh start: replica count, seed and the round budget that
    convergence is judged against."""
    _emit("gossip.mesh", n=int(n), seed=int(seed), bound=int(bound))


def note_frontier(replica: str, digest_hex: str, records: int,
                  rnd: int) -> bool:
    """Change-only ``gossip.frontier`` event, board state and the
    ``cluster.frontier`` gauge.  True when the frontier moved."""
    if PROPAGATION.note_frontier(replica, digest_hex, records, rnd):
        _emit("gossip.frontier", replica=replica, round=int(rnd),
              digest=digest_hex, records=int(records))
        return True
    return False


# the gate, re-exported so tests can read it through this module
OBS = _OBS
