"""Whole-program concurrency analysis.

datlint's original rules are single-file AST passes; the bug classes
code reading kept catching by hand — callback-under-lock in a
dispatcher, a blocking write inside a held region, shared state written
from a thread that skipped the lock — are *cross-file* properties of
the thread web.  This package is the whole-program infrastructure that
checks them mechanically before the event-loop refactor (ROADMAP
item 2) rebuilds that web:

* :mod:`.model` builds ONE shared :class:`~.model.ProgramIndex` per
  analysis run: every ``threading.Lock/RLock/Condition`` creation site
  gets a stable identity (``hub/engine.py::ReplicationHub._lock``),
  ``with lock:`` regions are resolved against those identities
  (conditions alias the lock they wrap, local aliases like
  ``lock = self._ack_lock`` follow), and an interprocedural call graph
  propagates held-lock sets through direct calls — so a helper only
  ever called under the hub lock is *known* to run locked.
* :mod:`.lockorder` reports lock-order inversions (cycles in the
  acquired-while-held graph) with both acquisition chains cited, and
  re-acquisition of a non-reentrant lock (RLock re-entry is a
  non-finding by construction).
* :mod:`.blocking` reports blocking calls — socket send/recv,
  ``os.write``/``writev``, ``time.sleep``, ``subprocess``, file I/O,
  and user-callback invocation — made while any lock is held, directly
  or through the call graph, with the holding chain cited.  Escape:
  ``# datlint: allow-blocking-under-lock`` (optionally class-scoped,
  ``allow-blocking-under-lock(file-io)``) next to a written
  justification.
* :mod:`.guarded` enforces ``# datlint: guarded-by(lock): fields``
  declarations (the coupled-state declaration syntax, extended):
  writes to a declared field outside its guarding lock — lexically or
  via the entry-held call-graph closure — are findings, and a
  declaration the rule cannot honor is itself a LOUD finding (the
  cursor-coherence lesson: a linter guarding silent corruption must
  never silently disarm).

* :mod:`.readiness` lifts the same index one level up: an
  interprocedural may-block summary pass (``nonblocking`` /
  ``bounded-blocking`` / ``unbounded-blocking``) feeding two enforced
  rules — :class:`~.readiness.BlockingReachability` (no unbounded
  blocking reachable from a certified dispatch loop) and
  :class:`~.readiness.CallbackEscape` (no user callback on a
  dispatcher thread) — plus the per-entry-point certificate
  ``artifacts/torch/event_loop_surface.json``.

The machine-readable lock-acquisition graph is exported as
``artifacts/torch/lock_graph.json``, and the event-loop readiness
certificate as ``artifacts/torch/event_loop_surface.json`` (both via
``python -m dat_replication_protocol_tpu_torch.analysis --write-artifacts
DIR``) so the item-2 refactor can diff the thread web it inherits.
Rules and incidents: ANALYSIS.md "Concurrency rules".
"""

from __future__ import annotations

from .blocking import BlockingUnderLock
from .guarded import GuardedState
from .lockorder import LockOrder
from .model import ProgramIndex, render_lock_graph
from .readiness import BlockingReachability, CallbackEscape, \
    ReadinessIndex, render_event_loop_surface

__all__ = [
    "BlockingReachability",
    "BlockingUnderLock",
    "CallbackEscape",
    "GuardedState",
    "LockOrder",
    "ProgramIndex",
    "ReadinessIndex",
    "render_event_loop_surface",
    "render_lock_graph",
]
