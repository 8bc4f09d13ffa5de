"""lock-order: no two locks may be acquired in both orders.

Motivating contract (ROBUSTNESS.md): the stack runs ~22
threaded modules whose locks compose across files — the fan-out server
takes its own lock and then the broadcast log's (``attach`` / ``ack``
under ``self._lock``); the hub's ``*_locked`` helpers emit events whose
sink has its own two locks; the watermark board registers registry
collectors.  Each pairing is safe ONLY while every thread acquires the
pair in the same order.  A cycle in the acquired-while-held graph is a
deadlock that no seed sweep reliably reproduces (both threads must hit
the window), which is exactly the kind of property a whole-program
pass can prove absent — and the event-loop refactor (ROADMAP item 2)
is only safe to attempt against a certified-acyclic web.

Findings:

* **Inversion** — a cycle ``A -> B -> ... -> A`` in the lock graph;
  the finding cites every edge's acquisition chain (file:line steps
  from the function that takes the first lock to the ``with`` that
  takes the next).
* **Self-re-acquisition** — an ``A -> A`` edge where ``A`` is a plain
  ``threading.Lock``: re-entering a non-reentrant lock is a guaranteed
  single-thread deadlock.  The same edge on an ``RLock`` (or a
  ``Condition`` wrapping one) is a NON-finding by construction —
  re-entry is what RLock is for.

Escapes: the standard ``# datlint: disable=lock-order`` suppression at
the edge's acquisition site (justify next to it).
"""

from __future__ import annotations

from typing import Iterator

from ..engine import Finding, Project
from .model import ProgramIndex

_CHAIN_SEP = " -> "


def _chain_anchor(chain: tuple) -> tuple:
    """(path, line) of a chain's FIRST step — where the outer lock is
    taken; that is the line an auditor looks at first."""
    head = chain[0]
    loc = head.split(" ", 1)[0]
    path, _, line = loc.rpartition(":")
    try:
        return path, int(line)
    except ValueError:
        return loc, 1


class LockOrder:
    name = "lock-order"
    description = (
        "no lock-acquisition cycles: two locks taken in both orders "
        "(or a plain Lock re-acquired while held) deadlock under the "
        "right interleaving"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        index = ProgramIndex.get(project)
        yield from self._self_edges(index)
        yield from self._cycles(index)

    def _self_edges(self, index: ProgramIndex) -> Iterator[Finding]:
        for (a, b), chain in sorted(index.lock_edges.items()):
            if a != b:
                continue
            root = index.locks.get(index.root_lock(a))
            kind = root.kind if root is not None else "lock"
            if kind == "rlock":
                continue  # re-entry is what RLock is for
            if kind == "condition":
                # a Condition with no resolvable wrapped lock: its own
                # internal RLock-like semantics are unknowable here —
                # do not cry deadlock on it
                continue
            rel, line = _chain_anchor(chain)
            path = index.src_path(rel)
            yield Finding(
                path=path, line=line, rule=self.name,
                message=(
                    f"{a} is re-acquired while already held and is a "
                    f"non-reentrant threading.Lock — a guaranteed "
                    f"self-deadlock on this path: "
                    f"{_CHAIN_SEP.join(chain)}"
                ),
                chains=(chain,),
            )

    def _cycles(self, index: ProgramIndex) -> Iterator[Finding]:
        graph: dict[str, list] = {}
        for (a, b) in index.lock_edges:
            if a != b:
                graph.setdefault(a, []).append(b)
        for succs in graph.values():
            succs.sort()
        reported: set = set()
        for start in sorted(graph):
            cycle = self._find_cycle(graph, start)
            if cycle is None:
                continue
            canon = self._canonical(cycle)
            if canon in reported:
                continue
            reported.add(canon)
            chains = tuple(index.lock_edges[(canon[i],
                                             canon[(i + 1) % len(canon)])]
                           for i in range(len(canon)))
            rel, line = _chain_anchor(chains[0])
            path = index.src_path(rel)
            order = " -> ".join(canon + (canon[0],))
            detail = "; ".join(
                f"[{canon[i]} before {canon[(i + 1) % len(canon)]}: "
                f"{_CHAIN_SEP.join(chains[i])}]"
                for i in range(len(canon)))
            yield Finding(
                path=path, line=line, rule=self.name,
                message=(
                    f"lock-order inversion {order}: these locks are "
                    f"acquired in conflicting orders — a deadlock under "
                    f"the right thread interleaving.  Acquisition "
                    f"chains: {detail}"
                ),
                chains=chains,
            )

    @staticmethod
    def _find_cycle(graph: dict, start: str):
        """A simple cycle through ``start`` (DFS, deterministic), or
        None.  Only cycles CONTAINING start are found from start; every
        cycle contains its own lexicographically-smallest node, which
        the sorted outer loop reaches."""
        stack = [(start, iter(graph.get(start, ())))]
        on_path = {start}
        path = [start]
        while stack:
            node, it = stack[-1]
            advanced = False
            for succ in it:
                if succ == start:
                    return tuple(path)
                if succ in on_path or succ not in graph:
                    continue
                on_path.add(succ)
                path.append(succ)
                stack.append((succ, iter(graph.get(succ, ()))))
                advanced = True
                break
            if not advanced:
                stack.pop()
                on_path.discard(path.pop())
        return None

    @staticmethod
    def _canonical(cycle: tuple) -> tuple:
        i = cycle.index(min(cycle))
        return cycle[i:] + cycle[:i]
