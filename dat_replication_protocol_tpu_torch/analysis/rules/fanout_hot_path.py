"""fanout-hot-path: the broadcast write path is O(1) in peers.

Motivating design contract (DESIGN.md fan-out): the fan-out
converts per-peer marginal cost from "full hash + full copy" to
"windowed writev of already-framed bytes" — and that economics only
holds while the *writer section* (``append`` / ``publish`` on the
broadcast log/server) does NO per-peer work.  One careless edit — a
"small" notification loop over peers in ``publish``, a per-peer copy in
``append`` — silently turns every produced byte back into O(peers)
writer cost, the exact regression the fan-out exists to remove.  The
dispatcher is where O(peers) bookkeeping lives; it never touches
payload bytes.

Flagged shapes (Python sources under a ``fanout/`` directory only),
inside any function named ``append`` or ``publish``:

* ANY loop (``for`` / ``while``) or comprehension/generator
  expression: the writer section must be O(1) — a loop is either
  per-peer (forbidden) or per-segment (belongs in the dispatcher/read
  path);
* any attribute or subscript whose dotted name mentions ``peer``,
  ``cursor``, or ``reader`` state (``self._peers``,
  ``peer.notify()``): reaching per-peer state from the writer is the
  per-peer-work smell even without a loop.

Escapes: the standard ``# datlint: disable=fanout-hot-path``
suppression (justify next to it).
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project, dotted_name

_WRITER_SECTION = {"append", "publish"}
_PEER_STATE_MARKERS = ("peer", "cursor", "reader")
_LOOP_NODES = (ast.For, ast.AsyncFor, ast.While, ast.ListComp,
               ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _mentions_peer_state(node: ast.AST) -> str | None:
    """The offending dotted name when ``node`` reaches peer/cursor
    state, else None."""
    if isinstance(node, ast.Attribute):
        name = dotted_name(node)
        probe = name if name is not None else node.attr
        if any(m in probe.lower() for m in _PEER_STATE_MARKERS):
            return probe
    elif isinstance(node, ast.Subscript):
        name = dotted_name(node.value)
        if name is not None and \
                any(m in name.lower() for m in _PEER_STATE_MARKERS):
            return f"{name}[...]"
    elif isinstance(node, ast.Name):
        if any(m in node.id.lower() for m in _PEER_STATE_MARKERS):
            return node.id
    return None


class FanoutHotPath:
    name = "fanout-hot-path"
    description = (
        "in fanout/: the broadcast writer section (append/publish) must "
        "be O(1) in peers — no loops, no reach into per-peer state; "
        "per-peer work belongs in the dispatcher"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            if "fanout" not in src.path.parts[:-1]:
                continue
            tree = src.tree
            if tree is None:
                continue
            for fn in ast.walk(tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name not in _WRITER_SECTION:
                    continue
                yield from self._check_writer(src, fn)

    def _check_writer(self, src, fn) -> Iterator[Finding]:
        for child in ast.iter_child_nodes(fn):
            yield from self._visit(src, fn, child)

    def _visit(self, src, fn, node) -> Iterator[Finding]:
        """Report the OUTERMOST offending node, then stop descending —
        a loop over peers is one finding, not one per statement inside
        it, and ``self._peers.values()`` is one reach, not two."""
        if isinstance(node, _LOOP_NODES):
            yield Finding(
                path=str(src.path),
                line=node.lineno,
                rule=self.name,
                message=(
                    f"loop inside the broadcast writer section "
                    f"{fn.name}(): the write path must be O(1) in "
                    "peers — per-peer (or per-segment) iteration "
                    "belongs in the dispatcher (DESIGN.md fan-out)"
                ),
            )
            return
        offender = _mentions_peer_state(node)
        if offender is not None:
            yield Finding(
                path=str(src.path),
                line=node.lineno,
                rule=self.name,
                message=(
                    f"{offender} reached from the broadcast writer "
                    f"section {fn.name}(): per-peer state is the "
                    "dispatcher's business — the writer must never "
                    "touch it (DESIGN.md fan-out)"
                ),
            )
            return
        for child in ast.iter_child_nodes(node):
            yield from self._visit(src, fn, child)
