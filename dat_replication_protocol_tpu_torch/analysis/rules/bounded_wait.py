"""bounded-wait: blocking event/condition waits need a bound or a reason.

Motivating incidents: the threaded transport pump's lost-wakeup hang
(transport.recv_over relied on a per-write completion callback a
cross-thread ``done()`` could skip — ADVICE.md's stall family)
and the asyncio sender's bare ``await readable.wait()`` — an encoder
whose producer died without finalizing parked the pump task forever.
The robustness doctrine (ROBUSTNESS.md): every blocking wait either
carries a timeout (re-checking its condition in a loop) or carries an
explicit, audited justification.

Flagged shapes (Python sources only):

* ``x.wait()`` with no arguments — ``threading.Event.wait`` /
  ``Condition.wait`` block forever without a timeout, and
  ``asyncio.Event.wait`` (awaited or not) has no timeout parameter at
  all, so the zero-arg form is reliably unbounded.
* ``x.drain()`` with no arguments — ``asyncio.StreamWriter.drain``
  blocks until the peer reads; a peer that never reads parks the task
  forever.

Escapes:

* any argument or keyword (a timeout was passed);
* the call is wrapped in ``asyncio.wait_for(...)`` (the only way to
  bound the asyncio forms);
* a ``# datlint: allow-unbounded-wait`` comment on the call's line (or
  the comment line above) — the audited-justification escape hatch;
  write the reason next to it.

``x.join()`` is the companion ``unbounded-join`` rule's territory; this
rule deliberately does not double-report it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project

_ALLOW_MARKER = "allow-unbounded-wait"
_WAIT_ATTRS = ("wait", "drain")


def _wait_for_protected(tree: ast.Module) -> set[int]:
    """ids of Call nodes that appear inside an ``asyncio.wait_for(...)``
    (or bare ``wait_for(...)``) argument list — those waits are bounded
    by the wrapper."""
    protected: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name != "wait_for":
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call):
                    protected.add(id(sub))
    return protected


class BoundedWait:
    name = "bounded-wait"
    description = (
        "zero-argument .wait()/.drain() block forever; bound them with "
        "a timeout (or asyncio.wait_for) and re-check in a loop, or "
        "justify with '# datlint: allow-unbounded-wait'"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            protected = _wait_for_protected(tree)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call) or \
                        not isinstance(node.func, ast.Attribute):
                    continue
                if node.func.attr not in _WAIT_ATTRS:
                    continue
                if node.args or node.keywords:
                    continue  # a timeout (or equivalent) was passed
                if id(node) in protected:
                    continue  # bounded by asyncio.wait_for
                if self._allowed(src, node):
                    continue
                yield Finding(
                    path=str(src.path),
                    line=node.lineno,
                    rule=self.name,
                    message=(
                        f".{node.func.attr}() with no timeout can park "
                        "this thread/task forever on a stalled peer or a "
                        "lost wakeup; pass a timeout (or wrap in "
                        "asyncio.wait_for) and re-check the condition in "
                        "a loop, or justify with "
                        "'# datlint: allow-unbounded-wait'"
                    ),
                )

    @staticmethod
    def _allowed(src, node: ast.Call) -> bool:
        """The audited-justification escape: an allow marker in a comment
        on any line the call spans, or on the comment line above."""
        first = node.lineno
        last = getattr(node, "end_lineno", None) or first
        for line in range(first - 1, last + 1):
            if _ALLOW_MARKER in src.comments.get(line, ""):
                return True
        return False
