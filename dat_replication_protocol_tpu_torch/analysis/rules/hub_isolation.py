"""hub-isolation: the shared engine's two structural invariants.

Motivating design contract (ROBUSTNESS.md overload behavior):
the hub multiplexes every session onto ONE device pipeline, so two
whole-class failure modes live one careless edit away:

1. **A lock held across a device dispatch.**  The hub lock serializes
   per-session accounting; a device call (pipeline dispatch/flush, a
   ``hash_begin``/``collect`` closure, a ``device_put``) can block for
   milliseconds to seconds.  Holding the lock across one turns every
   co-resident session's submit into a convoy behind the device — the
   exact cross-session stall the hub exists to exclude.  The dispatcher
   composes batches UNDER the lock and dispatches OUTSIDE it; this rule
   keeps that shape honest.

2. **Per-session state reached around the session-keyed accessor.**
   Session state is keyed by session; every key-addressed reach into
   the table must go through the accessor (``_session_state``) so there
   is exactly one place where "which session?" is answered (and where a
   future generation/tombstone check would live).  A raw
   ``self._sessions[key]`` scattered through the engine is how a shed
   or closed session's state gets resurrected by a stale key.

Flagged shapes (Python sources under a ``hub/`` directory only):

* inside any ``with`` statement whose context expression's dotted name
  contains ``lock`` (``self._lock``, ``hub._lock``): a call whose
  receiver's dotted name contains ``pipeline``, or whose attribute name
  is one of the device-dispatch set (``dispatch``, ``flush``,
  ``hash_begin``, ``hash_batch``, ``collect``, ``start_d2h``,
  ``device_put``, ``block_until_ready``, ``synchronize``);
* a subscript on an attribute named ``_sessions`` (read, write, or
  delete) in any function OTHER than the accessor itself or the
  registration pair (``_session_state``, ``register``, ``_unregister``).

Escapes: the standard ``# datlint: disable=hub-isolation`` suppression
(justify next to it).

One difference from the JAX package's rule: ``synchronize`` joins the
device-dispatch set.  ``torch.cuda.synchronize()`` and
``Event.synchronize()`` wait on the card as ``block_until_ready`` does.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project, dotted_name

_DISPATCH_ATTRS = {
    "dispatch", "flush", "hash_begin", "hash_batch", "collect",
    "start_d2h", "device_put", "block_until_ready", "synchronize",
}
_ACCESSOR_METHODS = {"_session_state", "register", "_unregister"}


def _is_lock_ctx(item: ast.withitem) -> bool:
    name = dotted_name(item.context_expr)
    if name is None and isinstance(item.context_expr, ast.Call):
        name = dotted_name(item.context_expr.func)
    return name is not None and "lock" in name.lower()


def _dispatchy_call(node: ast.Call) -> str | None:
    """The offending call's rendered name when it looks like a device
    dispatch, else None."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        recv = dotted_name(fn.value)
        if recv is not None and "pipeline" in recv.lower():
            return f"{recv}.{fn.attr}"
        if fn.attr.lstrip("_") in _DISPATCH_ATTRS:
            full = dotted_name(fn)
            return full or fn.attr
    elif isinstance(fn, ast.Name) and fn.id.lstrip("_") in _DISPATCH_ATTRS:
        return fn.id
    return None


class HubIsolation:
    name = "hub-isolation"
    description = (
        "in hub/: no device dispatch (pipeline call, hash_begin/collect, "
        "device_put) may run while a lock is held, and _sessions[...] is "
        "only touched inside the session-keyed accessor"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            if "hub" not in src.path.parts[:-1]:
                continue
            tree = src.tree
            if tree is None:
                continue
            yield from self._check_lock_spans(src, tree)
            yield from self._check_accessor(src, tree)

    def _check_lock_spans(self, src, tree: ast.Module) -> Iterator[Finding]:
        for node in ast.walk(tree):
            if not isinstance(node, ast.With) or \
                    not any(_is_lock_ctx(i) for i in node.items):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                offender = _dispatchy_call(sub)
                if offender is None:
                    continue
                yield Finding(
                    path=str(src.path),
                    line=sub.lineno,
                    rule=self.name,
                    message=(
                        f"{offender}(...) inside a with-lock block: a "
                        "device dispatch under the hub lock convoys "
                        "every co-resident session behind the device — "
                        "compose under the lock, dispatch outside it "
                        "(ROBUSTNESS.md overload behavior)"
                    ),
                )

    def _check_accessor(self, src, tree: ast.Module) -> Iterator[Finding]:
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name in _ACCESSOR_METHODS:
                continue
            for sub in ast.iter_child_nodes(fn):
                yield from self._subscripts_in(src, fn, sub)

    def _subscripts_in(self, src, fn, node) -> Iterator[Finding]:
        # don't descend into nested defs: they are checked on their own
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return
        if isinstance(node, ast.Subscript) and \
                isinstance(node.value, ast.Attribute) and \
                node.value.attr == "_sessions":
            yield Finding(
                path=str(src.path),
                line=node.lineno,
                rule=self.name,
                message=(
                    f"_sessions[...] reached directly in {fn.name}(): "
                    "per-session state must go through the session-keyed "
                    "accessor (_session_state) so stale keys cannot "
                    "resurrect shed/closed sessions"
                ),
            )
        for child in ast.iter_child_nodes(node):
            yield from self._subscripts_in(src, fn, child)
