"""structured-error-parity: cluster-layer errors carry the full
structured context or they do not ship.

Motivating incident: the gossip mesh's whole failure
contract rests on errors that NAME things — which peer diverged, at
which wire offset, in which frame.  ``ProtocolError`` set the precedent
(frame/offset/cause folded into ``str()``), ``SessionShed``/``PeerShed``
added the actor key; a cluster-layer error type that drops any of
those fields degrades a byzantine post-mortem to "something failed
somewhere", and nothing at runtime notices — the error still raises,
the test still sees an exception, only the attribution is gone.

For every exception class defined in a module under a ``cluster/``
directory (a class whose base name ends in ``Error``, ``Exception``,
``Fault``, or is a known structured base like ``SnapshotNeeded``):

1. it must define ``__init__`` (inheriting one silently inherits the
   base's field set, which is exactly how a field goes missing);
2. ``__init__`` must take a ``peer`` parameter AND assign
   ``self.peer`` (the actor: who diverged / who is refused);
3. ``offset`` and ``frame`` must each be wired: either an ``__init__``
   parameter (passed through to a structured base's ``super().__init__``)
   or an explicit ``self.<field>`` assignment.

Escapes: the standard ``# datlint: disable=structured-error-parity``
on the class line, next to a written justification.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project

_EXC_SUFFIXES = ("Error", "Exception", "Fault")
_EXC_BASES = {"SnapshotNeeded", "ByzantineDivergence", "PeerQuarantined",
              "TransportFault"}
_REQUIRED = ("peer", "offset", "frame")


def _is_exception_class(node: ast.ClassDef) -> bool:
    for base in node.bases:
        name = base.id if isinstance(base, ast.Name) else (
            base.attr if isinstance(base, ast.Attribute) else None)
        if name is None:
            continue
        if name in _EXC_BASES or name.endswith(_EXC_SUFFIXES):
            return True
    return False


def _init_of(node: ast.ClassDef):
    for stmt in node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name == "__init__":
            return stmt
    return None


def _param_names(fn) -> set:
    args = fn.args
    names = {a.arg for a in args.args} | {a.arg for a in args.kwonlyargs}
    names |= {a.arg for a in args.posonlyargs}
    return names


def _self_assigned(fn) -> set:
    out: set = set()
    for sub in ast.walk(fn):
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, ast.AnnAssign):
            targets = [sub.target]
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Attribute) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == "self":
                out.add(t.attr)
    return out


class StructuredErrorParity:
    name = "structured-error-parity"
    description = (
        "cluster-layer error types carry peer/offset/frame like "
        "ProtocolError and the shed errors do"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            parts = src.path.parts
            if "cluster" not in parts[:-1]:
                continue
            tree = src.tree
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.ClassDef) \
                        or not _is_exception_class(node):
                    continue
                init = _init_of(node)
                if init is None:
                    yield Finding(
                        path=str(src.path), line=node.lineno,
                        rule=self.name,
                        message=(
                            f"error class {node.name} defines no "
                            f"__init__: the structured field set "
                            f"(peer/offset/frame) is inherited blind — "
                            f"declare it so the contract is visible "
                            f"and checkable"
                        ),
                    )
                    continue
                params = _param_names(init)
                assigned = _self_assigned(init)
                missing = []
                if "peer" not in params or "peer" not in assigned:
                    missing.append(
                        "peer (parameter + self.peer assignment)")
                for field in ("offset", "frame"):
                    if field not in params and field not in assigned:
                        missing.append(
                            f"{field} (parameter passed to a structured "
                            f"base or an explicit self.{field})")
                if missing:
                    yield Finding(
                        path=str(src.path), line=node.lineno,
                        rule=self.name,
                        message=(
                            f"error class {node.name} is missing "
                            f"structured context: {'; '.join(missing)} — "
                            f"cluster errors carry frame/offset/peer "
                            f"like ProtocolError and the shed errors do"
                        ),
                    )
