"""cursor-coherence: coupled cursors must be written back atomically.

Motivating incident (ADVICE.md, high): the decoder's bulk
dispatch loops advance ``st["row"]`` without advancing ``st["f"]`` when
a change handler raises — on resume, frame payloads pair with the wrong
row's columns (silent corruption), then duplicate deliveries, then
IndexError.  The C loop writes both cursors back unconditionally; the
two pure-Python paths each forgot one half, and no test could catch it
until the exact raise-then-resume schedule was replayed.

The invariant is declarative.  A module states which pieces of state
form one atomic cursor with a comment::

    # datlint: coupled-state st["f"], st["row"]

and the rule enforces, for every function in that module that mutates
any member of a declared set:

* at least one ``try/finally`` in the function writes back EVERY member
  of the set inside the same ``finally`` suite (the atomic write-back
  that makes handler exceptions resumable), and
* no ``finally`` in the function writes back a proper subset of the set
  (the half-write-back that caused the incident).

Functions are separate scopes: nested defs are analyzed independently.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..engine import (
    Finding,
    Project,
    assign_targets,
    canonical,
    walk_function_body,
)

_DECL_RE = re.compile(r"datlint:\s*coupled-state\s+(.+)$")


def _declared_sets(src) -> tuple[list[frozenset[str]],
                                 list[tuple[int, str]]]:
    """Parse coupled-state declarations; a declaration the rule cannot
    honor is itself a finding — silently dropping it would turn the
    rule OFF for the file while datlint still reports clean (the
    treacherous failure mode for a linter guarding silent corruption)."""
    sets: list[frozenset[str]] = []
    bad: list[tuple[int, str]] = []
    for line, comment in src.comments.items():
        m = _DECL_RE.search(comment)
        if not m:
            continue
        members = set()
        ok = True
        for part in m.group(1).split(","):
            part = part.strip()
            if not part:
                continue
            try:
                members.add(canonical(part))
            except SyntaxError:
                ok = False
                bad.append((line, (
                    f"coupled-state declaration has an unparsable member "
                    f"{part!r} — the whole set is ignored and the rule is "
                    f"OFF for this file until the declaration is fixed"
                )))
                break
        if not ok:
            continue
        if len(members) < 2:
            bad.append((line, (
                f"coupled-state declares {len(members)} member(s); a "
                f"coupling needs at least two — declaration ignored, the "
                f"rule is OFF for this file until it is fixed"
            )))
            continue
        sets.append(frozenset(members))
    return sets, bad


def _coupled_writes(node: ast.AST, members: frozenset[str]) -> set[str]:
    """Members of ``members`` assigned anywhere in ``node``'s statements
    (not descending into nested defs)."""
    hit: set[str] = set()
    for child in walk_function_body(node):
        for target in assign_targets(child):
            try:
                c = canonical(target)
            except ValueError:
                continue
            if c in members:
                hit.add(c)
    return hit


class _FinallyCollector(ast.NodeVisitor):
    """Try statements with a finalbody, lexically inside one function."""

    def __init__(self) -> None:
        self.tries: list[ast.Try] = []

    def generic_visit(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            return  # separate scope
        if isinstance(node, ast.Try) and node.finalbody:
            self.tries.append(node)
        super().generic_visit(node)


class CursorCoherence:
    name = "cursor-coherence"
    description = (
        "functions mutating a declared coupled-state set must write back "
        "every member in one finally suite"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            sets, bad = _declared_sets(src)
            for line, message in bad:
                yield Finding(path=str(src.path), line=line,
                              rule=self.name, message=message)
            if not sets:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                yield from self._check_function(src, node, sets)

    def _check_function(self, src, fn: ast.AST,
                        sets: list[frozenset[str]]) -> Iterator[Finding]:
        collector = _FinallyCollector()
        for stmt in fn.body:
            collector.visit(stmt)
        for members in sets:
            touched = _coupled_writes(fn, members)
            if not touched:
                continue
            complete = False
            for t in collector.tries:
                # a finally is one suite: look only at what the
                # finalbody itself writes
                wrapper = ast.Module(body=t.finalbody, type_ignores=[])
                in_finally = _coupled_writes(wrapper, members)
                if not in_finally:
                    continue
                if in_finally == members:
                    complete = True
                else:
                    missing = ", ".join(sorted(members - in_finally))
                    yield Finding(
                        path=str(src.path),
                        line=t.finalbody[0].lineno,
                        rule=self.name,
                        message=(
                            f"finally writes back "
                            f"{', '.join(sorted(in_finally))} but not "
                            f"{missing}: an exception between the coupled "
                            f"mutations desyncs the cursor on resume"
                        ),
                    )
            if not complete:
                yield Finding(
                    path=str(src.path),
                    line=fn.lineno,
                    rule=self.name,
                    message=(
                        f"{fn.name} mutates coupled state "
                        f"{{{', '.join(sorted(members))}}} with no "
                        f"try/finally writing back the full set — a raising "
                        f"handler leaves the members out of step"
                    ),
                )
