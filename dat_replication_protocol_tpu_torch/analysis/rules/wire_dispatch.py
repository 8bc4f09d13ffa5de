"""wire-dispatch-parity: a frame type is wired EVERYWHERE or nowhere.

Motivating incident: landing TYPE_SNAPSHOT
meant touching four dispatch surfaces by hand — the streaming header
scanner, the bulk frame-index dispatch, the ``_frames_delivered``
checkpoint arithmetic, and the tracing ``kind=`` vocabulary — and a
careful read of the diff was the only thing standing between frame 5
and shipping half-wired (parsed on one path, miscounted on the other;
checkpoints and structured errors silently disagreeing about frame
indices).
wire-constant-parity keeps the *values* in sync across languages; this
rule keeps the *dispatch matrix* filled in across surfaces, so frame 6
cannot ship half-wired.

For every ``TYPE_*`` constant the framing module (the module defining
``KNOWN_TYPES``) lists in ``KNOWN_TYPES``:

1. **streaming scanner** — the constant is referenced in a function
   named ``_scan_header`` (the byte-at-a-time header dispatch);
2. **bulk-index dispatch** — referenced in ``_run_indexed`` (the
   native frame-index fast path must know every type the streaming
   path knows, or the two paths diverge on the same wire);
3. **accounting** — ``_frames_delivered`` (the single frame-index
   authority for checkpoints and structured errors) mentions a counter
   named after the frame kind (``changes``, ``blobs``,
   ``reconcile_frames``, ``_batch_frames_done``, ...);
4. **tracing** — the scanner's module emits a ``kind="<kind>"``
   literal for it (the causal-tracing vocabulary, obs/tracing.py),
   where ``<kind>`` is the constant name lowercased sans ``TYPE_``.

A ``TYPE_*`` constant defined but missing from ``KNOWN_TYPES``, and a
framing module with no reachable scanner/bulk/accounting surface at
all, are LOUD findings — the matrix check must never silently disarm
because a refactor renamed its anchors (the cursor-coherence lesson).

Escapes: the standard ``# datlint: disable=wire-dispatch-parity`` on
the constant's definition line, next to a written justification (e.g.
a type that is deliberately scanner-only during a migration window).

One difference from the JAX package's rule: the bulk-index surface is
checked only where the project defines ``_run_indexed``.  The port's
decoder has no native frame-index route yet, so there is no second
dispatch to hold to the scanner; a missing scanner or accounting
anchor stays a loud finding.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project

_SCANNER = "_scan_header"
_BULK = "_run_indexed"
_ACCOUNTING = "_frames_delivered"


def _module_types(tree: ast.Module) -> tuple[dict, list, int]:
    """(TYPE_* name -> line, KNOWN_TYPES member names, KNOWN_TYPES line)
    for one module; ([], -1) when the module defines no KNOWN_TYPES."""
    types: dict[str, int] = {}
    known: list[str] = []
    known_line = -1
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1 \
                or not isinstance(stmt.targets[0], ast.Name):
            continue
        name = stmt.targets[0].id
        if name.startswith("TYPE_") and isinstance(stmt.value, ast.Constant):
            types[name] = stmt.lineno
        elif name == "KNOWN_TYPES" and isinstance(stmt.value,
                                                  (ast.Tuple, ast.List)):
            known_line = stmt.lineno
            for elt in stmt.value.elts:
                if isinstance(elt, ast.Name):
                    known.append(elt.id)
    return types, known, known_line


def _names_in_function(tree: ast.Module, fn_name: str) -> set | None:
    """Every Name/attribute identifier inside the first function named
    ``fn_name``, or None when no such function exists."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == fn_name:
            out: set = set()
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    out.add(sub.id)
                elif isinstance(sub, ast.Attribute):
                    out.add(sub.attr)
            return out
    return None


def _kind_literals(tree: ast.Module) -> set:
    """String values passed as ``kind=`` keywords anywhere in a module."""
    out: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant) \
                        and isinstance(kw.value.value, str):
                    out.add(kw.value.value)
    return out


class WireDispatchParity:
    name = "wire-dispatch-parity"
    description = (
        "every KNOWN_TYPES frame type is wired into the streaming "
        "scanner, the bulk-index dispatch, _frames_delivered "
        "accounting, and the tracing kind= vocabulary"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        framing = None  # (src, types, known, known_line)
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            types, known, known_line = _module_types(tree)
            if known_line >= 0 and types:
                framing = (src, types, known, known_line)
                break
        if framing is None:
            return  # no wire layer in this project: nothing to certify
        src, types, known, known_line = framing

        # surfaces, wherever they live in the project
        scanner = bulk = accounting = None
        kinds: set = set()
        for other in project.py_sources:
            tree = other.tree
            if tree is None:
                continue
            s = _names_in_function(tree, _SCANNER)
            if s is not None and scanner is None:
                scanner = (other, s)
                kinds = _kind_literals(tree)
            b = _names_in_function(tree, _BULK)
            if b is not None and bulk is None:
                bulk = (other, b)
            a = _names_in_function(tree, _ACCOUNTING)
            if a is not None and accounting is None:
                accounting = (other, a)

        for surface, fn_name in ((scanner, _SCANNER),
                                 (accounting, _ACCOUNTING)):
            if surface is None:
                yield Finding(
                    path=str(src.path), line=known_line, rule=self.name,
                    message=(
                        f"no function named {fn_name} anywhere in the "
                        f"analyzed project: the dispatch-parity matrix "
                        f"lost its anchor and certifies nothing — "
                        f"re-point the rule at the renamed surface"
                    ),
                )
        if scanner is None or accounting is None:
            return

        for tname, line in sorted(types.items(), key=lambda kv: kv[1]):
            if tname == "TYPE_HEADER":
                continue  # parser state, never a wire frame id
            if tname not in known:
                yield Finding(
                    path=str(src.path), line=line, rule=self.name,
                    message=(
                        f"{tname} is defined but not listed in "
                        f"KNOWN_TYPES — a frame type outside the registry "
                        f"dodges every parity surface"
                    ),
                )
                continue
            kind = tname[len("TYPE_"):].lower()
            token = kind.rsplit("_", 1)[-1]
            missing = []
            if tname not in scanner[1]:
                missing.append(f"streaming scanner ({_SCANNER})")
            if bulk is not None and tname not in bulk[1]:
                missing.append(f"bulk-index dispatch ({_BULK})")
            if not any(kind in n or token in n for n in accounting[1]):
                missing.append(
                    f"{_ACCOUNTING} accounting (no counter mentioning "
                    f"'{kind}' or '{token}')")
            if kind not in kinds:
                missing.append(
                    f'tracing vocabulary (no kind="{kind}" literal in '
                    f'the scanner module)')
            if missing:
                yield Finding(
                    path=str(src.path), line=line, rule=self.name,
                    message=(
                        f"{tname} is half-wired: missing from "
                        f"{'; '.join(missing)} — every frame type is "
                        f"wired into all four dispatch surfaces or none"
                    ),
                )
