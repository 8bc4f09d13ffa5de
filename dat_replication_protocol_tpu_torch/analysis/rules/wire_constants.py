"""wire-constant-parity: one wire format, N implementations, 0 drift.

The frame-type ids, header limits, and proto2 field tags are written
down independently in ``wire/framing.py`` / ``wire/varint.py`` /
``wire/change_codec.py``, in the streaming decoder, and in BOTH C
translation units (``native/dat_native.cpp`` frame splitter + columnar
decoder, ``native/dat_fastpath.cpp`` dispatch loop + C codec).  A
constant edited in one place ships a protocol fork that only manifests
as silent cross-path divergence under a toolchain the editor may not
even have (the exact failure mode the both-dispatch-paths test fixture
exists for, generalized to constants).

Extraction:

* Python — module-level ``NAME = <expr>`` assignments, constant-folded
  (so ``MAX_HEADER_LEN = MAX_VARINT_LEN + 1`` and the shifted proto
  tags resolve to numbers); a leading underscore is stripped when
  matching the watchlist, so ``_TAG_KEY`` and C's ``TAG_KEY`` compare.
* C — regex over the raw text: enum/#define values, literals annotated
  ``1 /* TYPE_CHANGE */`` or ``= 1;  // TYPE_CHANGE``, and explicit
  ``// wire: NAME = N`` markers for limits that appear only as bare
  loop bounds (dat_native.cpp's varint reader).

Only names on the watchlist participate; a name seen in a single file
constrains nothing.  Divergence yields one finding per constant,
anchored at the first site and listing every value observed.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from ..engine import Finding, Project

WATCHLIST = frozenset({
    "TYPE_HEADER", "TYPE_CHANGE", "TYPE_BLOB", "TYPE_CHANGE_BATCH",
    "MAX_VARINT_LEN", "MAX_HEADER_LEN",
    "TAG_SUBSET", "TAG_KEY", "TAG_CHANGE", "TAG_FROM", "TAG_TO",
    "TAG_VALUE",
    # ChangeBatch extension: the frame's payload version byte and the
    # capability bit that gates emitting it (negotiation constants —
    # a fork here is a peer that silently stops understanding itself)
    "BATCH_VERSION", "CAP_CHANGE_BATCH",
    # gear CDC scramble constants: written down independently
    # in ops/rabin.py and in BOTH native scan loops (dat_gear_candidates
    # and the fused dat_cdc_hash).  A fork here is not a wire fork but a
    # ROUTE fork — two "equivalent" CDC engines silently cutting
    # different chunks, the exact divergence the fused1p cross-checks
    # exist to refuse
    "GEAR_C1", "GEAR_C2",
    # rateless reconciliation: the frame type + capability
    # bit + payload version (negotiation constants, same failure class
    # as the ChangeBatch trio), and the splitmix64 mapping constants —
    # written down independently in ops/rateless.py and the native
    # dat_rateless_build engine; a fork maps elements to DIFFERENT
    # coded symbols per engine (the GEAR route-fork class: a sketch
    # that silently never decodes against itself)
    "TYPE_RECONCILE", "CAP_RECONCILE", "RECONCILE_VERSION",
    "RATELESS_GAMMA", "RATELESS_MIX1", "RATELESS_MIX2",
    # snapshot bootstrap: the frame type + capability bit +
    # payload version (negotiation constants, the ChangeBatch/Reconcile
    # failure class), and the weighted-participation constants — the
    # variable-size extension's cell mapping is written down
    # independently in ops/rateless.py and the native
    # dat_rateless_build_w twin (`// wire:` markers); a fork maps
    # chunks to DIFFERENT cells per engine (the GEAR route-fork class:
    # a chunk-set sketch that silently never decodes against itself)
    "TYPE_SNAPSHOT", "CAP_SNAPSHOT", "SNAPSHOT_VERSION",
    "RATELESS_W_SHIFT", "RATELESS_W_CAP",
})

_C_PATTERNS = (
    # enum entry / assignment with a (possibly arithmetic) value; the
    # capture is loose — _safe_eval's charset gate rejects non-arithmetic
    re.compile(r"\b([A-Z][A-Z0-9_]{2,})\s*=\s*([^,;{}]+?)\s*[,;}]"),
    # #define NAME VALUE
    re.compile(r"#define\s+([A-Z][A-Z0-9_]{2,})\s+([0-9][0-9xa-fA-F]*)"),
    # literal annotated with a block comment: 1 /* TYPE_CHANGE */
    re.compile(r"\b([0-9][0-9xa-fA-F]*)\s*/\*\s*([A-Z][A-Z0-9_]{2,})\s*\*/"),
    # assignment annotated with a line comment: = 1;  // TYPE_CHANGE
    re.compile(r"=\s*([0-9][0-9xa-fA-F]*)\s*;?\s*//\s*([A-Z][A-Z0-9_]{2,})"
               r"\s*$"),
    # explicit marker: // wire: NAME = N
    re.compile(r"//\s*wire:\s*([A-Z][A-Z0-9_]{2,})\s*=\s*"
               r"([0-9][0-9xa-fA-F]*)"),
)
# patterns where group 1 is the VALUE and group 2 the NAME
_VALUE_FIRST = {2, 3}

_SAFE_EXPR = re.compile(r"^[0-9xXa-fA-F\s()|<<>>+*-]+$")


def _safe_eval(expr: str) -> int | None:
    expr = expr.strip()
    if not _SAFE_EXPR.match(expr):
        return None
    try:
        v = eval(expr, {"__builtins__": {}}, {})  # noqa: S307 — charset-gated
    except Exception:
        return None
    return v if isinstance(v, int) else None


def _extract_c(src) -> Iterator[tuple[str, int, int]]:
    """(name, value, line) triples from one C source."""
    for lineno, line in enumerate(src.text.splitlines(), start=1):
        for i, pat in enumerate(_C_PATTERNS):
            for m in pat.finditer(line):
                if i in _VALUE_FIRST:
                    raw_value, name = m.group(1), m.group(2)
                else:
                    name, raw_value = m.group(1), m.group(2)
                if name.lstrip("_") not in WATCHLIST:
                    continue
                value = _safe_eval(raw_value)
                if value is not None:
                    yield name.lstrip("_"), value, lineno


class _PyFolder(ast.NodeVisitor):
    """Constant-fold module-level integer assignments."""

    def __init__(self, external: dict[str, int]):
        self.external = external  # watchlist values seen in other modules
        self.local: dict[str, int] = {}
        self.found: list[tuple[str, int, int]] = []

    def fold(self, node: ast.expr) -> int | None:
        if isinstance(node, ast.Constant) and isinstance(node.value, int) \
                and not isinstance(node.value, bool):
            return node.value
        if isinstance(node, ast.Name):
            if node.id in self.local:
                return self.local[node.id]
            return self.external.get(node.id.lstrip("_"))
        if isinstance(node, ast.BinOp):
            left, right = self.fold(node.left), self.fold(node.right)
            if left is None or right is None:
                return None
            try:
                if isinstance(node.op, ast.Add):
                    return left + right
                if isinstance(node.op, ast.Sub):
                    return left - right
                if isinstance(node.op, ast.Mult):
                    return left * right
                if isinstance(node.op, ast.LShift):
                    return left << right
                if isinstance(node.op, ast.RShift):
                    return left >> right
                if isinstance(node.op, ast.BitOr):
                    return left | right
                if isinstance(node.op, ast.BitAnd):
                    return left & right
            except (ValueError, OverflowError):
                return None
        return None

    def scan(self, tree: ast.Module) -> None:
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                    and isinstance(stmt.targets[0], ast.Name):
                name = stmt.targets[0].id
                value = self.fold(stmt.value)
                if value is None:
                    continue
                self.local[name] = value
                if name.lstrip("_") in WATCHLIST:
                    self.found.append((name.lstrip("_"), value, stmt.lineno))


class WireConstantParity:
    name = "wire-constant-parity"
    description = (
        "frame-type ids, header limits, and proto tags must agree "
        "across the Python and C implementations"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        # sites: name -> list of (path, line, value)
        sites: dict[str, list[tuple[str, int, int]]] = {}
        resolved: dict[str, int] = {}
        # two passes so cross-module references (MAX_VARINT_LEN imported
        # into framing.py) fold regardless of scan order
        for _ in range(2):
            sites.clear()
            for src in project.py_sources:
                tree = src.tree
                if tree is None:
                    continue
                folder = _PyFolder(resolved)
                folder.scan(tree)
                for name, value, line in folder.found:
                    sites.setdefault(name, []).append(
                        (str(src.path), line, value))
                    resolved.setdefault(name, value)
            for src in project.c_sources:
                for name, value, line in _extract_c(src):
                    sites.setdefault(name, []).append(
                        (str(src.path), line, value))
        for name in sorted(sites):
            entries = sites[name]
            values = {v for _, _, v in entries}
            if len(values) <= 1:
                continue
            where = "; ".join(f"{p}:{ln}={v}" for p, ln, v in entries)
            path, line, _ = entries[0]
            yield Finding(
                path=path,
                line=line,
                rule=self.name,
                message=(
                    f"wire constant {name} diverges across "
                    f"implementations: {where} — every copy of the wire "
                    f"format must agree"
                ),
            )
