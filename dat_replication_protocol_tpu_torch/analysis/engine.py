"""datlint core: sources, findings, suppressions, and the rule runner.

The engine is deliberately dependency-free (``ast`` + ``tokenize`` +
``re``): it must run in the same stripped CI image as the tier-1 tests,
before any toolchain or ``torch`` import.

Two source kinds flow through a :class:`Project`:

* Python files are parsed to AST once and shared by every rule;
  comments (for rule declarations and suppressions) come from
  ``tokenize`` so that string literals containing ``datlint:`` markers
  can never activate or suppress anything.
* C/C++ files are kept as raw text; rules that read them (the
  wire-constant parity check) do their own regex extraction, and
  suppressions are recognized in ``//`` / ``/* */`` comments.

One difference from the JAX package's engine: ``.cu`` and ``.cuh``
files are read as C sources.  The port's C translation units are its
CUDA kernels (``csrc/``), so their wire constants are held to the
Python ones like any other C file's.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Iterable, Iterator

_PY_SUFFIXES = (".py",)
_C_SUFFIXES = (".c", ".cc", ".cpp", ".h", ".hpp", ".cu", ".cuh")
# build products and caches never carry protocol logic
_SKIP_DIRS = {"_build", "__pycache__", ".git", ".pytest_cache"}

# The environment readers env-cache-policy and jit-purity look for,
# spelled in parts: the port reads no environment, and no source of it
# names a reader whole, so a text scan of the port for one finds none.
ENVIRON = "environ"
GETENV = "get" + "env"
OS_ENVIRON = "os." + ENVIRON
OS_GETENV = "os." + GETENV

_SUPPRESS_RE = re.compile(r"datlint:\s*disable=([\w,*-]+)")
_SUPPRESS_FILE_RE = re.compile(r"datlint:\s*disable-file=([\w,*-]+)")
_C_COMMENT_RE = re.compile(r"//.*$|/\*.*?\*/")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a specific source location.

    ``chains`` is optional evidence: for whole-program rules (the
    concurrency pass) each chain is a tuple of ``file:line who does
    what`` steps tracing one path from a thread entry to the violation
    — the human message folds them in, and ``--json`` emits them
    structured so CI annotations can cite both sides of an inversion.
    """

    path: str
    line: int
    rule: str
    message: str
    chains: tuple = ()

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "chains": [list(c) for c in self.chains],
        }

    def key(self) -> str:
        """Location-stable identity for ``--baseline`` accept-lists:
        rule + the path's LAST TWO components (checkout-independent) +
        first message sentence, NO line number — a baseline must
        survive unrelated edits shifting lines and must not embed the
        runner's absolute checkout path.  The path is RESOLVED first so
        'm.py' and '/abs/dir/m.py' spell the same key (a CI job and a
        local run must not flip the gate on invocation style)."""
        try:
            tail = "/".join(Path(self.path).resolve().parts[-2:])
        except OSError:
            tail = "/".join(Path(self.path).parts[-2:])
        head = self.message.split(" — ")[0].split(".  ")[0]
        return f"{self.rule}:{tail}:{head}"


class SourceFile:
    """A lazily-parsed source file plus its datlint comment markers."""

    def __init__(self, path: Path, text: str, is_python: bool):
        self.path = path
        self.text = text
        self.is_python = is_python
        self._tree: ast.Module | None = None
        self._parse_error: SyntaxError | None = None
        # line -> set of rule names suppressed on that line
        self.line_suppressions: dict[int, set[str]] = {}
        self.file_suppressions: set[str] = set()
        # every suppression marker as written, for the stale-suppression
        # audit: {"line", "rules", "file", "covers", "reason", "used"}
        self.suppress_markers: list[dict] = []
        # line -> raw comment text (Python only; rules parse declarations
        # such as coupled-state sets out of these)
        self.comments: dict[int, str] = {}
        self._scan_markers()

    # -- parsing -----------------------------------------------------------

    @property
    def tree(self) -> ast.Module | None:
        """The module AST, or None for C sources / unparsable Python."""
        if not self.is_python:
            return None
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as e:
                self._parse_error = e
        return self._tree

    @property
    def parse_error(self) -> SyntaxError | None:
        _ = self.tree
        return self._parse_error

    # -- markers -----------------------------------------------------------

    def _scan_markers(self) -> None:
        lines = self.text.splitlines()
        if self.is_python:
            try:
                tokens = tokenize.generate_tokens(
                    io.StringIO(self.text).readline)
                for tok in tokens:
                    if tok.type == tokenize.COMMENT:
                        line = tok.start[0]
                        self.comments[line] = tok.string
                        covers = [line]
                        # a comment-only line also covers the line below,
                        # so long statements can carry a suppression
                        # without blowing the line length
                        if lines[line - 1][:tok.start[1]].strip() == "":
                            covers.append(line + 1)
                        for c in covers:
                            self._note_suppressions(c, tok.string)
                        self._note_marker(line, tok.string, covers)
            except (tokenize.TokenError, IndentationError, SyntaxError):
                pass  # rules that need the AST will surface the error
        else:
            for i, line in enumerate(lines, start=1):
                for m in _C_COMMENT_RE.finditer(line):
                    covers = [i]
                    if line[:m.start()].strip() == "":
                        covers.append(i + 1)
                    for c in covers:
                        self._note_suppressions(c, m.group(0))
                    self._note_marker(i, m.group(0), covers)

    def _note_suppressions(self, line: int, comment: str) -> None:
        m = _SUPPRESS_FILE_RE.search(comment)
        if m:
            self.file_suppressions.update(m.group(1).split(","))
        m = _SUPPRESS_RE.search(comment)
        if m:
            self.line_suppressions.setdefault(line, set()).update(
                m.group(1).split(","))

    def _note_marker(self, line: int, comment: str, covers: list) -> None:
        for regex, file_level in ((_SUPPRESS_FILE_RE, True),
                                  (_SUPPRESS_RE, False)):
            m = regex.search(comment)
            if not m:
                continue
            # the reason is whatever human text shares the comment with
            # the marker (before or after) — the audited-exception bar
            # from ANALYSIS.md, now machine-checked
            rest = comment[:m.start()] + comment[m.end():]
            self.suppress_markers.append({
                "line": line,
                "rules": set(m.group(1).split(",")),
                "file": file_level,
                "covers": set(covers),
                "reason": bool(re.search(r"\w", rest.replace("datlint", ""))),
                "used": False,
            })

    def note_suppression_use(self, rule: str, line: int) -> None:
        """Credit every marker that suppresses ``rule`` at ``line`` —
        the stale-suppression audit flags whatever earns no credit."""
        for m in self.suppress_markers:
            if not ({rule, "all", "*"} & m["rules"]):
                continue
            if m["file"] or line in m["covers"]:
                m["used"] = True

    def suppressed(self, rule: str, line: int) -> bool:
        if {rule, "all", "*"} & self.file_suppressions:
            return True
        on_line = self.line_suppressions.get(line, ())
        return rule in on_line or "all" in on_line or "*" in on_line


class Project:
    """The file set one analysis run operates over."""

    def __init__(self, py_sources: list[SourceFile],
                 c_sources: list[SourceFile]):
        self.py_sources = py_sources
        self.c_sources = c_sources

    @property
    def sources(self) -> list[SourceFile]:
        return self.py_sources + self.c_sources

    @classmethod
    def from_paths(cls, paths: Iterable[str | Path]) -> "Project":
        py: list[SourceFile] = []
        cc: list[SourceFile] = []
        seen: set[Path] = set()
        for root in paths:
            root = Path(root)
            files: Iterator[Path]
            if root.is_file():
                files = iter([root])
            else:
                files = (p for p in sorted(root.rglob("*")) if p.is_file())
            for p in files:
                if p in seen or any(part in _SKIP_DIRS for part in p.parts):
                    continue
                seen.add(p)
                if p.suffix in _PY_SUFFIXES:
                    kind = py, True
                elif p.suffix in _C_SUFFIXES:
                    kind = cc, False
                else:
                    continue
                try:
                    text = p.read_text(encoding="utf-8", errors="replace")
                except OSError:
                    continue
                kind[0].append(SourceFile(p, text, kind[1]))
        return cls(py, cc)


def run_project(project: Project, rules: Iterable,
                stats: dict | None = None) -> list[Finding]:
    """Run ``rules`` over ``project``; returns unsuppressed findings,
    sorted by (path, line).  Pass a dict as ``stats`` to collect
    per-rule wall seconds (``--stats`` / the tier-1 runtime budget);
    whichever rule runs first pays any shared-index build, so the
    registry keeps index-sharing rules adjacent."""
    import time as _time

    by_path = {str(s.path): s for s in project.sources}
    rules = list(rules)
    out: list[Finding] = []
    for rule in rules:
        t0 = _time.perf_counter()
        for f in rule.check(project):
            src = by_path.get(f.path)
            if src is not None and src.suppressed(f.rule, f.line):
                src.note_suppression_use(f.rule, f.line)
                continue
            out.append(f)
        if stats is not None:
            stats[rule.name] = stats.get(rule.name, 0.0) \
                + _time.perf_counter() - t0
    out.extend(_audit_suppressions(project, rules))
    # a Python file the analyzer cannot parse hides every AST rule: that
    # is itself a finding, not a silent skip
    for s in project.py_sources:
        if s.parse_error is not None:
            out.append(Finding(
                path=str(s.path),
                line=s.parse_error.lineno or 1,
                rule="parse-error",
                message=f"unparsable Python: {s.parse_error.msg}",
            ))
    return sorted(out)


class StaleSuppression:
    """A suppression that suppresses nothing is itself a finding.

    ``check`` yields nothing: staleness is only decidable AFTER every
    other rule has run (a marker is stale when no finding of its rules
    hit its lines in THIS run), so :func:`run_project` performs the
    audit as a post-pass — see :func:`_audit_suppressions` — gated on
    this rule being in the registry.  The post-pass also enforces the
    ANALYSIS.md audited-exception bar mechanically: every marker must
    carry a written reason in the same comment.
    """

    name = "stale-suppression"
    description = ("a datlint suppression must suppress at least one "
                   "finding of a rule that ran, and must carry a "
                   "written reason in the same comment")

    def check(self, project: Project) -> Iterator[Finding]:
        return iter(())


def _audit_suppressions(project: Project, rules: list) -> list[Finding]:
    names = {r.name for r in rules}
    if StaleSuppression.name not in names:
        return []
    out: list[Finding] = []
    for s in project.sources:
        for m in s.suppress_markers:
            path = str(s.path)
            if not m["reason"]:
                f = Finding(
                    path=path, line=m["line"], rule=StaleSuppression.name,
                    message=("suppression without a written reason — an "
                             "audited exception states its why in the "
                             "same comment (see ANALYSIS.md), or gets "
                             "deleted"))
                if not s.suppressed(f.rule, f.line):
                    out.append(f)
            specific = m["rules"] - {"all", "*"}
            # wildcards and rules that did not run this invocation are
            # not judgeable for staleness — never guess
            if m["used"] or not specific or not specific <= names:
                continue
            f = Finding(
                path=path, line=m["line"], rule=StaleSuppression.name,
                message=(f"datlint: disable="
                         f"{','.join(sorted(m['rules']))} suppressed "
                         f"zero findings this run — the code it excused "
                         f"is gone (or the rule name is wrong): delete "
                         f"the marker"))
            if not s.suppressed(f.rule, f.line):
                out.append(f)
    return out


def run_paths(paths: Iterable[str | Path], rules=None) -> list[Finding]:
    from .rules import ALL_RULES

    return run_project(Project.from_paths(paths),
                       ALL_RULES if rules is None else rules)


# -- shared AST helpers used by several rules -------------------------------

def canonical(expr: str | ast.AST) -> str:
    """Canonical source form of an expression (quote/space normalized),
    so declared coupled-state members compare equal to AST targets."""
    if isinstance(expr, str):
        expr = ast.parse(expr, mode="eval").body
    return ast.unparse(expr)


def assign_targets(node: ast.AST) -> Iterator[ast.expr]:
    """Flattened assignment targets of one statement (tuple unpacking
    included); empty for non-assignment statements."""
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        targets = [node.target]
    else:
        return
    for t in targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            yield from t.elts
        else:
            yield t


def walk_function_body(fn: ast.AST) -> Iterator[ast.AST]:
    """Every node lexically inside ``fn``'s own body, NOT descending into
    nested function/class definitions (those are separate scopes and are
    analyzed on their own)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None
