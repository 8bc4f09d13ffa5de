"""guarded-state: declared fields are only written under their lock.

Motivating incident class: split-brain shared state — a
field that every *documented* path mutates under ``self._lock``, plus
one forgotten path (a late-added close(), a stats probe, a reconnect
handler running on the pump thread) that writes it bare.  No seed
sweep reliably catches the torn interleaving; code reading caught
three of these by hand.  Like cursor-coherence, the invariant is
declarative — state it once, next to the lock that owns it::

    # datlint: guarded-by(self._lock): self._peers, self._retired

and the rule enforces, for every function the whole-program index can
see: a write (assignment, ``del``, or container mutation —
``.append``/``.pop``/``.update``/...) to a declared field counts as
guarded only when the guarding lock is held at the write, either
lexically (an enclosing ``with``) or at function entry on EVERY known
call path (the ``*_locked``-helper idiom, proven through the call
graph — not assumed from the name).

Scope and placement: a declaration inside a ``class`` body covers that
class's ``self.<field>`` members; ``__init__`` is exempt (construction
happens before the object is shared).  A module-level declaration
covers bare module-global names.

The cursor-coherence lesson, inherited verbatim: a declaration this
rule cannot honor — unparsable member, a lock name that resolves to no
known lock, ``self.`` members declared outside any class, a member no
function ever writes (stale/typo'd spelling) — is itself a LOUD
finding.  A linter guarding silent corruption must never silently
disarm.

Escape: the standard ``# datlint: disable=guarded-state`` on the
writing line, next to a written justification (e.g. a single-threaded
teardown that provably happens after every worker joined).
"""

from __future__ import annotations

import re
from typing import Iterator, Optional

from ..engine import Finding, Project, canonical
from .model import FunctionInfo, ModuleInfo, ProgramIndex

_DECL_RE = re.compile(r"datlint:\s*guarded-by\(\s*([^)]*?)\s*\)\s*:\s*(.+)$")


class _Decl:
    def __init__(self, line: int, lock_expr: str, members: tuple,
                 cls: Optional[str], lock_root: Optional[str]):
        self.line = line
        self.lock_expr = lock_expr
        self.members = members        # canonical member expressions
        self.cls = cls                # enclosing class, if any
        self.lock_root = lock_root    # resolved ROOT lock id


class GuardedState:
    name = "guarded-state"
    description = (
        "fields declared '# datlint: guarded-by(lock): fields' are "
        "only written while that lock is held (lexically or at entry "
        "on every known call path); unhonorable declarations are loud"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        index = ProgramIndex.get(project)
        for relpath in sorted(index.modules):
            mod = index.modules[relpath]
            decls, bad = self._declarations(index, mod)
            path = index.src_path(relpath)
            for line, message in bad:
                yield Finding(path=path, line=line, rule=self.name,
                              message=message)
            for decl in decls:
                yield from self._check_decl(index, mod, path, decl)

    # -- declaration parsing -------------------------------------------------

    def _declarations(self, index: ProgramIndex, mod: ModuleInfo
                      ) -> tuple[list, list]:
        decls: list[_Decl] = []
        bad: list[tuple[int, str]] = []
        for line in sorted(mod.src.comments):
            m = _DECL_RE.search(mod.src.comments[line])
            if m is None:
                continue
            lock_expr, member_src = m.group(1), m.group(2)
            cls = self._enclosing_class(mod, line)
            members = []
            ok = True
            for part in member_src.split(","):
                part = part.strip()
                if not part:
                    continue
                try:
                    members.append(canonical(part))
                except SyntaxError:
                    bad.append((line, (
                        f"guarded-by declaration has an unparsable member "
                        f"{part!r} — the whole declaration is ignored and "
                        f"the rule is OFF for these fields until it is "
                        f"fixed")))
                    ok = False
                    break
            if not ok:
                continue
            if not members:
                bad.append((line, (
                    "guarded-by declaration names no fields — declaration "
                    "ignored, the rule is OFF until it is fixed")))
                continue
            selfish = [mm for mm in members if mm.startswith("self.")]
            if selfish and cls is None:
                bad.append((line, (
                    f"guarded-by declares {', '.join(selfish)} outside any "
                    f"class body — 'self.' members need the owning class; "
                    f"declaration ignored until it is moved")))
                continue
            if not lock_expr:
                bad.append((line, (
                    "guarded-by() names no lock — declaration ignored "
                    "until it is fixed")))
                continue
            root = index._resolve_lock_name(lock_expr, mod, cls, ())
            if root is None:
                bad.append((line, (
                    f"guarded-by({lock_expr}) does not resolve to any "
                    f"known threading.Lock/RLock/Condition — declaration "
                    f"ignored (and the rule silently OFF) until the lock "
                    f"name is fixed")))
                continue
            decls.append(_Decl(line, lock_expr, tuple(members), cls, root))
        return decls, bad

    @staticmethod
    def _enclosing_class(mod: ModuleInfo, line: int) -> Optional[str]:
        best = None
        for cinfo in mod.classes.values():
            if cinfo.lineno <= line <= cinfo.end_lineno:
                if best is None or cinfo.lineno > best.lineno:
                    best = cinfo
        return best.name if best is not None else None

    # -- enforcement ---------------------------------------------------------

    def _check_decl(self, index: ProgramIndex, mod: ModuleInfo, path: str,
                    decl: _Decl) -> Iterator[Finding]:
        in_scope = [fn for fn in index.functions.values()
                    if fn.module is mod]
        seen_write = {m: False for m in decl.members}
        for fn in sorted(in_scope, key=lambda f: f.key):
            if decl.cls is not None and fn.cls == decl.cls \
                    and fn.name == f"{decl.cls}.__init__":
                # construction happens-before publication
                for w in self._member_writes(index, fn, decl):
                    seen_write[w[0]] = True
                continue
            for member, write in self._member_writes(index, fn, decl):
                seen_write[member] = True
                if self._guarded(index, fn, write.held, decl.lock_root):
                    continue
                held_roots = sorted({index.root_lock(h) for h in write.held
                                     if not h.startswith("?")})
                under = (f" (holds {', '.join(held_roots)} — not the "
                         f"declared guard)" if held_roots else
                         " with no lock held")
                yield Finding(
                    path=path, line=write.line, rule=self.name,
                    message=(
                        # the declaration site lives in the SECOND
                        # sentence: Finding.key() keeps only the first,
                        # and baseline keys must survive unrelated
                        # edits shifting line numbers
                        f"{fn.name} writes {member} ({write.via}) outside "
                        f"its declared guard {decl.lock_root}{under}.  "
                        f"Declared guarded-by({decl.lock_expr}) at "
                        f"{mod.relpath}:{decl.line}; entry-held on every "
                        f"known call path: "
                        f"{sorted(index.entry_held(fn.key)) or 'nothing'}"
                    ),
                )
        for member in decl.members:
            if not seen_write[member]:
                yield Finding(
                    path=path, line=decl.line, rule=self.name,
                    message=(
                        f"guarded-by declares {member} but no function in "
                        f"{mod.relpath} ever writes it — a stale or "
                        f"typo'd declaration guards nothing (fix the "
                        f"spelling or drop the member)"
                    ),
                )

    def _member_writes(self, index: ProgramIndex, fn: FunctionInfo,
                       decl: _Decl) -> Iterator[tuple]:
        members = set(decl.members)
        if decl.cls is not None and fn.cls != decl.cls:
            # self.X members belong to the declaring class; bare-name
            # members still apply module-wide
            members = {m for m in members if not m.startswith("self.")}
        if not members:
            return
        for write in fn.writes:
            if write.target in members:
                yield write.target, write
        for write in index.mutator_calls(fn):
            if write.target in members:
                yield write.target, write

    @staticmethod
    def _guarded(index: ProgramIndex, fn: FunctionInfo, held: tuple,
                 guard_root: str) -> bool:
        for h in held:
            if not h.startswith("?") and index.root_lock(h) == guard_root:
                return True
        return guard_root in index.entry_held(fn.key)
