"""The shared whole-program index the concurrency rules run over.

One :class:`ProgramIndex` is built per analysis run (memoized on the
:class:`~..engine.Project`) and shared by every concurrency rule — the
single-file rules parse each file once via the engine; this layer does
the same for the *cross-file* facts:

* **Lock identities.**  Every ``threading.Lock()`` / ``RLock()`` /
  ``Condition()`` creation site becomes a :class:`LockDef` with a
  stable id: ``<relpath>::<Class>.<attr>`` for instance locks,
  ``<relpath>::<name>`` for module-level locks,
  ``<relpath>::<func>.<name>`` for function-local locks.  A
  ``Condition(existing_lock)`` *aliases* the lock it wraps — acquiring
  the condition IS acquiring that lock, so both resolve to one root
  identity.
* **Regions.**  ``with <expr>:`` items are resolved against the lock
  table (``self._lock`` through the enclosing class, bare names through
  enclosing-function locals and module globals, local aliases like
  ``lock = self._ack_lock``, and — when all else fails — a unique
  attribute-name match across the whole program).  ``.acquire()`` /
  ``.release()`` pairs are NOT modeled; the codebase convention is
  ``with`` (the one non-with user, ``transport.once``, is a
  non-blocking try-acquire).
* **Call graph.**  Direct calls resolve through: same-module functions,
  ``from x import y`` (relative imports resolved against the project
  file tree), ``self.method`` (single-inheritance method lookup within
  the project), module-level singletons (``EVENTS = EventLog()`` makes
  ``EVENTS.emit`` resolvable, also across modules), and instance
  attributes whose constructor is visible in ``__init__``
  (``self.log = BroadcastLog(...)`` makes ``self.log.append``
  resolvable).  Unresolvable calls simply contribute no edges — the
  index is a best-effort under-approximation, documented in
  ANALYSIS.md.
* **Held-lock propagation.**  A deterministic DFS from every function
  (entry held-set empty — any function may be a thread entry point)
  carries the held set through regions and call edges, recording (a)
  ``acquired-while-held`` lock edges with one representative
  acquisition chain each, and (b) for every *blocking* call site, the
  chain by which a lock is held around it.
* **Entry-held closure.**  A greatest-fixpoint over the call graph
  computes, per function, the set of locks held at entry on EVERY
  known call path (functions with no known callers hold nothing) —
  what lets ``guarded-by`` accept a ``*_locked`` helper's writes
  without a lexical ``with``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import posixpath
import re
from typing import Iterator, Optional

from ..engine import Project, SourceFile, dotted_name

LOCK_FACTORIES = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}

# with-item names that look like locks even when unresolvable; an
# unresolved lock-like region still counts as "a lock is held" for the
# blocking rule (conservative) but never enters the ordering graph
_LOCKISH = re.compile(r"(?:^|[._])(?:[a-z_]*lock|mutex|guard|cv|cond)\w*$",
                      re.IGNORECASE)

# -- blocking-call classification (the documented set, ANALYSIS.md) ---------

# dotted-prefix classes
_BLOCKING_DOTTED = {
    "time.sleep": "sleep",
    "select.select": "socket",
    "select.poll": "socket",
    "socket.create_connection": "socket",
}
_OS_IO = {"write", "writev", "read", "readv", "pread", "pwrite",
          "sendfile", "fsync", "fdatasync"}
# attribute names that are socket operations on ANY receiver
_SOCKET_ATTRS = {"sendall", "sendmsg", "sendto", "recvfrom", "recv_into",
                 "recvfrom_into", "recvmsg", "accept", "connect"}
# send/recv are socket ops only when the receiver's name says so
# (generators have .send; queues and pipes have their own vocabulary)
_SOCKET_RECV_HINTS = ("sock", "conn", "peer", "client", "chan", "srv")
# file-object I/O needs a file-ish receiver (write()/read() are too
# generic to flag on arbitrary objects)
_FILE_ATTRS = {"write", "read", "readline", "readinto", "flush"}
_FILE_RECV_HINTS = ("file", "sink", "fh", "fp", "stream")
# attribute names that ARE user callbacks wherever they are invoked
_CALLBACK_ATTR = re.compile(r"^on_|_cb$|_callback$|_hook$|^(callback|sink|hook)$")
# bare names that are user callbacks when they do not resolve to a
# known function (parameters and loop-unpacked locals qualify with ANY
# name; otherwise the name itself must look like a callback)
_CALLBACK_NAME = re.compile(
    r"^on_|_cb$|_callback$|_hook$|^(cb|callback|handler|hook|sink|done)$")

_ALLOW_MARKER = re.compile(r"allow-blocking-under-lock(?:\(([\w,*-]+)\))?")

# container-mutator method names that count as WRITES to the receiver
# for guarded-by (rebinding is caught via assignment targets; in-place
# mutation of a guarded dict/list/deque/set goes through these)
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
}


@dataclasses.dataclass
class LockDef:
    id: str
    kind: str             # lock | rlock | condition
    path: str             # project-relative posix path
    line: int
    alias_of: Optional[str] = None  # Condition(wrapped_lock)

    @property
    def attr(self) -> str:
        return self.id.rsplit(".", 1)[-1].rsplit("::", 1)[-1]


@dataclasses.dataclass
class Region:
    lock: Optional[str]   # resolved ROOT lock id; None = lock-like, unknown
    line: int
    rendered: str         # source form of the with-item
    outer: tuple = ()     # lock ids lexically held around this region


@dataclasses.dataclass
class CallSite:
    line: int
    callee: Optional[str]  # resolved function key, or None
    rendered: str
    held: tuple            # lock ids lexically held at the site
    allowed: bool = False  # allow-blocking-under-lock on the call line:
    # the LEXICALLY held locks are accepted around this entire call
    # subtree (locks held further up the chain are NOT excused)


@dataclasses.dataclass
class BlockingSite:
    line: int
    cls: str               # sleep | socket | os-io | subprocess | file-io | callback
    rendered: str
    held: tuple            # lexically held at the site
    allowed: bool          # an allow-blocking-under-lock marker covers it


@dataclasses.dataclass
class Write:
    line: int
    target: str            # canonical written expression (or receiver)
    via: str               # "assign" | "del" | "mutator:<name>"
    held: tuple            # lexically held at the write


@dataclasses.dataclass
class FunctionInfo:
    key: str               # "<relpath>::<Qual>"  (Qual = Class.meth | func)
    module: "ModuleInfo"
    node: ast.AST
    cls: Optional[str]     # enclosing class name, if any
    params: tuple
    regions: list = dataclasses.field(default_factory=list)
    calls: list = dataclasses.field(default_factory=list)
    blocking: list = dataclasses.field(default_factory=list)
    writes: list = dataclasses.field(default_factory=list)
    mutator_writes: list = dataclasses.field(default_factory=list)

    @property
    def name(self) -> str:
        return self.key.split("::", 1)[1]


@dataclasses.dataclass
class ClassInfo:
    name: str
    bases: tuple           # base-class NAMES as written (resolved lazily)
    lineno: int
    end_lineno: int
    methods: dict = dataclasses.field(default_factory=dict)  # name -> fn key
    attr_types: dict = dataclasses.field(default_factory=dict)  # attr -> class key


@dataclasses.dataclass
class ModuleInfo:
    relpath: str
    src: SourceFile
    imports: dict = dataclasses.field(default_factory=dict)   # alias -> (mod, name)
    module_aliases: dict = dataclasses.field(default_factory=dict)  # alias -> mod
    functions: dict = dataclasses.field(default_factory=dict)  # qual -> FunctionInfo
    classes: dict = dataclasses.field(default_factory=dict)    # name -> ClassInfo
    singletons: dict = dataclasses.field(default_factory=dict)  # name -> class key


def _common_root(paths: list) -> str:
    if not paths:
        return ""
    if len(paths) == 1:
        return os.path.dirname(os.path.abspath(str(paths[0])))
    return os.path.commonpath([os.path.abspath(str(p)) for p in paths])


class ProgramIndex:
    """See module docstring.  Build once per project via :meth:`get`."""

    @classmethod
    def get(cls, project: Project) -> "ProgramIndex":
        idx = getattr(project, "_concurrency_index", None)
        if idx is None:
            idx = cls(project)
            project._concurrency_index = idx
        return idx

    def __init__(self, project: Project):
        self.project = project
        self.root = _common_root([s.path for s in project.py_sources])
        self.modules: dict[str, ModuleInfo] = {}
        self.locks: dict[str, LockDef] = {}
        self.functions: dict[str, FunctionInfo] = {}
        # (from_root_id, to_root_id) -> chain (tuple of step strings)
        self.lock_edges: dict[tuple, tuple] = {}
        # blocking-site id -> (site, fn, chain) first found with a lock held
        self.blocked: dict[tuple, tuple] = {}
        self._scan_modules()
        self._scan_locks()
        self._resolve_condition_aliases()
        self._scan_functions()
        self._traverse()
        self._entry_held = self._fixpoint_entry_held()

    # -- paths ---------------------------------------------------------------

    def relpath(self, src: SourceFile) -> str:
        p = os.path.abspath(str(src.path))
        try:
            rel = os.path.relpath(p, self.root)
        except ValueError:
            rel = str(src.path)
        return rel.replace(os.sep, "/")

    def src_path(self, relpath: str) -> str:
        """The engine-side path (``str(SourceFile.path)``) for a
        project-relative path — findings must carry THAT form so the
        engine's suppression lookup and every other rule's rendering
        agree."""
        mod = self.modules.get(relpath)
        return str(mod.src.path) if mod is not None else relpath

    # -- pass 1: module shells, imports, classes, locks ----------------------

    def _scan_modules(self) -> None:
        for src in self.project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            mod = ModuleInfo(self.relpath(src), src)
            self.modules[mod.relpath] = mod
            self._scan_imports(mod, tree)
            for stmt in tree.body:
                if isinstance(stmt, ast.ClassDef):
                    mod.classes[stmt.name] = ClassInfo(
                        stmt.name,
                        tuple(b for b in map(dotted_name, stmt.bases) if b),
                        stmt.lineno,
                        getattr(stmt, "end_lineno", stmt.lineno) or stmt.lineno,
                    )
            # module-level locks and singletons
            for stmt in tree.body:
                self._note_lock_assign(mod, stmt, cls=None, func=None)
                if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
                        and isinstance(stmt.targets[0], ast.Name) \
                        and isinstance(stmt.value, ast.Call):
                    cname = dotted_name(stmt.value.func)
                    if cname and cname not in ("threading.Lock",
                                               "threading.RLock",
                                               "threading.Condition"):
                        mod.singletons[stmt.targets[0].id] = (mod.relpath,
                                                              cname)

    def _scan_imports(self, mod: ModuleInfo, tree: ast.Module) -> None:
        parts = mod.relpath.split("/")[:-1]  # package dirs of this module
        for stmt in ast.walk(tree):
            if isinstance(stmt, ast.ImportFrom):
                base = list(parts)
                if stmt.level:
                    base = parts[:len(parts) - (stmt.level - 1)] \
                        if stmt.level <= len(parts) + 1 else None
                    if base is None:
                        continue
                else:
                    base = []
                modpath = (stmt.module or "").split(".") if stmt.module else []
                # absolute imports may spell the package root's own name
                if not stmt.level and modpath:
                    rootname = posixpath.basename(
                        self.root.replace(os.sep, "/"))
                    if modpath[0] == rootname:
                        modpath = modpath[1:]
                target = "/".join(base + modpath)
                for alias in stmt.names:
                    name = alias.name
                    asname = alias.asname or name
                    # "from pkg import module" vs "from module import name"
                    as_mod = self._module_file(target + "/" + name)
                    if as_mod is not None:
                        mod.module_aliases[asname] = as_mod
                    else:
                        f = self._module_file(target)
                        if f is not None:
                            mod.imports[asname] = (f, name)
            elif isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    f = self._module_file(alias.name.replace(".", "/"))
                    if f is not None:
                        mod.module_aliases[alias.asname or alias.name] = f

    def _module_file(self, stem: str) -> Optional[str]:
        if not stem:
            return None
        for cand in (stem + ".py", stem + "/__init__.py"):
            if cand in self.modules:
                return cand
        # pass-1 ordering: the module map is still filling; fall back to
        # the project file set
        for src in self.project.py_sources:
            rel = self.relpath(src)
            if rel == stem + ".py" or rel == stem + "/__init__.py":
                return rel
        return None

    # -- lock discovery ------------------------------------------------------

    def _lock_factory(self, value: ast.AST) -> Optional[tuple]:
        """(kind, ctor_node) when ``value`` is a lock construction."""
        if not isinstance(value, ast.Call):
            return None
        name = dotted_name(value.func)
        if name is None:
            return None
        last = name.rsplit(".", 1)[-1]
        if last in LOCK_FACTORIES and (
                "." not in name or name.startswith("threading.")
                or name.startswith("_threading.")):
            return LOCK_FACTORIES[last], value
        return None

    def _note_lock_assign(self, mod: ModuleInfo, stmt: ast.AST,
                          cls: Optional[str], func: Optional[str]) -> None:
        if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
            return
        fact = self._lock_factory(stmt.value)
        if fact is None:
            return
        kind, ctor = fact
        target = stmt.targets[0]
        tname = dotted_name(target)
        if tname is None:
            return
        if tname.startswith("self.") and cls is not None:
            lock_id = f"{mod.relpath}::{cls}.{tname[5:]}"
        elif "." not in tname and func is not None:
            lock_id = f"{mod.relpath}::{func}.{tname}"
        elif "." not in tname and cls is None:
            lock_id = f"{mod.relpath}::{tname}"
        else:
            return
        alias = None
        if kind == "condition" and ctor.args:
            # resolved in pass 1.5, once every lock is known; remember
            # the wrapped expression for now
            alias = ("pending", mod.relpath, cls,
                     dotted_name(ctor.args[0]))
        self.locks[lock_id] = LockDef(lock_id, kind, mod.relpath,
                                      stmt.lineno, alias)

    def _scan_locks(self) -> None:
        """Pass 1.5: find EVERY lock construction — module-level ones
        were noted in pass 1; this walk adds instance locks
        (``self._lock = threading.Lock()`` in any method, ``__init__``
        or otherwise) and function-local locks, with the enclosing
        class/function recorded so regions resolve against the right
        identity.  A separate pass so that a region in module A can
        name a lock constructed in module B regardless of scan order."""
        for mod in self.modules.values():
            tree = mod.src.tree
            if tree is None:
                continue
            self._scan_locks_in(mod, tree.body, cls=None, func_chain=())

    def _scan_locks_in(self, mod: ModuleInfo, body, cls, func_chain) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef):
                # only top-level classes carry lock identities (nested
                # classes are out of the call graph's reach anyway)
                if cls is None and not func_chain:
                    self._scan_locks_in(mod, stmt.body, stmt.name, ())
                continue
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_locks_in(mod, stmt.body, cls,
                                    func_chain + (stmt.name,))
                continue
            if func_chain:  # inside a function: note with its qualname
                fname = ".".join(func_chain) if cls is None \
                    else f"{cls}.{'.'.join(func_chain)}"
                self._note_lock_assign(mod, stmt, cls=cls, func=fname)
            handler_bodies = [h.body for h in
                              getattr(stmt, "handlers", [])]
            for sub_body in (getattr(stmt, "body", []),
                             getattr(stmt, "orelse", []),
                             getattr(stmt, "finalbody", []),
                             *handler_bodies):
                if sub_body:
                    self._scan_locks_in(mod, sub_body, cls, func_chain)

    def _resolve_condition_aliases(self) -> None:
        for lock in self.locks.values():
            alias = lock.alias_of
            if not isinstance(alias, tuple):
                continue
            _, relpath, cls, expr = alias
            lock.alias_of = None
            if expr is None:
                continue
            mod = self.modules[relpath]
            # NO unique-attr fallback here: a mis-aliased condition
            # corrupts every ordering fact about the lock it wraps
            resolved = self._resolve_lock_name(expr, mod, cls, (),
                                               fallback=False)
            if resolved is None and cls is not None and "." not in expr:
                # ``Condition(lock)`` wrapping a constructor parameter
                # (the hub/fanout per-session state idiom): resolve
                # through the class's construction sites — when every
                # site passes the SAME lock, the alias is that lock
                resolved = self._alias_via_ctor_sites(mod, cls, expr)
            if resolved is not None and resolved != lock.id:
                lock.alias_of = resolved

    def _alias_via_ctor_sites(self, mod: ModuleInfo, cls: str,
                              param: str) -> Optional[str]:
        tree = mod.src.tree
        init = None
        for node in tree.body:
            if isinstance(node, ast.ClassDef) and node.name == cls:
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)) \
                            and sub.name == "__init__":
                        init = sub
                        break
        if init is None:
            return None
        names = [a.arg for a in init.args.args]  # self first
        if param not in names:
            return None
        pos = names.index(param) - 1  # positional index at call sites
        roots: set = set()
        for caller_mod in self.modules.values():
            ctree = caller_mod.src.tree
            if ctree is None:
                continue
            for call, ctx_cls, ctx_chain in self._calls_with_context(ctree):
                cname = dotted_name(call.func)
                if cname is None or \
                        self._resolve_class(caller_mod, cname) != \
                        (mod.relpath, cls):
                    continue
                arg = None
                if 0 <= pos < len(call.args):
                    arg = dotted_name(call.args[pos])
                for kw in call.keywords:
                    if kw.arg == param:
                        arg = dotted_name(kw.value)
                if arg is None:
                    return None  # an unresolvable site poisons the alias
                r = self._resolve_lock_name(arg, caller_mod, ctx_cls,
                                            ctx_chain, fallback=False)
                if r is None:
                    return None
                roots.add(r)
        if len(roots) == 1:
            return next(iter(roots))
        return None

    @staticmethod
    def _calls_with_context(tree: ast.Module) -> Iterator[tuple]:
        """(Call node, enclosing top-level class or None, enclosing
        function-name chain) for every call in a module."""
        def walk(node, cls, chain):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    if cls is None and not chain:
                        yield from walk(child, child.name, ())
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    yield from walk(child, cls, chain + (child.name,))
                    continue
                if isinstance(child, ast.Call):
                    yield child, cls, chain
                yield from walk(child, cls, chain)

        yield from walk(tree, None, ())

    def root_lock(self, lock_id: str) -> str:
        seen = set()
        while lock_id in self.locks and \
                self.locks[lock_id].alias_of is not None and \
                lock_id not in seen:
            seen.add(lock_id)
            lock_id = self.locks[lock_id].alias_of
        return lock_id

    def _resolve_lock_name(self, expr: Optional[str], mod: ModuleInfo,
                           cls: Optional[str], func_chain: tuple,
                           local_aliases: Optional[dict] = None,
                           fallback: bool = True) -> Optional[str]:
        """Resolve a dotted lock expression to a ROOT lock id, or None."""
        if not expr:
            return None
        if local_aliases and expr in local_aliases:
            expr = local_aliases[expr]
            if not expr:
                return None
        head, _, rest = expr.partition(".")
        if head in ("self", "cls") and cls is not None and rest:
            cand = f"{mod.relpath}::{cls}.{rest}"
            if cand in self.locks:
                return self.root_lock(cand)
        if "." not in expr:
            # innermost enclosing scope first; method-local locks are
            # registered class-qualified ("Cls.meth.name")
            for i in range(len(func_chain), 0, -1):
                q = ".".join(func_chain[:i])
                for qual in ((f"{cls}.{q}", q) if cls is not None else (q,)):
                    cand = f"{mod.relpath}::{qual}.{expr}"
                    if cand in self.locks:
                        return self.root_lock(cand)
            cand = f"{mod.relpath}::{expr}"
            if cand in self.locks:
                return self.root_lock(cand)
            if head in mod.imports:
                imod, iname = mod.imports[head]
                cand = f"{imod}::{iname}"
                if cand in self.locks:
                    return self.root_lock(cand)
        if not fallback:
            return None
        # last resort: a unique attribute-name match program-wide
        attr = expr.rsplit(".", 1)[-1]
        matches = sorted(lid for lid, ld in self.locks.items()
                         if ld.attr == attr)
        if len(matches) == 1:
            return self.root_lock(matches[0])
        if matches and cls is not None:
            own = [m for m in matches
                   if m.startswith(f"{mod.relpath}::{cls}.")]
            if len(own) == 1:
                return self.root_lock(own[0])
        return None

    # -- pass 2: functions (regions, calls, blocking sites, writes) ----------

    def _scan_functions(self) -> None:
        # registration FIRST, body walks SECOND: a call site resolves
        # against the complete function/method table, not just the
        # names that happened to be defined earlier in scan order
        pending: list[tuple[FunctionInfo, tuple]] = []
        for mod in self.modules.values():
            tree = mod.src.tree
            if tree is None:
                continue
            self._scan_scope(mod, tree.body, cls=None, qual=(),
                             pending=pending)
        # class attr types from __init__ constructor assignments
        for mod in self.modules.values():
            for cname, cinfo in mod.classes.items():
                init = cinfo.methods.get("__init__")
                if init is None:
                    continue
                self._scan_attr_types(mod, cinfo,
                                      self.functions[init].node)
        for fn, quals in pending:
            self._walk_body(fn, fn.node, held=(), func_chain=quals,
                            local_aliases=self._local_aliases(fn.node),
                            loop_locals=self._loop_and_unpack_locals(
                                fn.node))

    def _scan_scope(self, mod: ModuleInfo, body, cls: Optional[str],
                    qual: tuple, pending: list) -> None:
        for stmt in body:
            if isinstance(stmt, ast.ClassDef) and cls is None and not qual:
                self._scan_scope(mod, stmt.body, cls=stmt.name, qual=(),
                                 pending=pending)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._scan_function(mod, stmt, cls, qual, pending)
            elif isinstance(stmt, (ast.If, ast.Try, ast.For, ast.While,
                                   ast.With)):
                # defs nested under module-level control flow (version
                # guards, try/except import shims — INCLUDING the
                # except-handler fallback def) still count
                handler_bodies = [h.body for h in
                                  getattr(stmt, "handlers", [])]
                for sub_body in (getattr(stmt, "body", []),
                                 getattr(stmt, "orelse", []),
                                 getattr(stmt, "finalbody", []),
                                 *handler_bodies):
                    self._scan_scope(mod, sub_body, cls, qual, pending)

    def _scan_function(self, mod: ModuleInfo, node, cls: Optional[str],
                       qual: tuple, pending: list) -> None:
        quals = qual + (node.name,)
        name = (f"{cls}.{'.'.join(quals)}" if cls is not None
                else ".".join(quals))
        key = f"{mod.relpath}::{name}"
        args = node.args
        params = tuple(a.arg for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        ) + ([args.vararg] if args.vararg else [])
          + ([args.kwarg] if args.kwarg else []))
        fn = FunctionInfo(key, mod, node, cls, params)
        self.functions[key] = fn
        mod.functions[name] = fn
        if cls is not None and len(quals) == 1:
            mod.classes[cls].methods[node.name] = key
        pending.append((fn, quals))
        # nested defs are separate scopes, analyzed on their own
        for sub in self._nested_defs(node):
            self._scan_function(mod, sub, cls, quals, pending)

    @staticmethod
    def _nested_defs(node) -> Iterator[ast.AST]:
        """defs directly inside ``node``'s body (not inside a further
        def/class — those are found by their own parent's scan)."""
        stack = list(ast.iter_child_nodes(node))
        while stack:
            child = stack.pop()
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child
                continue
            if isinstance(child, (ast.ClassDef, ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(child))

    @staticmethod
    def _local_aliases(node) -> dict:
        """{local_name: dotted_source} for simple aliases like
        ``lock = self._ack_lock`` / ``mka = _FastAck``."""
        out: dict = {}
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and sub is not node:
                continue
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 and \
                    isinstance(sub.targets[0], ast.Name):
                src = dotted_name(sub.value)
                tgt = sub.targets[0].id
                if src is not None and src != tgt:
                    # last simple alias wins; reassignment from a call
                    # etc. clears the alias
                    out[tgt] = src
                elif tgt in out and src is None:
                    out[tgt] = None
        return {k: v for k, v in out.items() if v}

    @staticmethod
    def _loop_and_unpack_locals(node) -> set:
        """Names bound by for-targets / tuple unpacking — callback
        carriers like ``for cb, tag, ... in ready:``."""
        out: set = set()

        def targets(t):
            if isinstance(t, ast.Name):
                out.add(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    targets(e)

        for sub in ast.walk(node):
            if isinstance(sub, (ast.For, ast.AsyncFor)):
                targets(sub.target)
            elif isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, (ast.Tuple, ast.List)):
                        targets(t)
        return out

    def _walk_body(self, fn: FunctionInfo, node, held: tuple,
                   func_chain: tuple, local_aliases: dict,
                   loop_locals: set) -> None:
        """Dispatch on ``node`` ITSELF, then recurse into children —
        so a ``with`` directly nested in another ``with``'s body is
        region-processed like any other (the dispatch-on-children shape
        silently skipped exactly that case)."""
        if isinstance(node, (ast.With, ast.AsyncWith)):
            inner = held
            for item in node.items:
                # the context-manager expression itself evaluates while
                # every EARLIER item is already held — its calls are
                # real calls (`with open(...):`, `with helper():`) and
                # must enter blocking classification / the call graph,
                # or context-manager I/O under a lock goes dark
                self._walk_body(fn, item.context_expr, inner,
                                func_chain, local_aliases, loop_locals)
                lid = self._region_lock(fn, item, func_chain,
                                        local_aliases)
                if lid is not False:
                    rendered = ast.unparse(item.context_expr)
                    fn.regions.append(Region(lid, node.lineno,
                                             rendered, inner))
                    lock_id = (lid if lid is not None
                               else f"?{fn.key}:{node.lineno}")
                    if lock_id not in inner:
                        inner = inner + (lock_id,)
            for sub in node.body:
                self._walk_body(fn, sub, inner, func_chain,
                                local_aliases, loop_locals)
            return
        if isinstance(node, ast.Call):
            self._note_call(fn, node, held, func_chain, local_aliases,
                            loop_locals)
        elif isinstance(node, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign, ast.Delete)):
            self._note_writes(fn, node, held)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            self._walk_body(fn, child, held, func_chain, local_aliases,
                            loop_locals)

    def _region_lock(self, fn: FunctionInfo, item: ast.withitem,
                     func_chain: tuple, local_aliases: dict):
        """ROOT lock id for a with-item; None for lock-like-but-unknown;
        False when the item is not a lock at all."""
        expr = item.context_expr
        name = dotted_name(expr)
        if name is None and isinstance(expr, ast.Call):
            # with Lock(): ... (anonymous) — lock-like, unknown identity
            cname = dotted_name(expr.func)
            if cname and cname.rsplit(".", 1)[-1] in LOCK_FACTORIES:
                return None
            return False
        if name is None:
            return False
        resolved = self._resolve_lock_name(name, fn.module, fn.cls,
                                           func_chain, local_aliases)
        if resolved is not None:
            return resolved
        if _LOCKISH.search(name):
            return None
        return False

    # -- calls ---------------------------------------------------------------

    def _note_call(self, fn: FunctionInfo, node: ast.Call, held: tuple,
                   func_chain: tuple, local_aliases: dict,
                   loop_locals: set) -> None:
        rendered = ast.unparse(node.func)
        # container-mutator method calls double as WRITES to the
        # receiver (guarded-state) — recorded HERE, where the main
        # walk's held set / local aliases are correct, instead of a
        # lexical re-walk that missed function-local lock aliases
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in MUTATOR_METHODS:
            recv = dotted_name(node.func.value)
            if recv is not None:
                fn.mutator_writes.append(Write(
                    node.lineno, recv, f"mutator:{node.func.attr}",
                    held))
        callee = self._resolve_call(fn, node, local_aliases)
        if callee is not None:
            fn.calls.append(CallSite(
                node.lineno, callee, rendered, held,
                self._allowed(fn.module.src, node, "call")))
            return
        b = self._classify_blocking(fn, node, local_aliases, loop_locals)
        if b is not None:
            cls_, desc = b
            fn.blocking.append(BlockingSite(
                node.lineno, cls_, desc, held,
                self._allowed(fn.module.src, node, cls_)))

    def _resolve_call(self, fn: FunctionInfo, node: ast.Call,
                      local_aliases: dict) -> Optional[str]:
        f = node.func
        mod = fn.module
        if isinstance(f, ast.Name):
            name = local_aliases.get(f.id, f.id)
            return self._resolve_bare(mod, name)
        if not isinstance(f, ast.Attribute):
            return None
        meth = f.attr
        recv = dotted_name(f.value)
        if recv is None:
            return None
        recv = local_aliases.get(recv, recv)
        if recv in ("self", "cls") and fn.cls is not None:
            return self._lookup_method(mod, fn.cls, meth)
        head, _, rest = recv.partition(".")
        if head in ("self", "cls") and fn.cls is not None and rest \
                and "." not in rest:
            cinfo = mod.classes.get(fn.cls)
            if cinfo is not None and rest in cinfo.attr_types:
                tmod, tcls = cinfo.attr_types[rest]
                return self._lookup_method(self.modules.get(tmod), tcls, meth)
            return None
        if "." in recv:
            return None
        # module alias: events.emit(...)
        if recv in mod.module_aliases:
            target = self.modules.get(mod.module_aliases[recv])
            if target is not None:
                fi = target.functions.get(meth)
                return fi.key if fi is not None else None
        # module-level singleton, local or imported
        single = mod.singletons.get(recv)
        if single is None and recv in mod.imports:
            imod, iname = mod.imports[recv]
            target = self.modules.get(imod)
            if target is not None:
                single = target.singletons.get(iname)
        if single is not None:
            smod, scls = single
            owner = self.modules.get(smod)
            if owner is not None:
                key = self._resolve_class(owner, scls)
                if key is not None:
                    return self._lookup_method(self.modules[key[0]],
                                               key[1], meth)
        return None

    def _resolve_bare(self, mod: ModuleInfo, name: str) -> Optional[str]:
        if name is None or "." in name:
            if name and "." in name:
                head, _, rest = name.partition(".")
                if head in mod.module_aliases and "." not in rest:
                    target = self.modules.get(mod.module_aliases[head])
                    if target is not None:
                        fi = target.functions.get(rest)
                        if fi is not None:
                            return fi.key
                        if rest in target.classes:
                            return self._lookup_method(target, rest,
                                                       "__init__")
            return None
        fi = mod.functions.get(name)
        if fi is not None:
            return fi.key
        if name in mod.classes:
            return self._lookup_method(mod, name, "__init__")
        if name in mod.imports:
            imod, iname = mod.imports[name]
            target = self.modules.get(imod)
            if target is not None:
                fi = target.functions.get(iname)
                if fi is not None:
                    return fi.key
                if iname in target.classes:
                    return self._lookup_method(target, iname, "__init__")
        return None

    def _resolve_class(self, mod: ModuleInfo, name: str
                       ) -> Optional[tuple]:
        """(module_relpath, class_name) for a class expression."""
        if name in mod.classes:
            return (mod.relpath, name)
        if name in mod.imports:
            imod, iname = mod.imports[name]
            target = self.modules.get(imod)
            if target is not None and iname in target.classes:
                return (imod, iname)
        if "." in name:
            head, _, rest = name.partition(".")
            if head in mod.module_aliases and "." not in rest:
                target = self.modules.get(mod.module_aliases[head])
                if target is not None and rest in target.classes:
                    return (mod.module_aliases[head], rest)
        return None

    def _lookup_method(self, mod: Optional[ModuleInfo], cls: str,
                       meth: str, _depth: int = 0) -> Optional[str]:
        if mod is None or _depth > 8:
            return None
        cinfo = mod.classes.get(cls)
        if cinfo is None:
            return None
        key = cinfo.methods.get(meth)
        if key is not None:
            return key
        for base in cinfo.bases:
            resolved = self._resolve_class(mod, base)
            if resolved is not None:
                found = self._lookup_method(self.modules.get(resolved[0]),
                                            resolved[1], meth, _depth + 1)
                if found is not None:
                    return found
        return None

    def _scan_attr_types(self, mod: ModuleInfo, cinfo: ClassInfo,
                         init_node) -> None:
        for sub in ast.walk(init_node):
            if not isinstance(sub, ast.Assign) or len(sub.targets) != 1:
                continue
            t = dotted_name(sub.targets[0])
            if t is None or not t.startswith("self.") or t.count(".") != 1:
                continue
            attr = t[5:]
            for value in self._ctor_candidates(sub.value):
                cname = dotted_name(value.func)
                if cname is None or \
                        cname.rsplit(".", 1)[-1] in LOCK_FACTORIES:
                    continue
                resolved = self._resolve_class(mod, cname)
                if resolved is not None:
                    cinfo.attr_types.setdefault(attr, resolved)
                    break

    @staticmethod
    def _ctor_candidates(value: ast.AST) -> Iterator[ast.Call]:
        if isinstance(value, ast.Call):
            yield value
        elif isinstance(value, ast.IfExp):
            for arm in (value.body, value.orelse):
                if isinstance(arm, ast.Call):
                    yield arm

    # -- blocking classification ---------------------------------------------

    def _classify_blocking(self, fn: FunctionInfo, node: ast.Call,
                           local_aliases: dict, loop_locals: set
                           ) -> Optional[tuple]:
        f = node.func
        if isinstance(f, ast.Name):
            name = f.id
            if name == "open":
                return ("file-io", "open(...)")
            src = local_aliases.get(name)
            if src is not None and self._resolve_bare(fn.module, src):
                return None  # alias of a known function
            if name in fn.params or name in loop_locals:
                return ("callback", f"{name}(...)")
            if src is not None and (src.startswith("self.on_")
                                    or _CALLBACK_ATTR.search(
                                        src.rsplit(".", 1)[-1])):
                return ("callback", f"{name}(...) [= {src}]")
            if _CALLBACK_NAME.search(name):
                return ("callback", f"{name}(...)")
            return None
        if not isinstance(f, ast.Attribute):
            return None
        full = dotted_name(f)
        attr = f.attr
        if full is not None:
            if full in _BLOCKING_DOTTED:
                return (_BLOCKING_DOTTED[full], f"{full}(...)")
            if full.startswith("subprocess."):
                return ("subprocess", f"{full}(...)")
            if full.startswith("os.") and attr in _OS_IO:
                return ("os-io", f"{full}(...)")
        recv = dotted_name(f.value) or ""
        recv_l = recv.lower()
        if attr in _SOCKET_ATTRS:
            return ("socket", f"{recv}.{attr}(...)")
        if attr in ("send", "recv") and any(h in recv_l
                                            for h in _SOCKET_RECV_HINTS):
            return ("socket", f"{recv}.{attr}(...)")
        if attr in _FILE_ATTRS and (
                any(h in recv_l for h in _FILE_RECV_HINTS)
                or recv_l in ("f", "fh", "fp") or recv_l.endswith("._f")):
            return ("file-io", f"{recv}.{attr}(...)")
        if _CALLBACK_ATTR.search(attr):
            return ("callback", f"{recv}.{attr}(...)")
        return None

    @staticmethod
    def _allowed(src: SourceFile, node: ast.AST, cls_: str) -> bool:
        first = node.lineno
        last = getattr(node, "end_lineno", None) or first
        for line in range(first - 1, last + 1):
            m = _ALLOW_MARKER.search(src.comments.get(line, ""))
            if m:
                scope = m.group(1)
                if scope is None:
                    return True
                names = set(scope.split(","))
                if cls_ in names or "*" in names or "all" in names:
                    return True
        return False

    # -- writes (guarded-by's input) -----------------------------------------

    def _note_writes(self, fn: FunctionInfo, node, held: tuple) -> None:
        if isinstance(node, ast.Delete):
            for t in node.targets:
                base = self._write_base(t)
                if base is not None:
                    fn.writes.append(Write(node.lineno, base, "del", held))
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    base = self._write_base(e)
                    if base is not None:
                        fn.writes.append(Write(node.lineno, base,
                                               "assign", held))

    @staticmethod
    def _write_base(target: ast.AST) -> Optional[str]:
        """Canonical written expression AND its one-level base: a write
        to ``self._sessions[key]`` is a write to ``self._sessions``."""
        try:
            full = ast.unparse(target)
        except Exception:
            return None
        if isinstance(target, ast.Subscript):
            base = dotted_name(target.value)
            return base if base is not None else full
        return full

    def mutator_calls(self, fn: FunctionInfo) -> Iterator[Write]:
        """Container-mutator method calls as writes — recorded by the
        main walk (`_note_call`) with its factual held set, so aliased
        and function-local locks resolve exactly like any other call."""
        return iter(fn.mutator_writes)

    # -- traversal: lock edges + transitive blocking -------------------------

    def _traverse(self) -> None:
        for key in sorted(self.functions):
            self._visit(self.functions[key], frozenset(), frozenset(),
                        (), set(), 0)

    def _visit(self, fn: FunctionInfo, held: frozenset,
               excused: frozenset, chain: tuple, visited: set,
               depth: int) -> None:
        """``held`` is the factual held set (feeds the ORDERING graph —
        an allow marker cannot erase an acquisition order); ``excused``
        is the subset an allow-blocking-under-lock call-site marker
        accepted, subtracted only from BLOCKING reports."""
        state = (fn.key, held, excused)
        if state in visited or depth > 40:
            return
        visited.add(state)
        path = fn.module.relpath
        for region in fn.regions:
            if region.lock is None:
                continue
            outer = held | set(region.outer)
            step = (f"{path}:{region.line} {fn.name} acquires "
                    f"{region.lock} (with {region.rendered})")
            for lock in sorted(outer):
                if lock.startswith("?"):
                    continue
                edge = (lock, region.lock)
                if edge not in self.lock_edges:
                    self.lock_edges[edge] = chain + (step,)
        for site in fn.blocking:
            total = (held | set(site.held)) - excused
            if site.allowed:
                # the allow excuses ONLY the locks visible at the marked
                # line — a lock smuggled in by a caller still reports,
                # so an audited leaf can never silently cover new
                # callers (fix or mark the caller instead)
                total = total - set(site.held)
            if not total:
                continue
            sid = (fn.key, site.line, site.rendered)
            if sid not in self.blocked:
                step = (f"{path}:{site.line} {fn.name} calls "
                        f"{site.rendered} [{site.cls}]")
                self.blocked[sid] = (site, fn, chain + (step,),
                                     tuple(sorted(total)))
        for call in fn.calls:
            callee = self.functions.get(call.callee)
            if callee is None:
                continue
            nxt = held | set(call.held)
            nxt_excused = excused
            if call.allowed:
                # same lexical-only contract as sites, applied to the
                # whole callee subtree (the sink-serializer idiom: the
                # serializing lock is held around a helper whose entire
                # JOB is the I/O it guards)
                nxt_excused = excused | set(call.held)
            step = (f"{path}:{call.line} {fn.name} calls "
                    f"{callee.name}")
            self._visit(callee, frozenset(nxt), frozenset(nxt_excused),
                        chain + (step,), visited, depth + 1)

    # -- entry-held fixpoint --------------------------------------------------

    def _fixpoint_entry_held(self) -> dict:
        callers: dict[str, list] = {}
        for fn in self.functions.values():
            for call in fn.calls:
                if call.callee in self.functions:
                    callers.setdefault(call.callee, []).append(
                        (fn.key, frozenset(
                            h for h in call.held if not h.startswith("?"))))
        all_locks = frozenset(self.root_lock(l) for l in self.locks)
        # the optimistic all-locks seed is only sound for functions
        # REACHABLE from a zero-caller root: a closed caller-cycle
        # (mutually-recursive helpers with no outside entry) never
        # intersects against a root path and would converge to "all
        # locks held at entry" — disarming guarded-state exactly where
        # nothing is proven.  Unreachable functions stay at the
        # conservative empty set.
        roots = [k for k in self.functions if k not in callers]
        reachable = set(roots)
        stack = list(roots)
        while stack:
            k = stack.pop()
            for call in self.functions[k].calls:
                if call.callee in self.functions and \
                        call.callee not in reachable:
                    reachable.add(call.callee)
                    stack.append(call.callee)
        held = {key: (all_locks if key in callers and key in reachable
                      else frozenset())
                for key in self.functions}
        changed = True
        while changed:
            changed = False
            for key in self.functions:
                if key not in reachable:
                    continue  # frozen at the conservative empty set
                sites = callers.get(key)
                if not sites:
                    continue
                new = None
                for caller_key, lex in sites:
                    s = lex | held.get(caller_key, frozenset())
                    new = s if new is None else (new & s)
                new = new or frozenset()
                if new != held[key]:
                    held[key] = new
                    changed = True
        return held

    def entry_held(self, fn_key: str) -> frozenset:
        return self._entry_held.get(fn_key, frozenset())


# -- the machine-readable lock graph (artifacts/torch/lock_graph.json) -------------

def render_lock_graph(index: ProgramIndex) -> dict:
    """JSON-able, deterministic, checkout-location-independent: lock
    ids and paths are project-relative, orderings are sorted, and the
    representative chains come from the sorted deterministic traversal
    — regenerating on an unchanged tree is byte-stable."""
    locks = []
    for lid in sorted(index.locks):
        ld = index.locks[lid]
        locks.append({
            "id": ld.id,
            "kind": ld.kind,
            "path": ld.path,
            "line": ld.line,
            "alias_of": ld.alias_of,
        })
    edges = []
    for (a, b) in sorted(index.lock_edges):
        edges.append({
            "from": a,
            "to": b,
            "chain": list(index.lock_edges[(a, b)]),
        })
    return {
        "version": 1,
        "generator": "python -m dat_replication_protocol_tpu_torch.analysis "
                     "--lock-graph",
        "locks": locks,
        "edges": edges,
    }
