"""Event-loop readiness certifier: may-block summaries,
blocking-reachability, and callback-escape over the shared ProgramIndex.

ROADMAP item 2 rebuilds the edge onto ONE selector/epoll dispatch loop.
The proof obligation that blocks it is not code but *knowledge*: which
functions may block, for how long, and which user-supplied callables can
end up running on the dispatcher thread.  This module computes that
knowledge as a whole-program pass and freezes it into a readable
certificate:

* **May-block summaries.**  Every function (plus every lambda literal)
  is classified on a three-level lattice::

      nonblocking < bounded-blocking < unbounded-blocking

  A *site* is bounded when the call itself carries its bound — a
  ``timeout=``/``deadline=`` keyword, a positional duration on
  ``wait``/``join``/``acquire``/``sleep``, ``acquire(blocking=False)``,
  a 4-argument ``select.select`` — and unbounded otherwise (bare
  ``recv``/``accept``/``sendall``, raw ``os.read``/``os.write``, file
  I/O, subprocess without ``timeout=``, bare ``wait()``/``join()``/
  ``acquire()``).  ``time.sleep(t)`` is bounded by construction: its
  argument IS the bound.  A function's summary is the max over its own
  sites and its callees', computed to fixpoint over the call graph
  (monotone on a finite lattice, so recursion cycles terminate and stay
  sound: a cycle member inherits the worst site anywhere on the cycle).

* **Thread and stored-callback propagation.**  ``Thread(target=f)``
  records a *spawn edge*: the target's classification is computed and
  reported (the spawned thread's readiness), but does NOT raise the
  spawner's summary — starting a thread is nonblocking.  A callable
  stored into an attribute or container (``self._handlers[k] = lambda:
  ...``, ``self._cb = self._on_bytes``) is registered under the stored
  expression; a later dynamic call through that expression
  (``self._handlers[k](...)``) links to the registered callables and
  inherits their summaries.  A dynamic call with NO registered target is
  conservatively a user callback (unbounded).

* **Entry points.**  The table below names the edge's dispatch surfaces
  (hub/fanout dispatchers, sidecar session threads, transport pumps,
  gossip and stats drivers).  The certificate
  (``artifacts/torch/event_loop_surface.json``, written by
  ``--write-artifacts``) lists, per entry point, every reachable
  blocking site — unbounded ones with a full ``file:line`` evidence
  chain — plus the threads it spawns and the callback sites that can
  run on its thread.  Functions named ``_dispatch_loop`` are *enforced*
  dispatchers wherever they appear (fixtures included).

* **Rules.**  :class:`BlockingReachability` — no unbounded-blocking
  site may be reachable from an enforced dispatch loop (escape:
  ``# datlint: allow-blocking-reachable(class)`` next to a written
  justification, e.g. a syscall on an fd the code keeps nonblocking).
  :class:`CallbackEscape` — no user-callback invocation may be
  reachable on the dispatcher thread (escape: ``# datlint:
  allow-callback-escape`` with justification; the audited cases are the
  fanout sink-peer delivery surface and the obs event sinks).

Known under-approximation (same doctrine as the lock model, see
ANALYSIS.md): unresolvable calls contribute no edges, native pump
entry points (``dat_pump_*`` — MSG_DONTWAIT batched turns) are invisible
to the AST and therefore classified by their Python-side wait loops, and
a socket timeout set via ``settimeout``/``SO_RCVTIMEO`` is not visible
at the recv site — such sites stay "unbounded" and carry an audited
allow marker where the bound is real.

One difference from the JAX package's certifier: :data:`ENTRY_SPECS`
has no ``native-send-pump``/``native-recv-pump`` rows.  The port has no
native wire pump (``session/pump.py`` ``send_pump``/``recv_pump``) yet;
the rows come back with it.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterator, Optional

from ..engine import Finding, Project, SourceFile, dotted_name, \
    walk_function_body
from .model import ProgramIndex

LEVELS = ("nonblocking", "bounded-blocking", "unbounded-blocking")
_LEVEL_NUM = {name: i for i, name in enumerate(LEVELS)}

_ALLOW_REACH = re.compile(r"allow-blocking-reachable(?:\(([\w,*-]+)\))?")
_ALLOW_ESCAPE = re.compile(r"allow-callback-escape")

# names whose single positional argument is a duration even without a
# timeout= keyword: thread.join(5), ev.wait(0.1), time.sleep(x)
_TIMEOUTISH_NAME = re.compile(
    r"timeout|deadline|interval|linger|poll|delay|grace|backoff",
    re.IGNORECASE)

# entry points of the edge, named for the certificate.  role:
# "dispatcher" rows are ALSO enforced by the rules below (via the
# _dispatch_loop name pattern); the rest are enumerated so the item-2
# rewrite absorbs a KNOWN surface.  Specs missing from the analyzed
# tree are reported loudly in the certificate, never silently dropped.
ENTRY_SPECS = (
    ("hub-dispatch", "hub/engine.py", "ReplicationHub._dispatch_loop",
     "dispatcher"),
    ("edge-dispatch", "edge/loop.py", "EdgeLoop._dispatch_loop",
     "dispatcher"),
    ("fanout-dispatch", "fanout/server.py", "FanoutServer._dispatch_loop",
     "dispatcher"),
    ("sidecar-session", "sidecar.py", "run_session", "session"),
    ("sidecar-subscriber", "sidecar.py", "run_subscriber", "session"),
    ("sidecar-accept", "sidecar.py", "serve_tcp", "acceptor"),
    ("sidecar-snapshot-accept", "sidecar.py", "SnapshotListener._loop",
     "acceptor"),
    ("sidecar-stats", "sidecar.py", "StatsEmitter._run", "driver"),
    ("transport-send-pump", "session/transport.py", "send_over", "pump"),
    ("transport-recv-pump", "session/transport.py", "recv_over", "pump"),
    ("gossip-driver", "cluster/live.py", "GossipDriver._run", "driver"),
)

_DISPATCH_NAME = re.compile(r"^_?dispatch_loop$")


@dataclasses.dataclass
class ReadySite:
    """One blocking/wait/callback site in readiness vocabulary."""

    line: int
    cls: str        # model classes + wait | join | lock-acquire | dynamic
    bound: str      # "bounded" | "unbounded"
    rendered: str
    allowed: bool = False      # allow-blocking-reachable covers it
    cb_allowed: bool = False   # allow-callback-escape covers it


@dataclasses.dataclass
class ThreadSpawn:
    line: int
    target: Optional[str]      # resolved function key, or None
    rendered: str


@dataclasses.dataclass
class ReadyFn:
    key: str
    relpath: str
    name: str
    sites: list = dataclasses.field(default_factory=list)
    edges: list = dataclasses.field(default_factory=list)  # (line, key, txt)
    spawns: list = dataclasses.field(default_factory=list)
    summary: str = "nonblocking"


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _timeout_kw(node: ast.Call) -> Optional[bool]:
    """True: an explicit non-None timeout bound.  False: explicit
    ``timeout=None`` (explicitly unbounded).  None: no timeout kw."""
    for kw in node.keywords:
        if kw.arg in ("timeout", "deadline"):
            return not _is_none(kw.value)
    return None


def _timeoutish(arg: ast.AST) -> bool:
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, (int, float)) \
            and not isinstance(arg.value, bool)
    name = dotted_name(arg)
    if name is not None:
        return bool(_TIMEOUTISH_NAME.search(name.rsplit(".", 1)[-1]))
    # an expression (min(...), self._linger_s * 2): durations are the
    # codebase idiom for wait arguments; count it as a bound
    return isinstance(arg, (ast.BinOp, ast.Call, ast.IfExp))


class ReadinessIndex:
    """Per-function may-block summaries over one :class:`ProgramIndex`.

    Build once per project via :meth:`get` (memoized alongside the
    concurrency index, so the rules and the artifact writer share it).
    """

    @classmethod
    def get(cls, project: Project) -> "ReadinessIndex":
        idx = getattr(project, "_readiness_index", None)
        if idx is None:
            idx = cls(project)
            project._readiness_index = idx
        return idx

    def __init__(self, project: Project):
        self.base = ProgramIndex.get(project)
        self.fns: dict[str, ReadyFn] = {}
        # (relpath, class-or-None, stored expr) -> sorted keys
        self._stored: dict[tuple, list] = {}
        self._dynamic: list = []   # (ReadyFn, line, expr, rendered, node)
        self._reports: dict[str, dict] = {}
        self._scan()
        self._link_dynamic()
        self._fixpoint()

    # -- scan ---------------------------------------------------------------

    def _scan(self) -> None:
        for key in sorted(self.base.functions):
            fn = self.base.functions[key]
            rf = ReadyFn(key, fn.module.relpath, fn.name)
            self.fns[key] = rf
            aliases = self.base._local_aliases(fn.node)
            loops = self.base._loop_and_unpack_locals(fn.node)
            lambdas = [n for n in walk_function_body(fn.node)
                       if isinstance(n, ast.Lambda)]
            lam_keys = {}
            for lam in sorted(lambdas, key=lambda n: (n.lineno,
                                                      n.col_offset)):
                lk = f"{key}.<lambda>:{lam.lineno}:{lam.col_offset}"
                lam_keys[id(lam)] = lk
                lrf = ReadyFn(lk, fn.module.relpath,
                              f"{fn.name}.<lambda>")
                self.fns[lk] = lrf
                for sub in ast.walk(lam.body):
                    if isinstance(sub, ast.Call):
                        self._classify_call(lrf, fn, sub, aliases, loops,
                                            lam_keys)
            for node in walk_function_body(fn.node):
                if isinstance(node, ast.Call):
                    self._classify_call(rf, fn, node, aliases, loops,
                                        lam_keys)
                elif isinstance(node, ast.Assign) and \
                        len(node.targets) == 1:
                    self._note_stored(rf, fn, node, aliases, lam_keys)
            rf.edges.extend((c.line, c.callee, c.rendered)
                            for c in fn.calls)
            rf.sites.sort(key=lambda s: (s.line, s.rendered))
            rf.edges.sort()
            rf.spawns.sort(key=lambda s: (s.line, s.rendered))
        for k in self._stored:
            self._stored[k] = sorted(set(self._stored[k]))

    def _classify_call(self, rf: ReadyFn, fn, node: ast.Call,
                       aliases: dict, loops: set, lam_keys: dict) -> None:
        base = self.base
        rendered = ast.unparse(node.func)
        # thread spawn: propagate the TARGET's readiness as a spawn
        # edge, not through the (nonblocking) constructor call
        cname = dotted_name(node.func)
        if cname is not None and cname.rsplit(".", 1)[-1] == "Thread":
            target = None
            for kw in node.keywords:
                if kw.arg == "target":
                    tkeys = self._callable_keys(fn, kw.value, aliases,
                                                lam_keys)
                    target = tkeys[0] if tkeys else None
                    rf.spawns.append(ThreadSpawn(
                        node.lineno, target,
                        ast.unparse(kw.value)))
            return
        if base._resolve_call(fn, node, aliases) is not None:
            return  # a call-graph edge (fn.calls) carries it
        src = fn.module.src
        # stored-callable dynamic dispatch: self._handlers[key](...)
        f = node.func
        if isinstance(f, ast.Subscript):
            recv = dotted_name(f.value)
            if recv is not None:
                recv = aliases.get(recv, recv)
                self._dynamic.append((rf, node.lineno, recv,
                                      f"{recv}[...](...)", fn, node))
                return
        w = self._classify_wait(node)
        if w is not None:
            cls_, bound = w
            rf.sites.append(ReadySite(
                node.lineno, cls_, bound, f"{rendered}(...)",
                self._marker(src, node, _ALLOW_REACH, cls_),
                self._marker(src, node, _ALLOW_ESCAPE, cls_)))
            return
        # stored-attribute dispatch: self._cb(...) where some method
        # assigned self._cb = <callable>
        name = dotted_name(f)
        if name is not None:
            name = aliases.get(name, name)
            skey = (fn.module.relpath, fn.cls, name)
            if skey in self._stored or self._might_store(skey):
                self._dynamic.append((rf, node.lineno, name,
                                      f"{name}(...)", fn, node))
                return
        b = base._classify_blocking(fn, node, aliases, loops)
        if b is None:
            return
        cls_, desc = b
        if cls_ == "socket" and dotted_name(f) == "select.select":
            bound = "bounded" if len(node.args) >= 4 else "unbounded"
        elif cls_ == "sleep":
            bound = ("bounded" if node.args
                     and not _is_none(node.args[0]) else "unbounded")
        elif _timeout_kw(node) is True:
            bound = "bounded"   # create_connection/subprocess timeout=
        else:
            bound = "unbounded"
        rf.sites.append(ReadySite(
            node.lineno, cls_, bound, desc,
            self._marker(src, node, _ALLOW_REACH, cls_),
            self._marker(src, node, _ALLOW_ESCAPE, cls_)))

    def _might_store(self, skey: tuple) -> bool:
        # scan ordering: a dynamic site can precede the method that
        # stores into the attribute; defer ALL dotted-receiver linking
        # to _link_dynamic, which runs after every store is known.
        # Here only self-attribute receivers qualify (a plain dotted
        # call like time.monotonic() must not become "dynamic").
        relpath, cls_, name = skey
        return cls_ is not None and name.startswith("self.") \
            and name.count(".") == 1 and self._stores_into(relpath, cls_,
                                                           name)

    def _stores_into(self, relpath: str, cls_: str, name: str) -> bool:
        mod = self.base.modules.get(relpath)
        if mod is None:
            return False
        attr = name.split(".", 1)[1]
        for fn in mod.functions.values():
            if fn.cls != cls_:
                continue
            for node in walk_function_body(fn.node):
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    t = dotted_name(node.targets[0])
                    if t == f"self.{attr}":
                        return True
        return False

    def _classify_wait(self, node: ast.Call) -> Optional[tuple]:
        f = node.func
        if not isinstance(f, ast.Attribute):
            return None
        attr = f.attr
        tkw = _timeout_kw(node)
        if attr == "wait" or attr.startswith("wait_"):
            if tkw is not None:
                return ("wait", "bounded" if tkw else "unbounded")
            # wait_for(pred[, timeout]): the FIRST positional is the
            # predicate, only a second one is a bound
            duration_pos = 1 if attr.startswith("wait_") else 0
            if len(node.args) > duration_pos \
                    and not _is_none(node.args[duration_pos]):
                return ("wait", "bounded")
            return ("wait", "unbounded")
        if attr == "join":
            if tkw is not None:
                return ("join", "bounded" if tkw else "unbounded")
            if not node.args and not node.keywords:
                return ("join", "unbounded")
            if len(node.args) == 1 and not node.keywords \
                    and _timeoutish(node.args[0]):
                return ("join", "bounded")
            return None   # str.join / os.path.join shapes
        if attr == "acquire":
            if tkw is True:
                return ("lock-acquire", "bounded")
            for kw in node.keywords:
                if kw.arg == "blocking" and isinstance(kw.value,
                                                       ast.Constant) \
                        and kw.value.value is False:
                    return ("lock-acquire", "bounded")
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and node.args[0].value is False:
                return ("lock-acquire", "bounded")
            return ("lock-acquire", "unbounded")
        return None

    @staticmethod
    def _marker(src: SourceFile, node: ast.AST, regex: re.Pattern,
                cls_: str) -> bool:
        first = node.lineno
        last = getattr(node, "end_lineno", None) or first
        for line in range(first - 1, last + 1):
            m = regex.search(src.comments.get(line, ""))
            if m:
                scope = m.group(1) if m.groups() else None
                if scope is None:
                    return True
                names = set(scope.split(","))
                if cls_ in names or "*" in names or "all" in names:
                    return True
        return False

    def _note_stored(self, rf: ReadyFn, fn, node: ast.Assign,
                     aliases: dict, lam_keys: dict) -> None:
        target = node.targets[0]
        if isinstance(target, ast.Subscript):
            expr = dotted_name(target.value)
        elif isinstance(target, ast.Attribute):
            expr = dotted_name(target)
        else:
            return
        if expr is None:
            return
        values = (list(node.value.values)
                  if isinstance(node.value, ast.Dict) else [node.value])
        keys: list = []
        for value in values:
            keys.extend(self._callable_keys(fn, value, aliases, lam_keys))
        if keys:
            self._stored.setdefault(
                (fn.module.relpath, fn.cls, expr), []).extend(keys)

    def _callable_keys(self, fn, value: ast.AST, aliases: dict,
                       lam_keys: dict) -> list:
        """Function keys a stored/spawned value may refer to."""
        if isinstance(value, ast.Lambda):
            lk = lam_keys.get(id(value))
            return [lk] if lk is not None else []
        name = dotted_name(value)
        if name is None:
            return []
        name = aliases.get(name, name)
        base = self.base
        mod = fn.module
        if name.startswith("self.") and name.count(".") == 1 \
                and fn.cls is not None:
            k = base._lookup_method(mod, fn.cls, name.split(".", 1)[1])
            return [k] if k is not None else []
        if "." not in name:
            # a local def is registered under the enclosing qualname
            local = mod.functions.get(f"{fn.name}.{name}")
            if local is not None:
                return [local.key]
            k = base._resolve_bare(mod, name)
            return [k] if k is not None else []
        k = base._resolve_bare(mod, name)
        return [k] if k is not None else []

    # -- dynamic linking ----------------------------------------------------

    def _link_dynamic(self) -> None:
        for rf, line, expr, rendered, fn, node in self._dynamic:
            targets = self._stored.get((rf.relpath, fn.cls, expr)) \
                or self._stored.get((rf.relpath, None, expr), [])
            if targets:
                for t in targets:
                    rf.edges.append((line, t, rendered))
            else:
                src = fn.module.src
                rf.sites.append(ReadySite(
                    line, "callback", "unbounded", rendered,
                    self._marker(src, node, _ALLOW_REACH, "callback"),
                    self._marker(src, node, _ALLOW_ESCAPE, "callback")))
            rf.edges.sort()
            rf.sites.sort(key=lambda s: (s.line, s.rendered))

    # -- summaries ----------------------------------------------------------

    def _fixpoint(self) -> None:
        level = {k: 0 for k in self.fns}
        for k, rf in self.fns.items():
            for site in rf.sites:
                # an allow marker is an AUDITED bound (the written
                # justification asserts where the bound really lives —
                # a nonblocking fd, a kernel SO_*TIMEO, an attacher
                # contract): audited sites classify bounded, so the
                # summary states what the code + its audits guarantee
                audited = site.allowed or (site.cls == "callback"
                                           and site.cb_allowed)
                level[k] = max(level[k],
                               2 if site.bound == "unbounded"
                               and not audited else 1)
        changed = True
        while changed:
            changed = False
            for k in sorted(self.fns):
                rf = self.fns[k]
                new = level[k]
                for _line, callee, _r in rf.edges:
                    new = max(new, level.get(callee, 0))
                if new != level[k]:
                    level[k] = new
                    changed = True
        for k, rf in self.fns.items():
            rf.summary = LEVELS[level[k]]

    def summary(self, key: str) -> str:
        rf = self.fns.get(key)
        return rf.summary if rf is not None else "nonblocking"

    # -- reachability -------------------------------------------------------

    def dispatchers(self) -> list:
        """Keys of enforced dispatch loops (name pattern, so fixtures
        and the real tree are held to the same contract)."""
        return sorted(
            k for k, rf in self.fns.items()
            if _DISPATCH_NAME.match(rf.name.rsplit(".", 1)[-1]))

    def entry_report(self, key: str) -> dict:
        """Reachable sites/spawns from ``key`` with evidence chains:
        ``{"sites": [(relpath, ReadySite, chain)], "spawns":
        [(relpath, ThreadSpawn, chain)]}`` — deterministic (sorted
        edges, first chain wins)."""
        rep = self._reports.get(key)
        if rep is not None:
            return rep
        sites: list = []
        spawns: list = []
        seen_sites: set = set()
        visited: set = set()

        def visit(k: str, chain: tuple, depth: int) -> None:
            rf = self.fns.get(k)
            if rf is None or k in visited or depth > 64:
                return
            visited.add(k)
            for site in rf.sites:
                sid = (rf.relpath, site.line, site.rendered)
                if sid in seen_sites:
                    continue
                seen_sites.add(sid)
                step = (f"{rf.relpath}:{site.line} {rf.name} calls "
                        f"{site.rendered} [{site.cls}, {site.bound}]")
                sites.append((rf.relpath, site, chain + (step,)))
            for spawn in rf.spawns:
                step = (f"{rf.relpath}:{spawn.line} {rf.name} spawns "
                        f"Thread(target={spawn.rendered})")
                spawns.append((rf.relpath, spawn, chain + (step,)))
            for line, callee, rendered in rf.edges:
                step = f"{rf.relpath}:{line} {rf.name} calls {rendered}"
                visit(callee, chain + (step,), depth + 1)

        visit(key, (), 0)
        rep = {"sites": sites, "spawns": spawns}
        self._reports[key] = rep
        return rep


# -- the enforced rules ------------------------------------------------------

_CHAIN_SEP = " -> "


class BlockingReachability:
    name = "blocking-reachability"
    description = (
        "no unbounded-blocking call (bare recv/accept/join/wait/"
        "lock-acquire, raw fd or file I/O without a bound) reachable "
        "from a certified dispatch loop; escape: "
        "allow-blocking-reachable(class) + justification"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        idx = ReadinessIndex.get(project)
        reported: set = set()
        for key in idx.dispatchers():
            rep = idx.entry_report(key)
            for relpath, site, chain in rep["sites"]:
                if site.bound != "unbounded" or site.cls == "callback":
                    continue   # callbacks are callback-escape's domain
                if site.allowed:
                    continue
                sid = (relpath, site.line, site.rendered)
                if sid in reported:
                    continue
                reported.add(sid)
                yield Finding(
                    path=idx.base.src_path(relpath),
                    line=site.line,
                    rule=self.name,
                    message=(
                        f"{site.rendered} [{site.cls}] is unbounded-"
                        f"blocking and reachable from the dispatch loop "
                        f"{idx.fns[key].name}: one stuck turn parks "
                        f"every session behind the dispatcher.  "
                        f"Path: {_CHAIN_SEP.join(chain)}"
                    ),
                    chains=(chain,),
                )


class CallbackEscape:
    name = "callback-escape"
    description = (
        "no user-supplied callback may run on a certified dispatcher "
        "thread (it can block forever and re-enter the loop's state); "
        "escape: allow-callback-escape + justification"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        idx = ReadinessIndex.get(project)
        reported: set = set()
        for key in idx.dispatchers():
            rep = idx.entry_report(key)
            for relpath, site, chain in rep["sites"]:
                if site.cls != "callback" or site.cb_allowed:
                    continue
                sid = (relpath, site.line, site.rendered)
                if sid in reported:
                    continue
                reported.add(sid)
                yield Finding(
                    path=idx.base.src_path(relpath),
                    line=site.line,
                    rule=self.name,
                    message=(
                        f"{site.rendered} invokes a user-supplied "
                        f"callable on the dispatch-loop thread of "
                        f"{idx.fns[key].name}: user code there can "
                        f"block the whole loop or re-enter its state.  "
                        f"Path: {_CHAIN_SEP.join(chain)}"
                    ),
                    chains=(chain,),
                )


# -- the certificate (artifacts/torch/event_loop_surface.json) ---------------------

def render_event_loop_surface(index: ReadinessIndex) -> dict:
    """JSON-able, deterministic, checkout-location-independent — the
    same byte-stability contract as :func:`..model.render_lock_graph`.
    Unbounded sites carry full evidence chains (they are what the
    item-2 rewrite must bound or absorb); bounded sites are enumerated
    compactly."""
    entries = []
    missing = []
    by_key = {f"{rel}::{qual}": (name, role)
              for name, rel, qual, role in ENTRY_SPECS}
    named_keys = set()
    for name, rel, qual, role in ENTRY_SPECS:
        key = f"{rel}::{qual}"
        if key in index.fns:
            named_keys.add(key)
        else:
            missing.append({"entry": name, "function": key})
    # enforced dispatchers outside the spec table (fixtures, future
    # loops) still certify
    extra = [k for k in index.dispatchers() if k not in named_keys]
    ordered = sorted(named_keys) + sorted(extra)
    for key in ordered:
        rf = index.fns[key]
        name, role = by_key.get(key, (rf.name, "dispatcher"))
        rep = index.entry_report(key)
        unbounded = []
        bounded = []
        callbacks = []
        for relpath, site, chain in rep["sites"]:
            loc = f"{relpath}:{site.line}"
            if site.cls == "callback":
                callbacks.append({
                    "site": loc, "call": site.rendered,
                    "allowed": site.cb_allowed,
                    "chain": list(chain),
                })
            elif site.bound == "unbounded":
                unbounded.append({
                    "site": loc, "call": site.rendered,
                    "class": site.cls, "allowed": site.allowed,
                    "chain": list(chain),
                })
            else:
                bounded.append({
                    "site": loc, "call": site.rendered,
                    "class": site.cls,
                })
        spawns = []
        for relpath, spawn, chain in rep["spawns"]:
            spawns.append({
                "site": f"{relpath}:{spawn.line}",
                "target": spawn.target,
                "classification": (index.summary(spawn.target)
                                   if spawn.target else "unknown"),
            })
        entries.append({
            "entry": name,
            "function": key,
            "role": role,
            "enforced": bool(
                _DISPATCH_NAME.match(rf.name.rsplit(".", 1)[-1])),
            "classification": rf.summary,
            # clean under both rules: every reachable unbounded site
            # and callback invocation carries an audited allow marker
            "certified": (all(d["allowed"] for d in unbounded)
                          and all(d["allowed"] for d in callbacks)),
            "unbounded": sorted(unbounded, key=lambda d: (d["site"],
                                                          d["call"])),
            "bounded": sorted(bounded, key=lambda d: (d["site"],
                                                      d["call"])),
            "callbacks": sorted(callbacks, key=lambda d: (d["site"],
                                                          d["call"])),
            "spawns": sorted(spawns, key=lambda d: (d["site"],
                                                    str(d["target"]))),
        })
    counts = {lvl: 0 for lvl in LEVELS}
    unbounded_fns = []
    for k in sorted(index.fns):
        rf = index.fns[k]
        counts[rf.summary] += 1
        if rf.summary == "unbounded-blocking" and "<lambda>" not in k:
            unbounded_fns.append(k)
    return {
        "version": 1,
        "generator": "python -m dat_replication_protocol_tpu_torch.analysis "
                     "--write-artifacts",
        "levels": list(LEVELS),
        "summary": {"functions": len(index.fns), **counts},
        "entry_points": entries,
        "missing_entry_points": sorted(missing,
                                       key=lambda d: d["entry"]),
        "unbounded_functions": unbounded_fns,
    }
