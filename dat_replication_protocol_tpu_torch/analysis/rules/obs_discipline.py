"""obs-discipline: telemetry names are literals; stdout is not a log.

Motivating design contract (OBSERVABILITY.md): the metric
catalog is only auditable if every name that can ever reach the
registry is greppable — ``grep -r '"decoder.bytes"'`` must find the
instrumentation site.  A name built at runtime (f-string, variable,
concatenation) silently forks the catalog: dashboards and the
conformance oracle reference names that may never exist, and a typo'd
dynamic name becomes a brand-new metric instead of an error.

Flagged shapes (Python sources only):

* a call to a registry factory, event emitter, span opener, jit-site
  registration, or watermark registration — ``counter(...)``,
  ``gauge(...)``, ``histogram(...)``, ``emit(...)``,
  ``trace_span(...)``, ``trace_instant(...)``, ``jit_site(...)``,
  ``track(...)`` (bare, aliased with leading underscores, or as an
  attribute like ``EVENTS.emit``) — whose first argument is not a
  string literal: span names carry the SAME greppability contract as
  event names, the recompile sentinel's per-site names the same
  again, and a watermark's ROLE (its first argument) once more — the
  fleet aggregator's lag join keys on the role vocabulary, so a
  runtime-built role is a silent fork of the join itself (the LINK argument is runtime by design: it
  names a session, like a collector label);
* a bare ``print(...)`` (no ``file=`` keyword, i.e. stdout) anywhere
  in the package: stdout belongs to the wire/CLI protocol, and
  diagnostics belong in the structured event log (:mod:`...obs.events`)
  or explicitly on stderr;
* in ``obs/http.py`` only: a ``/healthz``-serving function (name
  contains ``healthz``) that takes ANY lock via ``with`` or makes a
  device-dispatch-shaped call (the hub-isolation vocabulary).  The
  health probe exists to detect a wedged engine; a probe that blocks
  behind the engine's lock — or worse, touches the device — inverts
  its purpose.  Owners feed admission state through LOCK-FREE
  callables (``ReplicationHub.admission_state``) instead.

Exemptions:

* ``obs/metrics.py`` and ``obs/events.py`` themselves — the registry
  and the log legitimately forward ``name`` parameters; they are the
  plumbing, not instrumentation sites (likewise ``obs/watermarks.py``,
  ``obs/http.py``, and ``obs/fleet.py``: the board renders labeled
  names from tracked state, the endpoint and aggregator ship whole
  snapshots — their callers hold the greppable literals);
* ``__main__.py`` modules for the bare-print check — a CLI's stdout IS
  its interface (the datlint CLI prints findings there by design);
* the standard ``# datlint: disable=obs-discipline`` suppression.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..engine import Finding, Project
from .hub_isolation import _dispatchy_call, _is_lock_ctx

_TELEMETRY_FNS = {"counter", "gauge", "histogram", "emit",
                  "trace_span", "trace_instant", "jit_site", "track",
                  "phase", "account"}
# attribute-call receivers that denote the obs layer (normalized:
# underscores stripped, lowercased) — `EVENTS.emit(...)`,
# `obs_metrics.counter(...)`, `registry.histogram(...)`,
# `prof.phase(...)` (the loop profiler).  Unrelated APIs
# sharing a method name (`handler.emit(record)`,
# `np.histogram(data, bins)`) must NOT trip the rule.
_TELEMETRY_RECEIVERS = {"events", "metrics", "obs", "obs_events",
                        "obs_metrics", "obs_tracing", "registry", "reg",
                        "spans", "tracing", "device", "obs_device",
                        "watermarks", "obs_watermarks", "board",
                        "prof", "profiler", "loopprof", "wirecost"}
# the obs plumbing itself: (parent dir, filename) pairs exempt from the
# literal-name check (they forward `name` parameters by design; the
# greppable sites are their callers)
_PLUMBING = {("obs", "metrics.py"), ("obs", "events.py"),
             ("obs", "tracing.py"), ("obs", "flight.py"),
             ("obs", "device.py"), ("obs", "__init__.py"),
             ("obs", "watermarks.py"), ("obs", "http.py"),
             ("obs", "fleet.py"), ("obs", "loopprof.py"),
             ("obs", "propagation.py"), ("obs", "wirecost.py")}
# the /healthz lock-discipline check applies to the endpoint module
_HEALTHZ_MODULE = ("obs", "http.py")


def _telemetry_fn_name(call: ast.Call) -> str | None:
    """The normalized telemetry function name for a call, or None.
    Leading underscores are stripped so the hoisted-handle idiom
    (``from ..obs.metrics import counter as _counter``) still matches;
    attribute calls additionally require a telemetry-shaped receiver."""
    fn = call.func
    if isinstance(fn, ast.Attribute):
        recv = fn.value
        recv_name = recv.id if isinstance(recv, ast.Name) else (
            recv.attr if isinstance(recv, ast.Attribute) else None)
        if recv_name is None or recv_name.lstrip("_").lower() \
                not in _TELEMETRY_RECEIVERS:
            return None
        name = fn.attr
    elif isinstance(fn, ast.Name):
        name = fn.id
    else:
        return None
    name = name.lstrip("_")
    return name if name in _TELEMETRY_FNS else None


class ObsDiscipline:
    name = "obs-discipline"
    description = (
        "metric/event names at instrumentation sites must be string "
        "literals (the catalog must be greppable), and bare print() is "
        "not a log — use the event log or write to stderr explicitly"
    )

    def check(self, project: Project) -> Iterator[Finding]:
        for src in project.py_sources:
            tree = src.tree
            if tree is None:
                continue
            parts = src.path.parts
            is_plumbing = tuple(parts[-2:]) in _PLUMBING
            is_cli = src.path.name == "__main__.py"
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                if not is_plumbing:
                    yield from self._check_literal_name(src, node)
                if not is_cli:
                    yield from self._check_bare_print(src, node)
            if tuple(parts[-2:]) == _HEALTHZ_MODULE:
                yield from self._check_healthz_lockfree(src, tree)

    def _check_healthz_lockfree(self, src, tree) -> Iterator[Finding]:
        """The /healthz lock discipline (module docstring): any
        function whose name mentions healthz must not take a lock or
        make a device-dispatch-shaped call — reusing the hub-isolation
        vocabulary for what 'dispatch-shaped' means."""
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if "healthz" not in fn.name.lower():
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, ast.With) and \
                        any(_is_lock_ctx(i) for i in sub.items):
                    yield Finding(
                        path=str(src.path), line=sub.lineno,
                        rule=self.name,
                        message=(
                            f"{fn.name}() takes a lock: the /healthz "
                            "probe must stay lock-free — a wedged "
                            "engine holding that lock would wedge the "
                            "very probe meant to detect it (owners "
                            "expose lock-free admission_state views "
                            "instead)"),
                    )
                elif isinstance(sub, ast.Call):
                    offender = _dispatchy_call(sub)
                    if offender is not None:
                        yield Finding(
                            path=str(src.path), line=sub.lineno,
                            rule=self.name,
                            message=(
                                f"{offender}(...) in {fn.name}(): the "
                                "/healthz probe must never touch the "
                                "device or hub dispatch path — health "
                                "is read from already-maintained "
                                "state, not probed by new work"),
                        )

    def _check_literal_name(self, src, call: ast.Call) -> Iterator[Finding]:
        fn_name = _telemetry_fn_name(call)
        if fn_name is None or not call.args:
            return
        first = call.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return
        yield Finding(
            path=str(src.path),
            line=call.lineno,
            rule=self.name,
            message=(
                f"{fn_name}() called with a non-literal name: metric and "
                "event names must be string literals so the catalog in "
                "OBSERVABILITY.md stays greppable (a runtime-built name "
                "is an unauditable fork of the catalog)"
            ),
        )

    def _check_bare_print(self, src, call: ast.Call) -> Iterator[Finding]:
        fn = call.func
        if not (isinstance(fn, ast.Name) and fn.id == "print"):
            return
        if any(kw.arg == "file" for kw in call.keywords):
            return  # an explicit stream (stderr) is a deliberate choice
        yield Finding(
            path=str(src.path),
            line=call.lineno,
            rule=self.name,
            message=(
                "bare print() writes to stdout, which belongs to the "
                "wire/CLI protocol: emit a structured event "
                "(obs.events.emit) or pass file=sys.stderr explicitly"
            ),
        )
