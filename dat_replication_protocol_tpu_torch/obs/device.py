"""Device-path telemetry: the kernel sentinel and the backend-init watchdog.

The counterpart of ``dat_replication_protocol_tpu/obs/device.py``.  It
never imports ``torch``: it reads the module only if the process has
already loaded it, and never initializes CUDA.

* **Kernel sentinel** — :func:`kernel_site` wraps a kernel wrapper (or a
  ported function that mirrors a reference ``jit_site``) under a named
  call site.  With the gate on, each call counts in
  ``device.jit.calls``, and each call with an argument-shape signature
  the site has not seen counts in ``device.jit.traces`` with a
  ``device.jit.trace`` event: the reference's path for callables without
  a jit cache.  The port compiles each kernel once with ``nvcc``; the
  hazard left is a site that keeps meeting new launch shapes, so
  ``calls`` counts launches and ``traces`` launch shapes.  A site whose
  wrapper sizes its grid by an item count, and whose host callers bucket
  the rest, passes a ``key`` that keeps only the bucketed dimensions:
  then only a shape off the ladder is a new signature.  A site past
  :data:`DEFAULT_RECOMPILE_BUDGET` signatures emits
  ``device.jit.recompile_budget`` once.  Calls made while the current
  stream is capturing a CUDA graph run once per replay, not once per
  call, so they bypass accounting (the reference's counterpart skips
  calls made while an outer jit traces).
* **Backend-init watchdog** — :class:`BackendInitWatchdog` wraps bring-up
  in a ``backend.init`` span with staged progress events
  (``platform_probe`` -> ``first_device_call`` -> ``first_compile``) and
  a deadline; on expiry it emits ``backend.init.stuck`` naming the stage
  and dumps a flight bundle, then samples the gauges.
* **Device gauges / engine attribution** — :func:`sample_device_gauges`
  sets ``device.mem.bytes_in_use`` (``torch.cuda.memory_allocated()``)
  and ``device.mem.live_buffers`` (the caching allocator's
  ``active.all.current``) only when CUDA is already initialized;
  :func:`note_engine` records ``device.engine.select`` when a routing
  choice changes.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional

from . import flight as _flight
from . import tracing as _tracing
from .events import emit as _emit
from .metrics import OBS as _OBS
from .metrics import counter as _counter
from .metrics import gauge as _gauge

__all__ = [
    "SENTINEL",
    "KernelSentinel",
    "RecompileBudget",
    "BackendInitWatchdog",
    "INIT_STAGES",
    "kernel_site",
    "rows_key",
    "note_engine",
    "reset_engine_notes",
    "sample_device_gauges",
    "DEFAULT_RECOMPILE_BUDGET",
]

# launches and launch shapes across all sites (per site: SENTINEL)
_M_JIT_CALLS = _counter("device.jit.calls")
_M_JIT_TRACES = _counter("device.jit.traces")
_G_LIVE_BUFFERS = _gauge("device.mem.live_buffers")
_G_BYTES_IN_USE = _gauge("device.mem.bytes_in_use")

# signatures per site before the sentinel flags it: room for the
# power-of-two bucket ladder, small enough to catch an unbucketed stream
DEFAULT_RECOMPILE_BUDGET = 8

# retained signatures per site are bounded; past the cap an unseen
# signature still counts, it is just not kept
_MAX_RETAINED_SIGS = 256


def _sig_of(v) -> object:
    shape = getattr(v, "shape", None)
    if shape is not None:
        return (tuple(shape), str(getattr(v, "dtype", "")))
    if isinstance(v, (bool, int, float, str, bytes, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        return (type(v).__name__,) + tuple(_sig_of(x) for x in v)
    return type(v).__name__


def _signature(args: tuple, kwargs: dict) -> tuple:
    """Hashable signature of one call: shapes and dtypes of array-likes,
    values of scalars."""
    sig = tuple(_sig_of(a) for a in args)
    if kwargs:
        sig += tuple((k, _sig_of(kwargs[k])) for k in sorted(kwargs))
    return sig


def _sig_str(sig: tuple) -> str:
    """Compact display form for events ("(8, 16)torch.int32" style)."""

    def one(p) -> str:
        if isinstance(p, tuple) and len(p) == 2 and isinstance(p[0], tuple):
            return f"{p[0]}{p[1]}"
        return repr(p)

    return ",".join(one(p) for p in sig)


class _SiteStats:
    """Per-site aggregate, shared by every wrapper under one name."""

    __slots__ = ("name", "lock", "calls", "traces", "sigs", "flagged",
                 "last_signature")

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.Lock()
        self.calls = 0
        self.traces = 0
        self.sigs: set = set()
        self.flagged = False
        self.last_signature: Optional[str] = None


class KernelSentinel:
    """Process-global per-site call and signature accounting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: dict[str, _SiteStats] = {}

    def _stats(self, name: str) -> _SiteStats:
        with self._lock:
            st = self._sites.get(name)
            if st is None:
                st = self._sites[name] = _SiteStats(name)
            return st

    def snapshot(self) -> dict:
        """``{site: {"calls": n, "traces": n}}`` of every site called."""
        with self._lock:
            sites = list(self._sites.values())
        out = {}
        for st in sites:
            with st.lock:
                if st.calls:
                    out[st.name] = {"calls": st.calls, "traces": st.traces}
        return out

    def over_budget(self, limit: int = DEFAULT_RECOMPILE_BUDGET) -> list[dict]:
        """Sites whose signature count exceeds ``limit``, worst first."""
        out = [{"site": name, **rec} for name, rec in self.snapshot().items()
               if rec["traces"] > limit]
        out.sort(key=lambda r: -r["traces"])
        return out

    def reset_for_tests(self) -> None:
        """Zero every site in place, keeping the stats objects that
        module-level wrappers hold."""
        with self._lock:
            sites = list(self._sites.values())
        for st in sites:
            with st.lock:
                st.calls = 0
                st.traces = 0
                st.sigs.clear()
                st.flagged = False
                st.last_signature = None


SENTINEL = KernelSentinel()


class RecompileBudget:
    """The enforceable face of the sentinel: ``check()`` returns every
    site past ``limit`` signatures (empty = healthy)."""

    def __init__(self, limit: int = DEFAULT_RECOMPILE_BUDGET,
                 sentinel: KernelSentinel = SENTINEL):
        if limit < 1:
            raise ValueError("recompile budget must be >= 1")
        self.limit = limit
        self._sentinel = sentinel

    def check(self) -> list[dict]:
        return self._sentinel.over_budget(self.limit)

    def ok(self) -> bool:
        return not self.check()


def _capturing() -> bool:
    """True while the current CUDA stream captures a graph.  Never
    initializes CUDA: a process that has not, cannot be capturing."""
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        return (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())
    except Exception:
        return False


class _KernelSite:
    """The wrapper :func:`kernel_site` returns.  Disabled path: one gate
    attribute load, then the wrapped callable.  Attribute reads and
    writes it does not own go to the wrapped callable, so a wrapper's
    own launch counters (``.launches`` and its breakdowns) stay where
    they were."""

    __slots__ = ("_fn", "_stats", "_key")

    def __init__(self, name: str, fn: Callable, key: Optional[Callable]):
        object.__setattr__(self, "_fn", fn)
        object.__setattr__(self, "_stats", SENTINEL._stats(name))
        object.__setattr__(self, "_key", key)

    @property
    def site(self) -> str:
        return self._stats.name

    @property
    def __wrapped__(self) -> Callable:
        return self._fn

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __setattr__(self, name, value) -> None:
        setattr(self._fn, name, value)

    def __call__(self, *args, **kwargs):
        if not _OBS.on:
            return self._fn(*args, **kwargs)
        if _capturing():
            return self._fn(*args, **kwargs)
        out = self._fn(*args, **kwargs)
        sig = (_signature(args, kwargs) if self._key is None
               else self._key(*args, **kwargs))
        st = self._stats
        with st.lock:
            st.calls += 1
            traced = sig not in st.sigs
            if traced and len(st.sigs) < _MAX_RETAINED_SIGS:
                st.sigs.add(sig)
            if traced:
                st.traces += 1
                traces = st.traces
                st.last_signature = _sig_str(sig)
                flag = traces > DEFAULT_RECOMPILE_BUDGET and not st.flagged
                if flag:
                    st.flagged = True
        _M_JIT_CALLS.inc()
        if traced:
            _M_JIT_TRACES.inc()
            _emit("device.jit.trace", site=st.name, signature=_sig_str(sig),
                  traces=traces)
            if flag:
                # once per site per process, however long it runs
                _emit("device.jit.recompile_budget", site=st.name,
                      traces=traces, budget=DEFAULT_RECOMPILE_BUDGET,
                      signature=_sig_str(sig))
        return out


def rows_key(index: int = 0) -> Callable:
    """A :func:`kernel_site` ``key`` for a wrapper whose argument
    ``index`` holds one row an item: that argument's shape with the row
    count elided, and its dtype."""

    def key(*args, **kwargs) -> tuple:
        t = args[index]
        return (((None,) + tuple(t.shape[1:]), str(t.dtype)),)

    return key


def kernel_site(name: str, fn: Callable,
                key: Optional[Callable] = None) -> _KernelSite:
    """Register ``fn`` as the named call site and return the sentinel
    wrapper.  ``name`` is a dot-separated literal naming the port's
    module (``ops.blake2b_cuda.packed``).  ``key``, given the call's
    arguments, returns its signature in place of every argument's shape
    and dtype: the dimensions the host buckets, without the item count
    that only sizes the grid."""
    return _KernelSite(name, fn, key)


# -- engine-selection attribution ---------------------------------------------

# last engine noted per component: the event records changes only
_engine_lock = threading.Lock()
_engine_last: dict = {}


def note_engine(component: str, engine: str, key=None, **fields) -> None:
    """Record ``device.engine.select`` when ``component``'s engine
    changes.  ``key`` widens the memo for choices made per shape (B1's
    variant per block-count bucket).  Call sites guard with
    ``if _OBS.on:``; this function does not re-check the gate."""
    memo = component if key is None else (component, key)
    with _engine_lock:
        if _engine_last.get(memo) == engine:
            return
        _engine_last[memo] = engine
    _emit("device.engine.select", component=component, engine=engine,
          **fields)


def reset_engine_notes() -> None:
    """Forget the change-only memo, so the next dispatch re-emits every
    component's choice (capture boundaries clear it with the rings)."""
    with _engine_lock:
        _engine_last.clear()


# -- device memory gauges -----------------------------------------------------


def sample_device_gauges() -> bool:
    """Set ``device.mem.bytes_in_use`` and ``device.mem.live_buffers``
    from an already-initialized CUDA context; True when a sample was
    taken.  Never initializes CUDA itself."""
    if not _OBS.on:
        return False
    torch = sys.modules.get("torch")
    if torch is None:
        return False
    try:
        if not torch.cuda.is_initialized():
            return False
        _G_BYTES_IN_USE.set(float(torch.cuda.memory_allocated()))
        stats = torch.cuda.memory_stats()
        _G_LIVE_BUFFERS.set(float(stats.get("active.all.current", 0)))
        return True
    except Exception:
        return False


# -- backend-init watchdog ----------------------------------------------------

# the canonical stage ladder (callers may add stages between)
INIT_STAGES = ("platform_probe", "first_device_call", "first_compile")


class BackendInitWatchdog:
    """Deadline and staged progress around backend bring-up::

        with BackendInitWatchdog(deadline_s=600) as wd:
            wd.stage("platform_probe")
            torch.cuda.is_available(); torch.cuda.get_device_name(0)
            wd.stage("first_device_call")
            torch.ones(1, device="cuda")
            wd.stage("first_compile")
            ops._build.build()

    Each ``stage()`` emits ``backend.init.stage`` and samples the gauges.
    If the deadline expires before ``__exit__``, the timer thread emits
    ``backend.init.stuck`` naming the stage and dumps a flight bundle
    (reason ``backend-init-stuck``, when armed) whose manifest ``extra``
    carries the stage, elapsed seconds and the timeline.  The watchdog
    only observes: the init keeps running."""

    def __init__(self, deadline_s: float = 90.0):
        if deadline_s <= 0:
            raise ValueError("deadline must be positive")
        self.deadline_s = deadline_s
        self.fired = False
        self.finished = False
        self.stages: list[tuple[str, float]] = []  # (name, elapsed_s)
        self._lock = threading.Lock()
        self._t0 = 0.0
        self._timer: Optional[threading.Timer] = None
        self._span = None

    @property
    def current_stage(self) -> Optional[str]:
        with self._lock:
            return self.stages[-1][0] if self.stages else None

    @property
    def elapsed_s(self) -> float:
        return time.monotonic() - self._t0

    def __enter__(self) -> "BackendInitWatchdog":
        self._t0 = time.monotonic()
        self._span = _tracing.trace_span("backend.init",
                                         deadline_s=self.deadline_s)
        self._span.__enter__()
        self._timer = threading.Timer(self.deadline_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def stage(self, name: str) -> None:
        """Enter a named init stage."""
        elapsed = self.elapsed_s
        with self._lock:
            self.stages.append((name, round(elapsed, 3)))
        if _OBS.on:
            _emit("backend.init.stage", stage=name,
                  elapsed_s=round(elapsed, 3))
        sample_device_gauges()

    def _fire(self) -> None:
        with self._lock:
            if self.finished:
                return
            self.fired = True
            stage = self.stages[-1][0] if self.stages else None
            timeline = list(self.stages)
        elapsed = round(self.elapsed_s, 3)
        if _OBS.on:
            _emit("backend.init.stuck", stage=stage, elapsed_s=elapsed,
                  deadline_s=self.deadline_s)
        # bundle first: sampling talks to the backend that just proved
        # itself stuck and may block this thread
        _flight.dump(
            "backend-init-stuck",
            extra={"stage": stage, "elapsed_s": elapsed,
                   "deadline_s": self.deadline_s,
                   "stages": [{"stage": s, "at_s": at} for s, at in timeline]},
        )
        sample_device_gauges()

    def __exit__(self, exc_type, exc, tb) -> bool:
        with self._lock:
            self.finished = True
        if self._timer is not None:
            self._timer.cancel()
            # an init finishing right at the deadline races a _fire past
            # its check: joining makes the order deterministic
            if self._timer.is_alive():
                self._timer.join(timeout=2.0)
        if _OBS.on:
            _emit("backend.init.done", elapsed_s=round(self.elapsed_s, 3),
                  stages=len(self.stages), stuck=self.fired,
                  error=(exc_type.__name__ if exc_type else None))
        sample_device_gauges()
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
        return False
