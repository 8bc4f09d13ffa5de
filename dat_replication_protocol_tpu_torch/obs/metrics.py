"""Metrics core: counters, gauges, histograms behind one gate.

A trimmed copy of ``dat_replication_protocol_tpu/obs/metrics.py``;
stdlib only.

* **The disabled path is one attribute load.**  Instrumentation sites
  hold a metric handle created at module import and guard with
  ``if _OBS.on:``: no registry lookup, no allocation, no call while
  telemetry is off.  ``OBS`` is a one-slot object, so the check is
  LOAD_GLOBAL + LOAD_ATTR + POP_JUMP.
* **The gate starts off and nothing but a call turns it on.**  The
  reference also seeds it from its ``DAT_OBS`` variable; the port reads
  no environment, so callers use :func:`enable` (the sidecar's
  ``--trace-jsonl`` and ``--flight-dir`` do, tests do).
* **The enabled path favors correctness over nanoseconds.**  Every
  mutation takes the metric's lock: digest callbacks and mesh ranks run
  on other threads, and ``x += 1`` is a read-modify-write.
* **Snapshots are plain dicts**, JSON-able as they are, in the
  reference's shape, so its offline tools read them unchanged.

Histograms keep fixed-bucket counts and a ring of recent observations,
so ``snapshot()`` reports approximate quantiles of the recent window in
bounded memory.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Optional, Sequence

__all__ = [
    "OBS",
    "REGISTRY",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "to_prom_text",
    "enable",
    "disable",
]


class _Gate:
    """The hoisted enable gate.  One mutable slot; instrumentation sites
    read ``OBS.on`` and nothing else."""

    __slots__ = ("on",)

    def __init__(self) -> None:
        self.on = False


OBS = _Gate()


def enable() -> None:
    """Turn telemetry on process-wide (idempotent)."""
    OBS.on = True


def disable() -> None:
    OBS.on = False


class Counter:
    """Monotonic counter; ``inc`` under the lock."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        return self._value

    def _reset(self) -> None:
        with self._lock:
            self._value = 0.0


# Upper edges are inclusive (observe(x) lands in the first bucket with
# x <= edge), with an implicit +inf overflow bucket.
DEFAULT_BUCKETS = (
    1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0,
)

DEFAULT_RING = 256


class Histogram:
    """Fixed buckets plus a ring of the most recent ``ring`` raw
    observations (older ones are overwritten)."""

    __slots__ = ("name", "buckets", "_lock", "_counts", "_count", "_sum",
                 "_ring", "_ring_n")

    def __init__(self, name: str,
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 ring: int = DEFAULT_RING):
        if list(buckets) != sorted(buckets) or len(set(buckets)) != len(
                tuple(buckets)):
            raise ValueError("histogram buckets must be sorted and unique")
        if ring < 1:
            raise ValueError("ring size must be >= 1")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1: +inf overflow
        self._count = 0
        self._sum = 0.0
        self._ring: list[float] = [0.0] * ring
        self._ring_n = 0  # observations ever; ring index = n % len

    def observe(self, v: float) -> None:
        with self._lock:
            i = 0
            buckets = self.buckets
            n = len(buckets)
            while i < n and v > buckets[i]:
                i += 1
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            ring = self._ring
            ring[self._ring_n % len(ring)] = v
            self._ring_n += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> Optional[float]:
        """Approximate ``q``-quantile (0..1) over the ring window, or
        None before the first observation (nearest rank)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile must be in [0, 1]")
        with self._lock:
            n = min(self._ring_n, len(self._ring))
            if n == 0:
                return None
            window = sorted(self._ring[:n])
        rank = min(n - 1, max(0, math.ceil(q * n) - 1))
        return window[rank]

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._count = 0
            self._sum = 0.0
            self._ring_n = 0

    def _snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count = self._count
            total = self._sum
            n = min(self._ring_n, len(self._ring))
            window = sorted(self._ring[:n])

        def q(frac: float) -> Optional[float]:
            if not window:
                return None
            rank = min(len(window) - 1,
                       max(0, math.ceil(frac * len(window)) - 1))
            return window[rank]

        return {
            "count": count,
            "sum": total,
            "buckets": [[le, c] for le, c in zip(self.buckets, counts)]
            + [["+inf", counts[-1]]],
            "p50": q(0.50),
            "p90": q(0.90),
            "p99": q(0.99),
        }


class Registry:
    """Name -> metric, process-global.  Get-or-create is idempotent, so
    any module can hoist a handle at import; a name registered twice
    with a different type raises.

    Collectors are snapshot-time callables returning ``{"counters":
    {...}, "gauges": {...}}`` for entities alive right now (labeled
    names such as ``x{session=k}``); their entries merge into
    ``snapshot()`` and vanish with their owner.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}
        self._collectors: dict[str, object] = {}

    def _get(self, name: str, cls, *args, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                # ``cls`` is always one of this module's metric classes
                # (the three public wrappers are the only callers): a
                # cheap pure constructor, not user code, so building it
                # under the registry lock cannot block or re-enter
                # datlint: allow-blocking-under-lock(callback)
                m = cls(name, *args, **kwargs)
                self._metrics[name] = m
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  ring: int = DEFAULT_RING) -> Histogram:
        h = self._get(name, Histogram, buckets, ring)
        # a second registration with other edges would silently get the
        # first caller's buckets
        if h.buckets != tuple(float(b) for b in buckets) \
                or len(h._ring) != ring:
            raise ValueError(
                f"histogram {name!r} already registered with different "
                f"buckets/ring")
        return h

    def register_collector(self, name: str, fn) -> None:
        """Attach a snapshot-time collector; re-registering a name
        replaces it."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str, fn=None) -> None:
        """Remove a collector; with ``fn`` only if it is still the one
        registered under ``name``."""
        with self._lock:
            if fn is None or self._collectors.get(name) is fn:
                self._collectors.pop(name, None)

    def snapshot(self) -> dict:
        """Plain-dict view of every registered metric (JSON-able)."""
        with self._lock:
            metrics = list(self._metrics.values())
            collectors = list(self._collectors.values())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][m.name] = m._snapshot()
        for fn in collectors:
            try:
                contributed = fn()
            except Exception:
                # a dying collector must not take the snapshot down
                continue
            for section in ("counters", "gauges"):
                out[section].update(contributed.get(section, {}))
        return out

    def reset(self) -> None:
        """Zero every metric's value, keeping the registrations (and the
        handles sites hoisted); drop the collectors, which hold live
        owner state."""
        with self._lock:
            metrics = list(self._metrics.values())
            self._collectors.clear()
        for m in metrics:
            m._reset()


REGISTRY = Registry()


def counter(name: str) -> Counter:
    """Get-or-create a counter in the process-global registry."""
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = DEFAULT_BUCKETS,
              ring: int = DEFAULT_RING) -> Histogram:
    return REGISTRY.histogram(name, buckets, ring)


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- Prometheus text exposition ----------------------------------------------

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    """Catalog name -> Prometheus name: dots become underscores, under
    ``dat_`` (``decoder.blob.bytes`` -> ``dat_decoder_blob_bytes``)."""
    return "dat_" + _PROM_SANITIZE.sub("_", name)


def _prom_series(name: str) -> str:
    """Series name of one snapshot entry: a labeled collector entry
    (``x{session=k1}``) becomes a label set (``dat_x{session="k1"}``)."""
    if "{" not in name or not name.endswith("}"):
        return _prom_name(name)
    base, _, labels = name[:-1].partition("{")
    pairs = []
    for part in labels.split(","):
        k, _, v = part.partition("=")
        v = v.replace("\\", "\\\\").replace('"', '\\"') \
             .replace("\n", "\\n")
        pairs.append(f'{_PROM_SANITIZE.sub("_", k.strip())}="{v}"')
    return _prom_name(base) + "{" + ",".join(pairs) + "}"


def _prom_num(v) -> str:
    if isinstance(v, float):
        if v != v:  # NaN
            return "NaN"
        if v in (float("inf"), float("-inf")):
            return "+Inf" if v > 0 else "-Inf"
        return repr(v)
    return str(v)


def to_prom_text(snap: Optional[dict] = None) -> str:
    """Prometheus text exposition (v0.0.4) of a registry snapshot
    (default: the live registry).  Histograms emit cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``."""
    if snap is None:
        snap = REGISTRY.snapshot()
    lines: list[str] = []

    def emit_section(section: str, kind: str) -> None:
        # one TYPE line per metric name, however many label sets
        typed: set = set()
        for name, v in sorted(snap.get(section, {}).items()):
            n = _prom_series(name)
            base = n.partition("{")[0]
            if base not in typed:
                typed.add(base)
                lines.append(f"# TYPE {base} {kind}")
            lines.append(f"{n} {_prom_num(v)}")

    emit_section("counters", "counter")
    emit_section("gauges", "gauge")
    for name, h in sorted(snap.get("histograms", {}).items()):
        n = _prom_name(name)
        lines.append(f"# TYPE {n} histogram")
        cum = 0
        for le, count in h["buckets"]:
            cum += count
            label = "+Inf" if le == "+inf" else _prom_num(float(le))
            lines.append(f'{n}_bucket{{le="{label}"}} {cum}')
        lines.append(f"{n}_sum {_prom_num(float(h['sum']))}")
        lines.append(f"{n}_count {h['count']}")
    return "\n".join(lines) + "\n"
