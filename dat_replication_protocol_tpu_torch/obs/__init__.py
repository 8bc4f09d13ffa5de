"""obs — telemetry of the port: metrics, events, spans, flight recorder.

The counterpart of ``dat_replication_protocol_tpu/obs/`` (its core):

* :mod:`.metrics` — counters, gauges and histograms in a process-global
  registry behind one gate (``OBS.on``, off until :func:`enable`): a
  disabled site is one attribute load.  ``to_prom_text`` renders a
  snapshot as Prometheus text.
* :mod:`.events` — a bounded ring of structured events with an fd or
  JSONL sink, and :class:`DeferredEmitQueue` for events raised under a
  lock.
* :mod:`.tracing` — nestable spans, per-frame instants keyed on the wire
  offset, Chrome trace export.
* :mod:`.flight` — post-mortem bundles on a protocol error or a stuck
  backend init, when armed.
* :mod:`.device` — the kernel sentinel (:func:`kernel_site`: launches
  and launch shapes per call site), engine attribution, device memory
  gauges and the backend-init watchdog.
* :mod:`.loopprof` — the edge loop's per-turn phase accounting, loop
  lag and sampling turn profiler (:class:`LoopProfiler`).
* :mod:`.propagation` — the gossip mesh's convergence plane: one
  ``gossip.exchange`` span an exchange and direction, per-link
  divergence watermarks and the frontier gauges (:data:`PROPAGATION`).
* :mod:`.fleet` — the fleet aggregator: N targets (``--obs-http``
  endpoints, ``--stats-fd`` JSONL files, callables) joined into per-link
  lag, gossip convergence, the mesh matrix, wire cost and loop lag; the
  dashboard and the declarative SLO gate.

Offline CLI: ``python -m dat_replication_protocol_tpu_torch.obs``
(:mod:`.__main__`) runs ``fleet``, ``timeline``, ``export-trace``,
``dump``, ``loopdoctor``, ``meshdoctor`` and ``costdoctor`` over logs,
bundles and endpoints.  ``fleet`` and the CLI are imported as
submodules, so importing this package does not load them.

Names of counters, events and spans are the reference's
(``OBSERVABILITY.md``), so either package's offline tools read the
other's logs.  ``metrics``, ``events``, ``tracing``, ``flight``,
``loopprof``, ``propagation`` and ``fleet`` use the standard
library only; ``device`` reads ``torch`` only if the process already
loaded it.
"""

from __future__ import annotations

from .device import (
    SENTINEL,
    BackendInitWatchdog,
    KernelSentinel,
    RecompileBudget,
    kernel_site,
    note_engine,
    reset_engine_notes,
    sample_device_gauges,
)
from .events import EVENTS, DeferredEmitQueue, EventLog, emit
from .flight import FLIGHT, FlightRecorder, read_bundle
from .loopprof import PHASES, LoopProfiler
from .metrics import (
    OBS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    counter,
    disable,
    enable,
    gauge,
    histogram,
    snapshot,
    to_prom_text,
)
from .propagation import PROPAGATION, PropagationBoard
from .tracing import (
    SPANS,
    SpanLog,
    attach_jsonl_sink,
    export_chrome_trace,
    to_chrome_trace,
    trace_instant,
    trace_span,
)
from .watermarks import WATERMARKS, WatermarkBoard, link_lag

__all__ = [
    "OBS",
    "REGISTRY",
    "EVENTS",
    "SPANS",
    "FLIGHT",
    "PROPAGATION",
    "PropagationBoard",
    "EventLog",
    "DeferredEmitQueue",
    "SpanLog",
    "FlightRecorder",
    "LoopProfiler",
    "PHASES",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "to_prom_text",
    "emit",
    "enable",
    "disable",
    "trace_span",
    "trace_instant",
    "to_chrome_trace",
    "export_chrome_trace",
    "attach_jsonl_sink",
    "read_bundle",
    "SENTINEL",
    "KernelSentinel",
    "RecompileBudget",
    "BackendInitWatchdog",
    "kernel_site",
    "note_engine",
    "reset_engine_notes",
    "sample_device_gauges",
    "WATERMARKS",
    "WatermarkBoard",
    "link_lag",
]
