"""The sidecar's scrape endpoint: read-only telemetry over stdlib HTTP.

A trimmed copy of ``dat_replication_protocol_tpu/obs/http.py``.  One
daemon thread runs a ``ThreadingHTTPServer`` with four read-only routes
over the snapshots ``--stats-fd`` writes; nothing here mutates session
state, launches a kernel or holds a session lock while rendering:

* ``GET /metrics``: Prometheus text (:func:`~.metrics.to_prom_text` of
  the live registry, labeled collector entries included);
* ``GET /snapshot``: the JSON stats record (the sidecar passes its
  ``snapshot_stats``, so the endpoint and ``--stats-fd`` serve the same
  dict);
* ``GET /healthz``: staged health (backend-init watchdog state from the
  event ring, admission from a lock-free callable such as
  ``ReplicationHub.admission_state``, the flight recorder and the obs
  gate); HTTP 200 when every stage is healthy, 503 otherwise.  It never
  takes a device or hub lock, so a wedged engine cannot wedge the probe;
* ``GET /events``: the tail of the event ring as JSONL (``?n=`` caps it,
  default 256).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from . import device as _device
from .events import EVENTS as _EVENTS
from .flight import FLIGHT as _FLIGHT
from .metrics import OBS as _OBS
from .metrics import REGISTRY as _REGISTRY
from .metrics import to_prom_text
from .watermarks import WATERMARKS as _WATERMARKS

__all__ = ["ObsHttpServer", "default_snapshot", "default_healthz",
           "DEFAULT_EVENTS_TAIL"]

DEFAULT_EVENTS_TAIL = 256
_MAX_EVENTS_TAIL = 4096


def default_snapshot() -> dict:
    """The core stats record for a process that is not the sidecar:
    registry, kernel sentinel, watermarks and ring health."""
    return {
        "ts": time.time(),
        "monotonic": time.monotonic(),
        "metrics": _REGISTRY.snapshot(),
        "events_dropped": _EVENTS.dropped,
        "jit_sites": _device.SENTINEL.snapshot(),
        "watermarks": _WATERMARKS.snapshot(),
    }


def default_healthz(admission_fn: Optional[Callable[[], dict]] = None
                    ) -> dict:
    """Staged health: each stage names a line of defense and whether it
    is degraded.  Everything read here is a plain attribute, the event
    ring (its own lock) or ``admission_fn``, which owners implement
    lock-free."""
    stages: dict = {}
    ok = True
    # backend init: stuck beats done beats in progress
    stuck = _EVENTS.last("backend.init.stuck")
    done = _EVENTS.last("backend.init.done")
    stage = _EVENTS.last("backend.init.stage")
    if stuck is not None and (done is None
                              or stuck["seq"] > done["seq"]):
        stages["backend_init"] = {"ok": False, "state": "stuck",
                                  **stuck.get("fields", {})}
        ok = False
    elif done is not None:
        stages["backend_init"] = {"ok": True, "state": "done",
                                  **done.get("fields", {})}
    elif stage is not None:
        stages["backend_init"] = {"ok": True, "state": "in-progress",
                                  **stage.get("fields", {})}
    else:
        stages["backend_init"] = {"ok": True, "state": "idle"}
    if admission_fn is not None:
        try:
            adm = admission_fn()
        except Exception as e:
            adm = {"open": False, "error": f"{type(e).__name__}: {e}"}
        stages["admission"] = {"ok": bool(adm.get("open")), **adm}
        ok = ok and bool(adm.get("open"))
    # event-loop lag: a live loop behind its tick is degraded
    loops = _WATERMARKS.loops_now()
    if loops:
        behind = sorted(name for name, rec in loops.items()
                        if rec.get("state") == "live"
                        and rec.get("behind"))
        lag = {name: rec.get("lag_s", 0.0) for name, rec in
               loops.items() if rec.get("state") == "live"}
        stages["loop_lag"] = {"ok": not behind, "behind": behind,
                              "lag_s": lag}
        ok = ok and not behind
    stages["flight_recorder"] = {"ok": True, "armed": _FLIGHT.armed}
    stages["obs_gate"] = {"ok": True, "on": _OBS.on}
    return {"ok": ok, "stages": stages, "ts": time.time(),
            "monotonic": time.monotonic()}


class _Handler(BaseHTTPRequestHandler):
    server_version = "dat-obs/1"
    protocol_version = "HTTP/1.1"
    # a scraper that connects and never sends releases its thread
    timeout = 30.0

    def log_message(self, fmt, *args):
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        try:
            url = urlparse(self.path)
            route = url.path.rstrip("/") or "/"
            if route == "/metrics":
                body = to_prom_text().encode("utf-8")
                self._send(200, body, "text/plain; version=0.0.4")
            elif route == "/snapshot":
                snap = self.server.obs_snapshot_fn()
                body = (json.dumps(snap, default=repr) + "\n").encode()
                self._send(200, body, "application/json")
            elif route == "/healthz":
                hz = self.server.obs_healthz_fn()
                body = (json.dumps(hz, default=repr) + "\n").encode()
                self._send(200 if hz.get("ok") else 503, body,
                           "application/json")
            elif route == "/events":
                n = DEFAULT_EVENTS_TAIL
                q = parse_qs(url.query)
                if "n" in q:
                    try:
                        n = max(1, min(_MAX_EVENTS_TAIL, int(q["n"][0])))
                    except ValueError:
                        pass
                tail = _EVENTS.events()[-n:]
                body = "".join(
                    json.dumps(r, default=repr) + "\n" for r in tail
                ).encode("utf-8")
                self._send(200, body, "application/x-ndjson")
            else:
                self._send(404, b'{"error": "unknown route"}\n',
                           "application/json")
        except Exception as e:  # a broken route must not kill the thread
            try:
                self._send(500, (json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}) + "\n").encode(),
                    "application/json")
            except Exception:
                pass


class ObsHttpServer:
    """The ``--obs-http`` endpoint: bind, serve on a daemon thread,
    close.  ``port=0`` binds an ephemeral port, ``self.port`` after
    construction."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 snapshot_fn: Optional[Callable[[], dict]] = None,
                 healthz_fn: Optional[Callable[[], dict]] = None,
                 admission_fn: Optional[Callable[[], dict]] = None):
        if healthz_fn is None:
            healthz_fn = lambda: default_healthz(admission_fn)  # noqa: E731
        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self._srv.obs_snapshot_fn = snapshot_fn or default_snapshot
        self._srv.obs_healthz_fn = healthz_fn
        self.host, self.port = self._srv.server_address[:2]
        self._thread: Optional[threading.Thread] = None
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ObsHttpServer":
        self._thread = threading.Thread(
            target=self._srv.serve_forever, name="obs-http", daemon=True,
            kwargs={"poll_interval": 0.1})
        self._thread.start()
        return self

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "ObsHttpServer":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.close()
