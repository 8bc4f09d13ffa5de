"""Flight recorder: atomic post-mortem bundles for offline attribution.

A trimmed copy of ``dat_replication_protocol_tpu/obs/flight.py``;
stdlib only.  When armed (a directory is set), a structured
:class:`~..wire.framing.ProtocolError` (every decoder error funnels
through ``Decoder._protocol_error``) or a stuck backend init dumps one
self-contained bundle, in the reference's layout, so the JAX package's
offline ``dump`` command reads it; so does a resumable session that
absorbed transport faults (``recovered``) or failed (``session-failed``)::

    bundle-<pid>-c<capture>-<seq>-<reason>/
        manifest.json   reason, wall and monotonic time, the structured
                        error (type/message/frame/offset/cause), the
                        session checkpoint, the fault plans noted,
                        extra fields, ring-drop accounting
        metrics.json    the registry snapshot
        events.jsonl    the event ring, one record per line
        spans.jsonl     the span ring

The bundle is written under a ``.tmp-`` name and renamed into place, so
no reader sees half of one.  Dumps are bounded (``max_bundles`` per
armed capture; routine dumps, such as a recovered session's, at half of
it) and deduplicated (one error object, one bundle).  The fault injector
(``session/faults.py``) notes each plan it runs with
:meth:`FlightRecorder.note_plan`, so the chaos coordinates ride the next
bundle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import weakref
from collections import deque
from typing import Optional

from . import events as _events
from . import metrics as _metrics
from . import tracing as _tracing

__all__ = ["FlightRecorder", "FLIGHT", "arm", "disarm", "dump",
           "read_bundle"]

DEFAULT_MAX_BUNDLES = 16
_PLAN_HISTORY = 8


def _slug(reason: str) -> str:
    return "".join(c if c.isalnum() else "-" for c in reason)[:40] or "dump"


def _write_json(path: str, obj) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, default=repr)


def _write_jsonl(path: str, records: list) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec, default=repr) + "\n")


class FlightRecorder:
    """Armed directory + dump budget; see the module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.dir: Optional[str] = None
        self.max_bundles = DEFAULT_MAX_BUNDLES
        self._seq = 0
        self._routine = 0  # routine dumps of this capture
        # bumped by every arm() and never reset, so re-arming into the
        # same directory cannot collide with a previous capture's names
        self._capture = 0
        # a weak ref: the recorder never pins an exception (and the
        # frames its traceback holds)
        self._last_error: Optional[weakref.ref] = None
        self._plans: deque = deque(maxlen=_PLAN_HISTORY)
        self.last_bundle: Optional[str] = None
        # dumps that produced no bundle: budget spent, duplicate error,
        # or a failed write
        self.suppressed = 0

    @property
    def armed(self) -> bool:
        return self.dir is not None

    def arm(self, directory: str,
            max_bundles: int = DEFAULT_MAX_BUNDLES) -> "FlightRecorder":
        """Start recording bundles into ``directory`` (created if
        missing) as a fresh capture: budget, dedup and sequence reset.
        Also turns the gate on: a dark ring has nothing worth dumping."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self.dir = directory
            self.max_bundles = max_bundles
            self._seq = 0
            self._routine = 0
            self._capture += 1
            self._last_error = None
            self.suppressed = 0
        _metrics.enable()
        return self

    def disarm(self) -> None:
        with self._lock:
            self.dir = None

    def note_plan(self, plan) -> None:
        """Record an active fault plan for the next bundle's manifest.
        No-op while disarmed."""
        if self.dir is None:
            return
        try:
            d = dataclasses.asdict(plan)
        except TypeError:
            d = {"repr": repr(plan)}
        with self._lock:
            self._plans.append(d)

    def dump(self, reason: str, *, error: Optional[BaseException] = None,
             checkpoint=None, extra: Optional[dict] = None,
             routine: bool = False) -> Optional[str]:
        """Write one bundle; returns its path, or None when disarmed, over
        budget, or the error object was already bundled.

        ``checkpoint`` (a :class:`~..session.resume.SessionCheckpoint` or
        a dict) goes into the manifest.  ``routine`` marks a non-failure
        dump (a recovered session's incident record): routine dumps are
        also capped at half of the budget, so a long-lived process that
        absorbs transient faults never spends the bundles kept for a
        genuine failure."""
        with self._lock:
            directory = self.dir
            if directory is None:
                return None
            last = (self._last_error() if self._last_error is not None
                    else None)
            if error is not None and error is last:
                self.suppressed += 1
                return None
            if self._seq >= self.max_bundles or (
                    routine and self._routine >= max(1, self.max_bundles // 2)):
                self.suppressed += 1
                return None
            seq = self._seq
            self._seq += 1
            if routine:
                self._routine += 1
            capture = self._capture
            if error is not None:
                try:
                    self._last_error = weakref.ref(error)
                except TypeError:
                    self._last_error = None
            plans = list(self._plans)
        name = f"bundle-{os.getpid()}-c{capture:02d}-{seq:04d}-{_slug(reason)}"
        final = os.path.join(directory, name)
        tmp = os.path.join(directory, f".tmp-{name}")
        manifest: dict = {
            "reason": reason,
            "ts": time.time(),
            "monotonic": time.monotonic(),
            "pid": os.getpid(),
            "fault_plans": plans,
            "events_dropped": _events.EVENTS.dropped,
            "spans_dropped": _tracing.SPANS.dropped,
        }
        if error is not None:
            cause = getattr(error, "cause", None)
            manifest["error"] = {
                "type": type(error).__name__,
                "message": str(error),
                "frame": getattr(error, "frame", None),
                "offset": getattr(error, "offset", None),
                "cause": (None if cause is None
                          else f"{type(cause).__name__}: {cause}"),
            }
        if checkpoint is not None:
            as_dict = getattr(checkpoint, "as_dict", None)
            manifest["checkpoint"] = (as_dict() if as_dict is not None
                                      else dict(checkpoint))
        if extra:
            manifest["extra"] = extra
        try:
            os.makedirs(tmp, exist_ok=True)
            _write_json(os.path.join(tmp, "manifest.json"), manifest)
            _write_json(os.path.join(tmp, "metrics.json"),
                        _metrics.snapshot())
            _write_jsonl(os.path.join(tmp, "events.jsonl"),
                         _events.EVENTS.events())
            _write_jsonl(os.path.join(tmp, "spans.jsonl"),
                         _tracing.SPANS.spans())
            os.rename(tmp, final)
        except OSError:
            # a full or vanished disk must never take the session down;
            # the loss is counted as a suppressed dump
            shutil.rmtree(tmp, ignore_errors=True)
            with self._lock:
                self.suppressed += 1
            return None
        self.last_bundle = final
        if _metrics.OBS.on:
            _events.emit("flight.dump", reason=reason, bundle=name)
        return final

    def _reset_for_tests(self) -> None:
        with self._lock:
            self.dir = None
            self._seq = 0
            self._routine = 0
            self._last_error = None
            self._plans.clear()
            self.last_bundle = None
            self.suppressed = 0


FLIGHT = FlightRecorder()


def arm(directory: str, **kwargs) -> FlightRecorder:
    """Arm the process-global flight recorder."""
    return FLIGHT.arm(directory, **kwargs)


def disarm() -> None:
    FLIGHT.disarm()


def dump(reason: str, **kwargs) -> Optional[str]:
    """Dump one bundle from the process-global recorder (if armed)."""
    return FLIGHT.dump(reason, **kwargs)


def read_bundle(path: str) -> dict:
    """Load every part of a bundle directory into one dict."""
    out: dict = {"path": path}
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        out["manifest"] = json.load(f)
    with open(os.path.join(path, "metrics.json"), encoding="utf-8") as f:
        out["metrics"] = json.load(f)
    for part in ("events", "spans"):
        records = []
        with open(os.path.join(path, f"{part}.jsonl"),
                  encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip()
                if ln:
                    records.append(json.loads(ln))
        out[part] = records
    return out
