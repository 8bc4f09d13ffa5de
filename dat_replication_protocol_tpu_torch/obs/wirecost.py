"""Wire cost ledger: per-link bytes by frame class, and their watermarks.

A trimmed copy of ``dat_replication_protocol_tpu/obs/wirecost.py``;
stdlib only.  Every wire byte on a directed link (``link``, ``tx`` or
``rx``) is attributed to exactly one frame class, with its payload and
framing bytes apart, at the existing choke points:

* the encoder's frame builds (``session/encoder.py``): tx;
* the decoder's frame deliveries (``session/decoder.py``): rx;
* the pump's reads and writes (``session/pump.py``): the transport's
  byte count, the ground truth the ledger is audited against.

The ledger tiles the wire: the per-class bytes (payload + framing) of a
link sum to its transport bytes, so the unattributed residual is 0 at
the end of a session.  ``residual_bytes`` is None until the transport
reports (unknown is not zero).

Frame classes: ``change``, ``change_batch``, ``blob``, ``reconcile``,
``snapshot``; ``framing`` is the export's sum of header bytes.  Derived
per link: ``goodput_fraction`` (payload / total), ``overhead_ratio``
(framing / total), ``batch_saved_bytes``, ``reconcile_wire_per_diff_byte``,
``snapshot_cold_ratio``, ``residual_bytes``; per fan-out link
``amplification`` (delivered over published bytes).  The collector
exports them as the reference's labeled ``wire.cost.*`` counters and
gauges; a watermark whose denominator is unknown is skipped, not
exported as 0.

Nothing here runs unless ``OBS.on``: every instrumented site forks once
on the gate into a ``_lit_cost_*`` helper, so the disabled path never
names this module.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .metrics import REGISTRY as _REGISTRY

__all__ = [
    "WIRECOST",
    "WireCostBoard",
    "CLASSES",
    "account",
    "note_saved",
    "note_diff",
    "note_dataset",
    "note_source",
    "note_delivered",
    "note_transport",
    "note_failure",
]

CLASSES = ("change", "change_batch", "blob", "reconcile", "snapshot")

_DIRS = ("tx", "rx")


def _new_rec(now: float) -> dict:
    return {
        # cls -> {"payload": int, "framing": int, "frames": int}
        "classes": {},
        # the transport's bytes; 0 = not reporting, residual stays None
        "transport": 0,
        "saved": 0,
        "diff_bytes": None,
        "dataset_bytes": None,
        "failures": 0,
        "error": None,
        "_mono": now,
    }


class WireCostBoard:
    """The process-global per-(link, direction) byte ledger and the
    fan-out amplification inputs; the instance is :data:`WIRECOST`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # datlint: guarded-by(self._lock): self._links, self._amp
        # (link, dir) -> ledger record, stamped on the monotonic clock
        self._links: dict[tuple, dict] = {}
        # link -> {"source": int, "delivered": {peer: int}}
        self._amp: dict[str, dict] = {}
        self._collector_fn = self._collect

    def _rec_locked(self, link: str, direction: str, now: float) -> dict:
        rec = self._links.setdefault((link, direction), _new_rec(now))
        rec["_mono"] = now
        return rec

    # -- recording -----------------------------------------------------------

    def account(self, cls: str, link: str, direction: str,
                payload_len: int, framing_len: int,
                frames: int = 1) -> None:
        """Attribute one frame, or a run of ``frames`` frames (lengths
        are the run's totals), to a class on a directed link."""
        if cls not in CLASSES:
            raise ValueError(f"unknown wire cost class: {cls!r}")
        if direction not in _DIRS:
            raise ValueError(f"unknown wire cost direction: {direction!r}")
        with self._lock:
            rec = self._rec_locked(link, direction, time.monotonic())
            c = rec["classes"].setdefault(
                cls, {"payload": 0, "framing": 0, "frames": 0})
            c["payload"] += int(payload_len)
            c["framing"] += int(framing_len)
            c["frames"] += int(frames)
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_saved(self, link: str, direction: str, saved: int) -> None:
        """Bytes a batch frame saved against the same rows per record
        (both ends run the same arithmetic, so they agree)."""
        with self._lock:
            self._rec_locked(link, direction,
                             time.monotonic())["saved"] += int(saved)
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_diff(self, link: str, direction: str,
                  diff_bytes: int) -> None:
        """Diff bytes a completed reconcile delivered: the denominator of
        ``reconcile_wire_per_diff_byte``."""
        with self._lock:
            rec = self._rec_locked(link, direction, time.monotonic())
            rec["diff_bytes"] = (rec["diff_bytes"] or 0) + int(diff_bytes)
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_dataset(self, link: str, direction: str,
                     dataset_bytes: int) -> None:
        """Dataset bytes a snapshot bootstrap covered: the denominator of
        ``snapshot_cold_ratio``."""
        with self._lock:
            rec = self._rec_locked(link, direction, time.monotonic())
            rec["dataset_bytes"] = ((rec["dataset_bytes"] or 0)
                                    + int(dataset_bytes))
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_source(self, link: str, nbytes: int) -> None:
        """Source bytes published into a fan-out link."""
        with self._lock:
            amp = self._amp.setdefault(link, {"source": 0, "delivered": {}})
            amp["source"] += int(nbytes)
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_delivered(self, link: str, peer: str, nbytes: int) -> None:
        """Bytes a fan-out link delivered to one peer."""
        with self._lock:
            amp = self._amp.setdefault(link, {"source": 0, "delivered": {}})
            amp["delivered"][peer] = (amp["delivered"].get(peer, 0)
                                      + int(nbytes))
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_transport(self, link: str, direction: str,
                       nbytes: int) -> None:
        """The transport's bytes on a directed link, which the ledger is
        audited against."""
        with self._lock:
            self._rec_locked(link, direction,
                             time.monotonic())["transport"] += int(nbytes)
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    def note_failure(self, link: str, direction: str,
                     error: Optional[str] = None) -> None:
        """A wire fault on a directed link: the watermarks keep their
        last values; only the failure count and the error move."""
        with self._lock:
            rec = self._rec_locked(link, direction, time.monotonic())
            rec["failures"] += 1
            if error is not None:
                rec["error"] = error
        _REGISTRY.register_collector("wirecost", self._collector_fn)

    # -- export --------------------------------------------------------------

    @staticmethod
    def _watermarks(rec: dict) -> dict:
        """Derived per-ledger watermarks; None where a denominator is not
        known yet."""
        payload = sum(c["payload"] for c in rec["classes"].values())
        framing = sum(c["framing"] for c in rec["classes"].values())
        total = payload + framing
        wm = {
            "ledger_bytes": total,
            "payload_bytes": payload,
            "framing_bytes": framing,
            "goodput_fraction": (payload / total) if total else None,
            "overhead_ratio": (framing / total) if total else None,
            "batch_saved_bytes": rec["saved"],
            "residual_bytes": ((rec["transport"] - total)
                               if rec["transport"] else None),
        }
        rc = rec["classes"].get("reconcile")
        wm["reconcile_wire_per_diff_byte"] = (
            (rc["payload"] + rc["framing"]) / rec["diff_bytes"]
            if rc and rec["diff_bytes"] else None)
        sn = rec["classes"].get("snapshot")
        wm["snapshot_cold_ratio"] = (
            (sn["payload"] + sn["framing"]) / rec["dataset_bytes"]
            if sn and rec["dataset_bytes"] else None)
        return wm

    @staticmethod
    def _amp_view(amp: dict) -> dict:
        delivered = sum(amp["delivered"].values())
        return {
            "source_bytes": amp["source"],
            "delivered_bytes": delivered,
            "peers": dict(amp["delivered"]),
            "amplification": ((delivered / amp["source"])
                              if amp["source"] else None),
        }

    def snapshot(self) -> dict:
        """The ``wirecost`` section of the sidecar's stats record: per
        directed link (``"link|dir"``) the ledger and its watermarks,
        with ages on this process's monotonic clock, and per fan-out
        link its amplification."""
        now = time.monotonic()
        with self._lock:
            links = {f"{link}|{d}": {
                "classes": {k: dict(v) for k, v in rec["classes"].items()},
                "transport_bytes": rec["transport"],
                "diff_bytes": rec["diff_bytes"],
                "dataset_bytes": rec["dataset_bytes"],
                "failures": rec["failures"],
                "error": rec["error"],
                "age_s": round(now - rec["_mono"], 6),
                **self._watermarks(rec),
            } for (link, d), rec in self._links.items()}
            amp = {link: self._amp_view(a) for link, a in self._amp.items()}
        return {"monotonic": now, "links": links, "amplification": amp}

    def _collect(self) -> dict:
        """Registry collector: the ledger as labeled counters, the
        watermarks as labeled gauges (None watermarks skipped)."""
        counters: dict = {}
        gauges: dict = {}
        with self._lock:
            links = [(k, {
                "classes": {c: dict(v) for c, v in rec["classes"].items()},
                "transport": rec["transport"], "saved": rec["saved"],
                "diff_bytes": rec["diff_bytes"],
                "dataset_bytes": rec["dataset_bytes"],
                "failures": rec["failures"],
            }) for k, rec in self._links.items()]
            amps = [(link, self._amp_view(a))
                    for link, a in self._amp.items()]
        for (link, d), rec in links:
            framing_total = 0
            for cls, c in rec["classes"].items():
                counters[f"wire.cost.bytes{{link={link},dir={d},"
                         f"class={cls}}}"] = c["payload"]
                counters[f"wire.cost.frames{{link={link},dir={d},"
                         f"class={cls}}}"] = c["frames"]
                framing_total += c["framing"]
            if rec["classes"]:
                counters[f"wire.cost.bytes{{link={link},dir={d},"
                         "class=framing}"] = framing_total
            if rec["saved"]:
                counters[f"wire.cost.saved_bytes{{link={link},dir={d}}}"] \
                    = rec["saved"]
            if rec["failures"]:
                counters[f"wire.cost.failures{{link={link},dir={d}}}"] \
                    = rec["failures"]
            wm = self._watermarks(rec)
            for key in ("goodput_fraction", "overhead_ratio",
                        "reconcile_wire_per_diff_byte",
                        "snapshot_cold_ratio", "residual_bytes"):
                if wm[key] is not None:
                    gauges[f"wire.cost.{key}{{link={link},dir={d}}}"] = \
                        float(wm[key])
        for link, view in amps:
            counters[f"wire.cost.source_bytes{{link={link}}}"] = \
                view["source_bytes"]
            for peer, nbytes in view["peers"].items():
                counters[f"wire.cost.delivered_bytes{{link={link},"
                         f"peer={peer}}}"] = nbytes
            if view["amplification"] is not None:
                gauges[f"wire.cost.amplification{{link={link}}}"] = \
                    float(view["amplification"])
        return {"counters": counters, "gauges": gauges}

    def reset_for_tests(self) -> None:
        """Drop every ledger and amplification record."""
        with self._lock:
            self._links.clear()
            self._amp.clear()


WIRECOST = WireCostBoard()


# -- the instrumentation surface (callers hold the OBS.on gate) --------------


def account(cls: str, link: str, direction: str, payload_len: int,
            framing_len: int, frames: int = 1) -> None:
    WIRECOST.account(cls, link, direction, payload_len, framing_len,
                     frames)


def note_saved(link: str, direction: str, saved: int) -> None:
    WIRECOST.note_saved(link, direction, saved)


def note_diff(link: str, direction: str, diff_bytes: int) -> None:
    WIRECOST.note_diff(link, direction, diff_bytes)


def note_dataset(link: str, direction: str, dataset_bytes: int) -> None:
    WIRECOST.note_dataset(link, direction, dataset_bytes)


def note_source(link: str, nbytes: int) -> None:
    WIRECOST.note_source(link, nbytes)


def note_delivered(link: str, peer: str, nbytes: int) -> None:
    WIRECOST.note_delivered(link, peer, nbytes)


def note_transport(link: str, direction: str, nbytes: int) -> None:
    WIRECOST.note_transport(link, direction, nbytes)


def note_failure(link: str, direction: str,
                 error: Optional[str] = None) -> None:
    WIRECOST.note_failure(link, direction, error)
