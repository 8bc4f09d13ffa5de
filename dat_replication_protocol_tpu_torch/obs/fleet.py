"""The fleet aggregator: replica watermarks joined into per-link lag.

A copy of ``dat_replication_protocol_tpu/obs/fleet.py``; stdlib only.
One aggregator polls N *targets* — scrape endpoints (:mod:`.http`),
``--stats-fd`` JSONL files (the last complete record is read), or
in-process callables — and joins their sections:

* **lag in bytes** is exact: ``sender append − receiver parsed`` for one
  link, both cursors read from state the data plane keeps anyway;
* **lag in seconds** is clock-free: the age of the oldest unparsed byte
  on the *sender's* monotonic clock, from its append-marks ring;
* **gossip**: each ``--replica`` target's round, records, content digest
  and quarantines, with a rounds-behind column (progress since this
  aggregator first saw the target, so restarts and staggered starts do
  not read as "behind");
* **mesh**: the ``propagation`` sections joined into the convergence
  matrix (frontier digest equality is authoritative for divergence 0);
* **wire cost**: the ``wirecost`` ledgers joined per directed link;
* **loops**: each edge loop's lag record, keyed ``target:loop``.

:func:`render_dashboard` draws one plain-ANSI screen;
:func:`run_fleet_check` evaluates a declarative SLO file over the last
poll into verdict rows and exits 1 on breach.

SLO file schema (a JSON object; an empty one is refused, since it would
pass vacuously):

``max_lag_bytes`` / ``max_lag_seconds``
    per-link bounds at the final poll;
``require_converged``
    every joined link at lag exactly 0;
``max_shed`` / ``max_rejected``
    fleet-wide sums of the hub, fan-out and edge shed and reject
    counters;
``recompile_budget``
    most traces a kernel site may show across targets;
``require_healthz``
    every target's ``/healthz`` (or the ``healthz`` record embedded in
    its snapshot) must be ok;
``max_events_dropped``
    per-target bound on the event ring's drops;
``max_loop_lag_s``
    per-loop bound on the edge loop's lag (a dark loop fails);
``gossip``
    an object of ``require_converged`` (every content digest
    byte-identical), ``max_rounds_behind``, ``max_quarantined``, and the
    mesh keys ``max_convergence_rounds`` (refused below
    :func:`mesh_rounds_floor`), ``max_divergence_bytes``,
    ``max_exchange_age_s`` and ``max_exchange_p99_s``, evaluated over
    the ``propagation`` sections; no target reporting gossip, or the
    plane dark, fails loudly;
``min_goodput_fraction`` / ``max_overhead_ratio`` / ``max_egress_bytes_per_peer``
    the wire cost keys, per directed link and per fan-out peer; a link
    with no transport ground truth yet fails (unknown is not zero), and
    so does a fleet with no ``wirecost`` section at all.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from collections import deque
from typing import Callable, Optional
from urllib.request import urlopen

from .watermarks import link_lag

__all__ = [
    "FleetTarget",
    "FleetView",
    "evaluate_slo",
    "load_slo",
    "render_dashboard",
    "SLO_KEYS",
    "GOSSIP_SLO_KEYS",
    "MESH_SLO_KEYS",
    "WIRECOST_SLO_KEYS",
    "mesh_rounds_floor",
]

DEFAULT_HISTORY = 128
DEFAULT_TIMEOUT = 5.0

SLO_KEYS = frozenset({
    "max_lag_bytes", "max_lag_seconds", "require_converged",
    "max_shed", "max_rejected", "recompile_budget", "require_healthz",
    "max_events_dropped", "max_loop_lag_s", "gossip",
    # the wire cost plane: evaluated over joined
    # ``wirecost`` sections; dark plane = loud failure
    "min_goodput_fraction", "max_overhead_ratio",
    "max_egress_bytes_per_peer",
})

# the cost keys evaluated over the joined wirecost sections — grouped
# so evaluate_slo can apply the one dark-plane rule to all of them
WIRECOST_SLO_KEYS = frozenset({
    "min_goodput_fraction", "max_overhead_ratio",
    "max_egress_bytes_per_peer",
})

# the mesh convergence plane's SLO vocabulary: evaluated
# over the ``propagation`` sections ``--replica`` sidecars embed — the
# per-pair divergence watermarks, per-link last-success ages, and the
# exchange-latency quantile the plane itself measures
MESH_SLO_KEYS = frozenset({
    "max_convergence_rounds", "max_divergence_bytes",
    "max_exchange_age_s", "max_exchange_p99_s",
})

GOSSIP_SLO_KEYS = frozenset({
    "require_converged", "max_rounds_behind", "max_quarantined",
}) | MESH_SLO_KEYS


def _join_gossip(snaps: dict, baselines: dict) -> dict:
    """Per-target gossip records joined into the convergence view:
    each ``--replica`` target's round/digest/quarantine state plus the
    per-replica **rounds-behind** column.

    Live round counters are LIFETIME values on unsynchronized
    processes — a replica restarted an hour into the fleet's life
    reports round ~5 against its peers' ~3600 while being fully
    converged, so comparing absolute positions would breach forever on
    any restart or staggered start.  Rounds-behind is therefore
    *progress since this aggregator first saw the target*:
    ``max over targets of (round − baseline) − own (round −
    baseline)`` — zero across a healthy mesh whatever the absolute
    counters, growing only for a replica whose gossip timer stops
    advancing with the fleet.  A round counter that goes BACKWARD
    (restart) re-baselines instead of reading as "behind".  The
    ``baselines`` dict is the caller's per-view memory
    (:class:`FleetView` owns one)."""
    records = {tname: snap["gossip"] for tname, snap in snaps.items()
               if isinstance((snap or {}).get("gossip"), dict)}
    if not records:
        return {}
    deltas = {}
    for tname, r in records.items():
        rnd = int(r.get("round", 0))
        base = baselines.setdefault(tname, rnd)
        if rnd < base:
            baselines[tname] = base = rnd
        deltas[tname] = rnd - base
    top = max(deltas.values())
    out = {}
    for tname, r in records.items():
        out[tname] = {
            "replica": r.get("replica"),
            "round": int(r.get("round", 0)),
            "rounds_behind": top - deltas[tname],
            "records": r.get("records"),
            "digest": r.get("digest"),
            "quarantined": list(r.get("quarantined") or ()),
            # structured quarantine PROVENANCE: which arm
            # caught each quarantined peer and where on the wire —
            # the byzantine oracle checks these against ground truth
            "quarantine": dict(r.get("quarantine") or {}),
            "suspicion": dict(r.get("suspicion") or {}),
            "state": r.get("state"),
        }
    return out


def _join_mesh(snaps: dict) -> dict:
    """Join every target's ``propagation`` section into the
    fleet convergence matrix: per directed link the freshest exchange
    watermark across targets (by round), per replica the freshest
    frontier, per UNDIRECTED pair the effective divergence — **frontier
    digest equality is authoritative**: a link watermark is the diff at
    the pair's LAST exchange, so a pair whose frontiers are
    byte-identical has divergence exactly 0 whatever a stale watermark
    says.  ``exchange_p99_s`` is the worst per-target p99 (quantiles
    do not merge across windows; the max is the conservative fleet
    bound)."""
    links: dict = {}
    frontier: dict = {}
    p99 = None
    count = 0
    for tname, snap in sorted(snaps.items()):
        prop = (snap or {}).get("propagation")
        if not isinstance(prop, dict):
            continue
        for lname, rec in (prop.get("links") or {}).items():
            cur = links.get(lname)
            if cur is None or int(rec.get("round") or 0) >= \
                    int(cur.get("round") or 0):
                links[lname] = dict(rec, target=tname)
        for rname, rec in (prop.get("frontier") or {}).items():
            cur = frontier.get(rname)
            if cur is None or int(rec.get("round") or 0) >= \
                    int(cur.get("round") or 0):
                frontier[rname] = dict(rec, target=tname)
        xs = prop.get("exchange_seconds") or {}
        if xs.get("p99") is not None:
            p99 = xs["p99"] if p99 is None else max(p99, xs["p99"])
            count += int(xs.get("count") or 0)
    if not links and not frontier:
        return {}
    pairs: dict = {}
    for lname, rec in links.items():
        a, _, b = lname.partition("->")
        key = "<->".join(sorted((a, b)))
        cur = pairs.get(key)
        if cur is not None and int(cur.get("round") or 0) > \
                int(rec.get("round") or 0):
            continue
        da = (frontier.get(a) or {}).get("digest")
        db = (frontier.get(b) or {}).get("digest")
        conv = da is not None and da == db
        pairs[key] = {
            "round": rec.get("round"),
            "converged": conv,
            "divergence_records": 0 if conv
            else rec.get("divergence_records"),
            "divergence_bytes": 0 if conv
            else rec.get("divergence_bytes"),
            "last_success_age_s": rec.get("last_success_age_s"),
            "outcome": rec.get("outcome"),
        }
    return {"links": links, "pairs": pairs, "frontier": frontier,
            "exchange_p99_s": p99, "exchange_count": count}


def _join_wirecost(snaps: dict) -> dict:
    """Join every target's ``wirecost`` section into the
    fleet cost matrix: per directed link the freshest ledger across
    targets (by ledger total — the counters are monotonic, so the
    largest ledger IS the latest view of that link), per fan-out link
    the freshest amplification record (by source bytes, same
    monotonicity argument).  Targets with no section contribute
    nothing; an empty join is the dark-plane signal the SLO rows fail
    loudly on."""
    links: dict = {}
    amp: dict = {}
    for tname, snap in sorted(snaps.items()):
        wc = (snap or {}).get("wirecost")
        if not isinstance(wc, dict):
            continue
        for lname, rec in (wc.get("links") or {}).items():
            cur = links.get(lname)
            if cur is None or int(rec.get("ledger_bytes") or 0) >= \
                    int(cur.get("ledger_bytes") or 0):
                links[lname] = dict(rec, target=tname)
        for aname, rec in (wc.get("amplification") or {}).items():
            cur = amp.get(aname)
            if cur is None or int(rec.get("source_bytes") or 0) >= \
                    int(cur.get("source_bytes") or 0):
                amp[aname] = dict(rec, target=tname)
    if not links and not amp:
        return {}
    return {"links": links, "amplification": amp}


class FleetTarget:
    """One polled replica.  ``spec`` is an ``http(s)://`` endpoint (its
    ``/snapshot`` route is fetched, ``/healthz`` alongside), a filesystem
    path to a ``--stats-fd`` JSONL file (the last complete snapshot
    line is used; ``emit_seq`` gaps are counted as dropped lines), or a
    zero-argument callable returning the snapshot dict (in-process
    fleets: tests, bench legs)."""

    def __init__(self, spec, name: Optional[str] = None,
                 timeout: float = DEFAULT_TIMEOUT):
        self._spec = spec
        self._timeout = timeout
        if callable(spec):
            self.kind = "callable"
            self.name = name or getattr(spec, "__name__", "inproc")
        elif isinstance(spec, str) and spec.startswith(("http://",
                                                        "https://")):
            self.kind = "http"
            self.name = name or spec
        elif isinstance(spec, str):
            self.kind = "file"
            self.name = name or os.path.basename(spec)
        else:
            raise ValueError(f"unknown fleet target spec {spec!r}")
        self.last_error: Optional[str] = None
        self.last_emit_seq: Optional[int] = None
        self.dropped_lines = 0  # emit_seq gaps observed across polls

    def poll(self) -> Optional[dict]:
        """One snapshot dict, or None (the failure is recorded on
        ``last_error`` — an unreachable replica is a visible state, not
        an exception that kills the whole poll)."""
        try:
            if self.kind == "callable":
                snap = self._spec()
            elif self.kind == "http":
                base = self._spec.rstrip("/")
                with urlopen(base + "/snapshot",
                             timeout=self._timeout) as r:
                    snap = json.loads(r.read().decode("utf-8"))
            else:
                snap = self._read_last_line(self._spec)
        except Exception as e:
            self.last_error = f"{type(e).__name__}: {e}"
            return None
        if snap is None:
            self.last_error = "no complete snapshot line yet"
            return None
        self.last_error = None
        seq = snap.get("emit_seq")
        if isinstance(seq, int):
            if self.last_emit_seq is not None \
                    and seq > self.last_emit_seq + 1:
                # lines the emitter consumed a seq for but this reader
                # never saw: EAGAIN skips, torn-line latches, or a
                # truncated tail — surfaced, not silently absorbed
                self.dropped_lines += seq - self.last_emit_seq - 1
            self.last_emit_seq = seq
        return snap

    def poll_healthz(self, snap: Optional[dict] = None) -> Optional[dict]:
        """The target's staged health record: fetched from ``/healthz``
        for endpoint targets (503 bodies are still parsed — degraded IS
        the answer), read from the snapshot's embedded ``healthz`` key
        for file/callable targets (the sidecar's ``--stats-fd`` lines
        carry one).  Pass the snapshot already polled this sample via
        ``snap`` to avoid re-polling."""
        if self.kind == "http":
            base = self._spec.rstrip("/")
            try:
                with urlopen(base + "/healthz",
                             timeout=self._timeout) as r:
                    return json.loads(r.read().decode("utf-8"))
            except Exception as e:
                body = getattr(e, "read", None)
                if body is not None:
                    try:  # HTTPError 503 carries the staged record
                        return json.loads(body().decode("utf-8"))
                    except Exception:
                        pass
                return {"ok": False,
                        "error": f"{type(e).__name__}: {e}"}
        if snap is None:
            snap = self.poll()
        return (snap or {}).get("healthz")

    @staticmethod
    def _read_last_line(path: str) -> Optional[dict]:
        # the last COMPLETE JSON line wins; a torn final line (emitter
        # mid-write, or latched dead mid-record) parses as garbage and
        # is skipped — exactly the JSONL consumer discipline the event
        # sink documents
        last = None
        with open(path, encoding="utf-8") as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    obj = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if isinstance(obj, dict) and "watermarks" in obj:
                    last = obj
        return last


def _join_links(snaps: dict) -> dict:
    """Join every target's watermark links by link name.  Returns
    ``{link: {"offsets", "marks", "mark_clock", "targets", "lag_bytes",
    "lag_seconds"}}``.  When sender and receiver cursors come from
    DIFFERENT targets (the normal fleet case), the seconds join uses
    the marks + monotonic stamp of the target that exported the
    ``append`` cursor — one clock, the sender's."""
    links: dict = {}
    for tname, snap in snaps.items():
        wm = (snap or {}).get("watermarks") or {}
        clock = wm.get("monotonic")
        for lname, rec in (wm.get("links") or {}).items():
            entry = links.setdefault(lname, {
                "offsets": {}, "marks": [], "mark_clock": None,
                "marks_dropped": 0, "targets": []})
            entry["targets"].append(tname)
            offsets = rec.get("offsets") or {}
            for role, value in offsets.items():
                entry["offsets"][role] = value
            marks = rec.get("marks") or []
            src = rec.get("marks_from")
            if src and not marks:
                src_rec = (wm.get("links") or {}).get(src)
                if src_rec:
                    marks = src_rec.get("marks") or []
            if "append" in offsets:
                # the sender side of the join: its marks and ITS clock
                entry["marks"] = marks
                entry["mark_clock"] = clock
                entry["marks_dropped"] = rec.get("marks_dropped", 0)
    for entry in links.values():
        lag_bytes, lag_seconds = link_lag(
            entry["offsets"], entry["marks"],
            entry["mark_clock"] if entry["mark_clock"] is not None
            else 0.0,
            marks_dropped=entry["marks_dropped"])
        if entry["mark_clock"] is None and lag_bytes is not None:
            # no sender clock came with the marks: behind -> unknown
            # age, caught up -> exactly 0 (the byte identity needs no
            # clock at all)
            lag_seconds = None if lag_bytes else 0.0
        entry["lag_bytes"] = lag_bytes
        entry["lag_seconds"] = lag_seconds
    return links


def _join_loops(snaps: dict) -> dict:
    """Join every target's event-loop lag records (the watermark
    snapshot's ``loops`` section) keyed ``target:loop`` —
    two sidecars each running ``edge0`` must not shadow each other."""
    out: dict = {}
    for tname, snap in snaps.items():
        wm = (snap or {}).get("watermarks") or {}
        for lname, rec in sorted((wm.get("loops") or {}).items()):
            if not isinstance(rec, dict):
                continue
            out[f"{tname}:{lname}"] = dict(rec, target=tname, loop=lname)
    return out


def _counter_sum(snaps: dict, names: tuple) -> int:
    total = 0
    for snap in snaps.values():
        counters = ((snap or {}).get("metrics") or {}).get("counters") or {}
        for name, v in counters.items():
            base = name.partition("{")[0]
            if base in names:
                total += int(v)
    return total


class FleetView:
    """N targets, joined.  :meth:`poll` takes one fleet-wide sample;
    the per-link history ring feeds rate computation and the
    dashboard's sparklines."""

    def __init__(self, targets, history: int = DEFAULT_HISTORY):
        self.targets = [t if isinstance(t, FleetTarget) else FleetTarget(t)
                        for t in targets]
        if not self.targets:
            raise ValueError("a fleet needs at least one target")
        # target names key the per-poll snapshot dict: two targets
        # sharing one (two anonymous lambdas, twice the same file)
        # would silently shadow each other in every join
        seen: dict = {}
        for t in self.targets:
            n = seen.get(t.name, 0)
            seen[t.name] = n + 1
            if n:
                t.name = f"{t.name}#{n + 1}"
        self._history: dict[str, deque] = {}
        self._hist_len = history
        # per-target first-seen gossip round: the rounds-behind
        # baseline (_join_gossip — live counters are lifetime values)
        self._gossip_baseline: dict = {}
        self.polls = 0

    def poll(self, healthz: bool = False) -> dict:
        """One sample: per-target snapshot + joined links + fleet-wide
        overload counters (+ per-target health with ``healthz=True``).
        Unreachable targets appear in ``errors`` — visible, never
        fatal."""
        now = time.monotonic()
        snaps: dict = {}
        errors: dict = {}
        for t in self.targets:
            snap = t.poll()
            if snap is None:
                errors[t.name] = t.last_error
            else:
                snaps[t.name] = snap
        links = _join_links(snaps)
        for lname, entry in links.items():
            ring = self._history.setdefault(
                lname, deque(maxlen=self._hist_len))
            ring.append((now, entry["lag_bytes"], entry["lag_seconds"]))
            entry["drain_bps"] = self._drain_rate(ring)
        sample = {
            "polled": now,
            "targets": {name: {
                "ts": snap.get("ts"),
                "events_dropped": snap.get("events_dropped", 0),
                "emit_seq": snap.get("emit_seq"),
                "jit_sites": snap.get("jit_sites") or {},
                "hub": snap.get("hub"),
                "fanout": snap.get("fanout"),
                "edge": snap.get("edge"),
            } for name, snap in snaps.items()},
            "errors": errors,
            "links": links,
            "loops": _join_loops(snaps),
            "gossip": _join_gossip(snaps, self._gossip_baseline),
            "mesh": _join_mesh(snaps),
            "wirecost": _join_wirecost(snaps),
            "shed": _counter_sum(snaps, ("hub.shed", "fanout.peer.shed",
                                         "edge.shed")),
            "rejected": _counter_sum(snaps, ("hub.rejected",
                                             "fanout.rejected",
                                             "edge.rejected")),
            "reconcile": {
                "rounds": _counter_sum(snaps, ("reconcile.rounds",)),
                "symbols_seen": self._gauge_max(snaps,
                                                "reconcile.symbols.seen"),
                "decoded_diff": self._gauge_max(snaps,
                                                "reconcile.decoded.diff"),
            },
            "dropped_lines": {t.name: t.dropped_lines
                              for t in self.targets if t.dropped_lines},
        }
        if healthz:
            # file/callable targets reuse the snapshot this sample
            # already took (their health rides the snapshot record);
            # only endpoint targets pay a second request, to /healthz
            sample["healthz"] = {
                t.name: t.poll_healthz(snap=snaps.get(t.name))
                for t in self.targets}
        self.polls += 1
        return sample

    @staticmethod
    def _gauge_max(snaps: dict, name: str) -> float:
        best = 0.0
        for snap in snaps.values():
            gauges = ((snap or {}).get("metrics") or {}).get("gauges") or {}
            v = gauges.get(name)
            if v is not None:
                best = max(best, float(v))
        return best

    @staticmethod
    def _drain_rate(ring) -> Optional[float]:
        """Bytes/second the link's lag is shrinking at over the ring
        window (negative: the link is falling further behind)."""
        pts = [(t, b) for t, b, _s in ring if b is not None]
        if len(pts) < 2:
            return None
        (t0, b0), (t1, b1) = pts[0], pts[-1]
        if t1 <= t0:
            return None
        return round((b0 - b1) / (t1 - t0), 1)

    def history(self, link: str) -> list:
        return list(self._history.get(link, ()))


# -- SLO gate -----------------------------------------------------------------


def load_slo(path: str) -> dict:
    """Parse + validate an SLO file.  Malformed input (not an object,
    unknown keys, non-numeric bounds, or NO evaluable keys) raises
    ``ValueError`` — a gate that silently evaluates nothing is not a
    gate."""
    with open(path, encoding="utf-8") as f:
        slo = json.load(f)
    if not isinstance(slo, dict):
        raise ValueError(f"SLO file {path}: expected a JSON object")
    unknown = set(slo) - SLO_KEYS
    if unknown:
        raise ValueError(
            f"SLO file {path}: unknown key(s) {sorted(unknown)} "
            f"(known: {sorted(SLO_KEYS)})")
    if not slo:
        raise ValueError(
            f"SLO file {path}: no evaluable keys — an empty SLO would "
            "pass vacuously")
    for key in ("max_lag_bytes", "max_lag_seconds", "max_shed",
                "max_rejected", "recompile_budget", "max_events_dropped",
                "max_loop_lag_s", "min_goodput_fraction",
                "max_overhead_ratio", "max_egress_bytes_per_peer"):
        if key in slo and not isinstance(slo[key], (int, float)):
            raise ValueError(f"SLO file {path}: {key} must be a number")
    for key in ("require_converged", "require_healthz"):
        if key in slo and not isinstance(slo[key], bool):
            raise ValueError(f"SLO file {path}: {key} must be a boolean")
    if "min_goodput_fraction" in slo \
            and not 0 <= slo["min_goodput_fraction"] <= 1:
        raise ValueError(
            f"SLO file {path}: min_goodput_fraction must be in [0, 1] — "
            "a fraction above 1 is an unreachable SLO, and an "
            "unreachable gate is a misconfiguration")
    if "gossip" in slo:
        g = slo["gossip"]
        if not isinstance(g, dict):
            raise ValueError(f"SLO file {path}: gossip must be an object")
        unknown = set(g) - GOSSIP_SLO_KEYS
        if unknown:
            raise ValueError(
                f"SLO file {path}: unknown gossip key(s) "
                f"{sorted(unknown)} (known: {sorted(GOSSIP_SLO_KEYS)})")
        if not g:
            raise ValueError(
                f"SLO file {path}: empty gossip object would pass "
                "vacuously")
        for key in ("max_rounds_behind", "max_quarantined",
                    "max_convergence_rounds", "max_divergence_bytes",
                    "max_exchange_age_s", "max_exchange_p99_s"):
            if key in g and not isinstance(g[key], (int, float)):
                raise ValueError(
                    f"SLO file {path}: gossip.{key} must be a number")
        if "require_converged" in g \
                and not isinstance(g["require_converged"], bool):
            raise ValueError(
                f"SLO file {path}: gossip.require_converged must be a "
                "boolean")
    return slo


def mesh_rounds_floor(n_replicas: int) -> int:
    """The epidemic rounds floor an SLO's ``max_convergence_rounds``
    must clear: ``3*ceil(log2(n)) + 10`` — the no-chaos core of
    :meth:`~..cluster.sim.ClusterSim.rounds_bound`.  A bound below what
    epidemic spread mathematically needs is an unreachable SLO, and an
    unreachable gate is a misconfiguration, not a standard."""
    return 3 * math.ceil(math.log2(max(2, int(n_replicas)))) + 10


def _evaluate_mesh_slo(g: dict, mesh: dict, row) -> None:
    """The mesh-key rows of the gossip SLO, over a joined
    ``mesh`` sample (:func:`_join_mesh`)."""
    frontier = mesh.get("frontier") or {}
    links = mesh.get("links") or {}
    pairs = mesh.get("pairs") or {}
    if "max_convergence_rounds" in g:
        bound = g["max_convergence_rounds"]
        n = len(frontier) or 2
        floor = mesh_rounds_floor(n)
        if bound < floor:
            row("gossip.max_convergence_rounds", "slo", False,
                f"bound {bound} is below the epidemic rounds_bound() "
                f"floor {floor} for {n} replica(s) — an unreachable SLO")
        else:
            digests = {r.get("digest") for r in frontier.values()}
            conv = len(digests) == 1 and None not in digests
            last_change = max((int(r.get("round") or 0)
                               for r in frontier.values()), default=0)
            if conv:
                row("gossip.max_convergence_rounds", "fleet",
                    last_change <= bound,
                    f"converged at round {last_change}, bound {bound}")
            else:
                cur = max([int(r.get("round") or 0)
                           for r in links.values()] + [last_change],
                          default=0)
                row("gossip.max_convergence_rounds", "fleet",
                    cur <= bound,
                    f"not converged at round {cur} ({len(digests)} "
                    f"distinct frontiers), bound {bound}")
    if "max_divergence_bytes" in g:
        bound = g["max_divergence_bytes"]
        if not pairs:
            row("gossip.max_divergence_bytes", "-", False,
                "no exchange watermarks joined: divergence unknown")
        for pname, p in sorted(pairs.items()):
            db = p.get("divergence_bytes")
            if p.get("converged"):
                row("gossip.max_divergence_bytes", pname, True,
                    "frontiers byte-identical (divergence exactly 0)")
            elif db is None:
                row("gossip.max_divergence_bytes", pname, False,
                    "no completed peel yet: divergence unknown")
            else:
                row("gossip.max_divergence_bytes", pname, db <= bound,
                    f"divergence {db} byte(s) "
                    f"({p.get('divergence_records')} record(s)) at "
                    f"round {p.get('round')}, bound {bound}")
    if "max_exchange_age_s" in g:
        bound = g["max_exchange_age_s"]
        if not links:
            row("gossip.max_exchange_age_s", "-", False,
                "no exchange watermarks joined: link ages unknown")
        for lname, rec in sorted(links.items()):
            age = rec.get("last_success_age_s")
            if age is None:
                row("gossip.max_exchange_age_s", lname, False,
                    "no successful exchange on this link yet: a "
                    "silently-dead link, not a passing one")
            else:
                row("gossip.max_exchange_age_s", lname, age <= bound,
                    f"last successful exchange {age:.3f}s ago, "
                    f"bound {bound}")
    if "max_exchange_p99_s" in g:
        bound = g["max_exchange_p99_s"]
        p99 = mesh.get("exchange_p99_s")
        if p99 is None:
            row("gossip.max_exchange_p99_s", "fleet", False,
                "no completed exchanges: p99 unknown")
        else:
            row("gossip.max_exchange_p99_s", "fleet", p99 <= bound,
                f"exchange p99 {p99:.4f}s over "
                f"{mesh.get('exchange_count', 0)} exchange(s), "
                f"bound {bound}")


def evaluate_slo(slo: dict, sample: dict) -> list[dict]:
    """One fleet sample against one SLO: verdict rows
    (``{"check", "subject", "status", "detail"}``; callers gate on
    ``any(r["status"] == "fail")``)."""
    rows: list[dict] = []

    def row(check: str, subject: str, ok: bool, detail: str) -> None:
        rows.append({"check": check, "subject": subject,
                     "status": "ok" if ok else "fail", "detail": detail})

    links = sample.get("links") or {}
    if "max_lag_bytes" in slo or "max_lag_seconds" in slo \
            or slo.get("require_converged"):
        if not links:
            row("lag", "-", False,
                "no joined links: nothing to evaluate lag against")
    for lname, entry in sorted(links.items()):
        lb, ls = entry.get("lag_bytes"), entry.get("lag_seconds")
        if "max_lag_bytes" in slo:
            bound = slo["max_lag_bytes"]
            if lb is None:
                row("max_lag_bytes", lname, False,
                    "link not joined (one side missing)")
            else:
                row("max_lag_bytes", lname, lb <= bound,
                    f"lag {lb} byte(s), bound {bound}")
        if "max_lag_seconds" in slo:
            bound = slo["max_lag_seconds"]
            if lb == 0:
                row("max_lag_seconds", lname, True, "caught up (lag 0)")
            elif ls is None:
                row("max_lag_seconds", lname, False,
                    "behind with no age attribution (marks missing)")
            else:
                row("max_lag_seconds", lname, ls <= bound,
                    f"oldest unparsed byte {ls:.3f}s old, bound {bound}")
        if slo.get("require_converged"):
            row("require_converged", lname, lb == 0,
                f"lag {lb} byte(s) (must be exactly 0)")
    if "gossip" in slo:
        g = slo["gossip"]
        gossip = sample.get("gossip") or {}
        if not gossip:
            row("gossip", "-", False,
                "no targets report gossip records: nothing to "
                "evaluate convergence against")
        if g.get("require_converged") and gossip:
            digests = {r.get("digest") for r in gossip.values()}
            ok = len(digests) == 1 and None not in digests
            row("gossip.require_converged", "fleet", ok,
                "all replica content digests byte-identical" if ok else
                f"{len(digests)} distinct content digests across "
                f"{len(gossip)} replicas")
        for tname, r in sorted(gossip.items()):
            if "max_rounds_behind" in g:
                bound = g["max_rounds_behind"]
                rb = r["rounds_behind"]
                row("gossip.max_rounds_behind", tname, rb <= bound,
                    f"{rb} round(s) behind the fleet frontier, "
                    f"bound {bound}")
            if "max_quarantined" in g:
                bound = g["max_quarantined"]
                nq = len(r["quarantined"])
                row("gossip.max_quarantined", tname, nq <= bound,
                    f"{nq} peer(s) quarantined, bound {bound}")
        mesh_keys = MESH_SLO_KEYS & set(g)
        if mesh_keys:
            mesh = sample.get("mesh") or {}
            if not mesh:
                # the "lag unknown" rule, applied to the mesh: an
                # SLO over a plane nobody reports must fail loudly —
                # a dark plane is indistinguishable from a broken one
                row("gossip.mesh", "-", False,
                    "no targets report propagation records: the mesh "
                    "convergence plane is dark — nothing to evaluate "
                    f"{sorted(mesh_keys)} against")
            else:
                _evaluate_mesh_slo(g, mesh, row)
    cost_keys = WIRECOST_SLO_KEYS & set(slo)
    if cost_keys:
        wc = sample.get("wirecost") or {}
        if not wc:
            # the dark-plane rule:
            # a cost SLO over a plane nobody reports must fail loudly —
            # an unmetered wire is indistinguishable from a free one
            row("wirecost", "-", False,
                "no targets report wire cost records: the wire cost "
                "plane is dark — nothing to evaluate "
                f"{sorted(cost_keys)} against")
        else:
            wlinks = wc.get("links") or {}
            if ("min_goodput_fraction" in slo
                    or "max_overhead_ratio" in slo) and not wlinks:
                row("wirecost.links", "-", False,
                    "no per-link ledgers joined: goodput/overhead "
                    "unknown")
            for lname, rec in sorted(wlinks.items()):
                if "min_goodput_fraction" in slo:
                    bound = slo["min_goodput_fraction"]
                    gf = rec.get("goodput_fraction")
                    if gf is None:
                        row("min_goodput_fraction", lname, False,
                            "no bytes attributed yet: goodput unknown "
                            "(unknown is not a pass)")
                    else:
                        row("min_goodput_fraction", lname, gf >= bound,
                            f"goodput {gf:.4f} "
                            f"({rec.get('payload_bytes')}/"
                            f"{rec.get('ledger_bytes')} byte(s)), "
                            f"floor {bound}")
                if "max_overhead_ratio" in slo:
                    bound = slo["max_overhead_ratio"]
                    ov = rec.get("overhead_ratio")
                    if ov is None:
                        row("max_overhead_ratio", lname, False,
                            "no bytes attributed yet: overhead unknown "
                            "(unknown is not a pass)")
                    else:
                        row("max_overhead_ratio", lname, ov <= bound,
                            f"overhead {ov:.4f} "
                            f"({rec.get('framing_bytes')}/"
                            f"{rec.get('ledger_bytes')} byte(s)), "
                            f"bound {bound}")
            if "max_egress_bytes_per_peer" in slo:
                bound = slo["max_egress_bytes_per_peer"]
                amp = wc.get("amplification") or {}
                if not amp:
                    row("max_egress_bytes_per_peer", "-", False,
                        "no fan-out amplification ledgers joined: "
                        "per-peer egress unknown")
                for aname, view_ in sorted(amp.items()):
                    for peer, nbytes in sorted(
                            (view_.get("peers") or {}).items()):
                        row("max_egress_bytes_per_peer",
                            f"{aname}:{peer}", nbytes <= bound,
                            f"delivered {nbytes} byte(s), bound {bound}")
    if "max_loop_lag_s" in slo:
        bound = slo["max_loop_lag_s"]
        loops = sample.get("loops") or {}
        if not loops:
            row("max_loop_lag_s", "-", False,
                "no targets report event-loop lag: nothing to "
                "evaluate against")
        for lname, rec in sorted(loops.items()):
            if rec.get("state") != "live":
                row("max_loop_lag_s", lname, False,
                    "loop telemetry dark (obs gate off): lag unknown")
                continue
            lag = float(rec.get("lag_s", 0.0))
            row("max_loop_lag_s", lname, lag <= bound,
                f"loop lag {lag:.3f}s "
                f"(max {float(rec.get('lag_max_s', 0.0)):.3f}s), "
                f"bound {bound}")
    if "max_shed" in slo:
        row("max_shed", "fleet", sample.get("shed", 0) <= slo["max_shed"],
            f"shed {sample.get('shed', 0)}, bound {slo['max_shed']}")
    if "max_rejected" in slo:
        row("max_rejected", "fleet",
            sample.get("rejected", 0) <= slo["max_rejected"],
            f"rejected {sample.get('rejected', 0)}, "
            f"bound {slo['max_rejected']}")
    if "recompile_budget" in slo:
        bound = slo["recompile_budget"]
        worst, site = 0, "-"
        for tname, t in (sample.get("targets") or {}).items():
            for sname, rec in (t.get("jit_sites") or {}).items():
                if rec.get("traces", 0) > worst:
                    worst, site = rec["traces"], f"{tname}:{sname}"
        row("recompile_budget", site, worst <= bound,
            f"worst site traced {worst}x, bound {bound}")
    if "max_events_dropped" in slo:
        bound = slo["max_events_dropped"]
        for tname, t in sorted((sample.get("targets") or {}).items()):
            dropped = t.get("events_dropped", 0)
            row("max_events_dropped", tname, dropped <= bound,
                f"ring dropped {dropped}, bound {bound}")
    if slo.get("require_healthz"):
        hz = sample.get("healthz") or {}
        if not hz:
            row("require_healthz", "-", False,
                "no healthz records polled")
        for tname, rec in sorted(hz.items()):
            ok = bool(rec and rec.get("ok"))
            degraded = "-"
            if rec and not ok:
                degraded = ",".join(
                    s for s, st in (rec.get("stages") or {}).items()
                    if not st.get("ok")) or rec.get("error", "?")
            row("require_healthz", tname, ok,
                "healthy" if ok else f"degraded: {degraded}")
    for tname, err in sorted((sample.get("errors") or {}).items()):
        row("reachable", tname, False, f"target unreachable: {err}")
    return rows


def run_fleet_check(targets, slo_path: str, polls: int = 3,
                    interval: float = 0.5, out=None) -> int:
    """The CI gate: poll, evaluate the FINAL sample, report one line
    per check, exit 1 on breach.  A malformed SLO is itself a failure
    row — a gate must fail loudly, never pass on an unreadable
    contract."""
    out = out if out is not None else sys.stdout
    try:
        slo = load_slo(slo_path)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"FAIL slo          {type(e).__name__}: {e}", file=out)
        print("fleet-check: 1 check(s), 1 failed — SLO BREACH", file=out)
        return 1
    view = FleetView(targets)
    sample = None
    for i in range(max(1, polls)):
        if i:
            time.sleep(interval)
        sample = view.poll(healthz=bool(slo.get("require_healthz")))
    rows = evaluate_slo(slo, sample)
    failed = 0
    for r in rows:
        mark = "OK  " if r["status"] == "ok" else "FAIL"
        subject = f"{r['check']}[{r['subject']}]"
        print(f"{mark} {subject:<40} {r['detail']}", file=out)
        failed += r["status"] == "fail"
    verdict = "SLO BREACH" if failed else "within SLO"
    print(f"fleet-check: {len(rows)} check(s), {failed} failed — "
          f"{verdict}", file=out)
    return 1 if failed else 0


# -- TTY dashboard ------------------------------------------------------------

_SPARK = " ▁▂▃▄▅▆▇█"


def _sparkline(values, width: int = 24) -> str:
    vals = [v for v in values if v is not None][-width:]
    if not vals:
        return "-" * width
    top = max(vals) or 1
    return "".join(_SPARK[min(8, int(8 * v / top + 0.5))]
                   for v in vals).rjust(width)


def render_dashboard(view: FleetView, sample: dict,
                     width: int = 78) -> str:
    """One screen, plain ANSI (no curses, no deps): per-target health
    column, per-link lag + sparkline over the history ring, overload /
    convergence summary, recent errors.  Returns the frame as a string
    (the CLI clears + prints; tests assert on content)."""
    lines: list[str] = []
    bar = "─" * width
    lines.append(f"fleet · {len(view.targets)} target(s) · "
                 f"poll #{view.polls}")
    lines.append(bar)
    hz = sample.get("healthz") or {}
    for t in view.targets:
        if t.name in (sample.get("errors") or {}):
            status = f"UNREACHABLE  {sample['errors'][t.name]}"
        elif hz and hz.get(t.name) is not None:
            status = "healthy" if hz[t.name].get("ok") else "DEGRADED"
        else:
            # reachable but no health record (a bare snapshot file):
            # an honest "up", not a fabricated DEGRADED
            status = "up"
        drop = f"  dropped_lines={t.dropped_lines}" if t.dropped_lines \
            else ""
        lines.append(f"  {t.name[:40]:<40} {status}{drop}")
    lines.append(bar)
    links = sample.get("links") or {}
    if links:
        lines.append(f"  {'link':<20} {'lag_bytes':>10} {'age_s':>8} "
                     f"{'drain_B/s':>10}  history")
        for lname, entry in sorted(links.items()):
            ring = view.history(lname)
            lb = entry.get("lag_bytes")
            ls = entry.get("lag_seconds")
            dr = entry.get("drain_bps")
            lines.append(
                f"  {lname[:20]:<20} "
                f"{('-' if lb is None else str(lb)):>10} "
                f"{('-' if ls is None else f'{ls:.3f}'):>8} "
                f"{('-' if dr is None else str(dr)):>10}  "
                f"{_sparkline([b for _t, b, _s in ring])}")
    else:
        lines.append("  (no joined links yet)")
    loops = sample.get("loops") or {}
    if loops:
        # the edge flight deck: per-loop lag watermarks
        lines.append(bar)
        lines.append(f"  {'loop':<28} {'lag_s':>8} {'max_s':>8} "
                     f"{'oldest_s':>9} {'turns':>8}")
        for lname, r in sorted(loops.items()):
            if r.get("state") != "live":
                lines.append(f"  {lname[:28]:<28} DARK (obs gate off)")
                continue
            lines.append(
                f"  {lname[:28]:<28} "
                f"{float(r.get('lag_s', 0.0)):>8.3f} "
                f"{float(r.get('lag_max_s', 0.0)):>8.3f} "
                f"{float(r.get('oldest_ready_s', 0.0)):>9.3f} "
                f"{r.get('turns', 0):>8}")
    gossip = sample.get("gossip") or {}
    if gossip:
        # the per-replica convergence column: rounds-behind
        # the fleet frontier + the content digest everyone must agree on
        lines.append(bar)
        lines.append(f"  {'replica':<20} {'round':>7} {'behind':>7} "
                     f"{'records':>8} {'quar':>5}  digest")
        for tname, r in sorted(gossip.items()):
            lines.append(
                f"  {str(r.get('replica') or tname)[:20]:<20} "
                f"{r['round']:>7} {r['rounds_behind']:>7} "
                f"{str(r.get('records', '-')):>8} "
                f"{len(r['quarantined']):>5}  "
                f"{(r.get('digest') or '?')[:16]}")
    mesh = sample.get("mesh") or {}
    if mesh:
        # the convergence matrix: per-pair divergence from
        # the exchange's own peel, per-link success age, exchange p99
        lines.append(bar)
        lines.append(f"  {'pair':<16} {'div_rec':>8} {'div_B':>8} "
                     f"{'ok_age_s':>9} {'round':>6}  outcome")
        for pname, p in sorted((mesh.get("pairs") or {}).items()):
            dr, db = p.get("divergence_records"), p.get("divergence_bytes")
            age = p.get("last_success_age_s")
            lines.append(
                f"  {pname[:16]:<16} "
                f"{('?' if dr is None else str(dr)):>8} "
                f"{('?' if db is None else str(db)):>8} "
                f"{('-' if age is None else f'{age:.2f}'):>9} "
                f"{str(p.get('round', '-')):>6}  "
                f"{'converged' if p.get('converged') else p.get('outcome') or '?'}")
        p99 = mesh.get("exchange_p99_s")
        lines.append(
            f"  exchange p99 "
            f"{('-' if p99 is None else f'{p99:.4f}s')} over "
            f"{mesh.get('exchange_count', 0)} exchange(s)")
        for tname, r in sorted(gossip.items()):
            for peer, q in sorted((r.get("quarantine") or {}).items()):
                lines.append(
                    f"  quarantine {r.get('replica') or tname}: {peer} "
                    f"arm={q.get('arm')} frame={q.get('frame')} "
                    f"offset={q.get('offset')}")
    wc = sample.get("wirecost") or {}
    if wc:
        # the wire cost matrix: per directed link the
        # goodput/overhead split and the tiling residual; per fan-out
        # link the amplification factor
        lines.append(bar)
        lines.append(f"  {'cost link':<22} {'bytes':>10} {'goodput':>8} "
                     f"{'overhead':>9} {'resid':>6} {'saved':>8}")
        for lname, r in sorted((wc.get("links") or {}).items()):
            gf, ov = r.get("goodput_fraction"), r.get("overhead_ratio")
            rb = r.get("residual_bytes")
            lines.append(
                f"  {lname[:22]:<22} "
                f"{r.get('ledger_bytes', 0):>10} "
                f"{('?' if gf is None else f'{gf:.3f}'):>8} "
                f"{('?' if ov is None else f'{ov:.3f}'):>9} "
                f"{('?' if rb is None else str(rb)):>6} "
                f"{r.get('batch_saved_bytes', 0):>8}")
        for aname, a in sorted((wc.get("amplification") or {}).items()):
            ampf = a.get("amplification")
            lines.append(
                f"  amplification {aname}: "
                f"{('?' if ampf is None else f'{ampf:.2f}x')} "
                f"({a.get('delivered_bytes', 0)} delivered / "
                f"{a.get('source_bytes', 0)} source, "
                f"{len(a.get('peers') or {})} peer(s))")
    lines.append(bar)
    rec = sample.get("reconcile") or {}
    lines.append(
        f"  shed={sample.get('shed', 0)} "
        f"rejected={sample.get('rejected', 0)} "
        f"reconcile_rounds={rec.get('rounds', 0)} "
        f"symbols={int(rec.get('symbols_seen', 0))} "
        f"diff={int(rec.get('decoded_diff', 0))}")
    return "\n".join(lines)


def run_dashboard(targets, interval: float = 2.0,
                  max_polls: Optional[int] = None, out=None) -> int:
    """The live TTY loop: clear, render, sleep.  ``max_polls`` bounds
    the loop (tests, one-shot inspection); Ctrl-C exits cleanly."""
    out = out if out is not None else sys.stdout
    view = FleetView(targets)
    n = 0
    try:
        while max_polls is None or n < max_polls:
            sample = view.poll(healthz=True)
            frame = render_dashboard(view, sample)
            if out.isatty():
                print("\x1b[2J\x1b[H" + frame, file=out, flush=True)
            else:
                print(frame, file=out, flush=True)
            n += 1
            if max_polls is None or n < max_polls:
                time.sleep(interval)
    except KeyboardInterrupt:
        pass
    return 0
