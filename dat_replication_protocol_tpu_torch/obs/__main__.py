"""The offline telemetry CLI: timelines, traces, bundles, doctors, gates.

A copy of ``dat_replication_protocol_tpu/obs/__main__.py``; it reads
files and HTTP and launches no kernel::

    python -m dat_replication_protocol_tpu_torch.obs timeline SENDER.jsonl RECEIVER.jsonl [PEER.jsonl ...]
    python -m dat_replication_protocol_tpu_torch.obs export-trace LOG.jsonl|BUNDLE_DIR [-o OUT] [--like PROFILER_TRACE.json]
    python -m dat_replication_protocol_tpu_torch.obs dump BUNDLE_DIR [--json]
    python -m dat_replication_protocol_tpu_torch.obs loopdoctor LOG.jsonl|BUNDLE_DIR [--threshold S] [--json]
    python -m dat_replication_protocol_tpu_torch.obs meshdoctor LOG... [--json]
    python -m dat_replication_protocol_tpu_torch.obs costdoctor LOG... [--max-overhead R] [--json]
    python -m dat_replication_protocol_tpu_torch.obs fleet TARGET... [--check SLO.json | --watch]

``timeline`` merges N peers' JSONL logs (``obs.tracing.attach_jsonl_sink``)
into one timeline ordered by wire offset: a frame starts at the same
offset at both ends, so no clocks are compared.  Two logs run the
sender/receiver audit; more pair each dispatch stream with its emitting
peer (by ``link`` label, else by coverage).  Flags: ``gap``,
``reorder``, ``duplicate``, ``peer-divergence``; exit 1 on any.

``export-trace`` writes a log or a flight bundle as Chrome trace-event
JSON, in the records' monotonic microseconds; ``--like`` moves them onto
a ``torch.profiler`` trace's axis (its ``baseTimeNanoseconds``) through
the ``obs.clock`` anchors of the log or the bundle's manifest, so the
two files share one time axis, and refuses records with no anchor (exit
2).  ``dump`` renders a flight bundle (``--json`` for tools).

``loopdoctor`` reads the edge loop's ``edge.turn`` spans: it checks that
the recorded turns tile the loop's wall time (``tile-gap`` /
``tile-overlap``), totals the phases, finds stall turns (work past the
threshold) and names the sessions that held them
(``stall-dominance``, ``unattributed-stall``).

``meshdoctor`` reads the gossip plane's records (``gossip.mesh``,
``gossip.hold``, ``gossip.frontier`` events and ``gossip.exchange``
spans) from N logs, rebuilds which exchange first delivered each digest
to each replica, and flags ``orphaned-digest``, ``stalled-link``,
``asymmetric-link`` and ``rounds-bound-exceeded``.

``costdoctor`` rebuilds the wire cost ledger from the frame instants,
splits framing from payload by inverting the framing arithmetic, and
flags ``unattributed-bytes``, ``overhead-anomaly`` and
``amplification-regression`` (from ``--stats-fd`` records in the logs).

``fleet`` polls targets through :mod:`.fleet`: one joined sample as
JSON, ``--watch`` for the dashboard, ``--check SLO.json`` for the gate
(exit 1 on breach).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from .flight import read_bundle
from .tracing import export_chrome_trace, rebase

# span names that tag one frame (or one native-dispatch run of frames)
# with its wire start offset; "action" distinguishes the two roles
FRAME_SPANS = {
    "encoder.frame": "emit",
    "decoder.frame": "dispatch",
    "decoder.frame.run": "dispatch",
}

# event fields that carry a wire offset (used to slot non-frame records
# onto the offset axis)
_OFFSET_FIELDS = ("offset", "wire_offset", "at")


def _load_jsonl(path: str) -> list[dict]:
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            try:
                records.append(json.loads(ln))
            except json.JSONDecodeError:
                # a torn FINAL line is expected when a sink latched
                # dead mid-record; keep it visible but unkeyed
                records.append({"_unparsed": ln})
    return records


def _frames(records: list[dict]) -> list[dict]:
    """Extract frame records (offset, wire_len, frames, kind) in file
    order — the per-peer audit unit."""
    out = []
    for i, r in enumerate(records):
        name = r.get("span")
        action = FRAME_SPANS.get(name)
        if action is None:
            continue
        f = r.get("fields") or {}
        off, wl = f.get("offset"), f.get("wire_len")
        if off is None or wl is None:
            continue
        out.append({
            "i": i, "seq": r.get("seq", i), "offset": off, "wire_len": wl,
            "frames": f.get("frames", 1), "kind": f.get("kind"),
            "action": action, "name": name, "link": f.get("link"),
        })
    return out


def _stream_link(frames: list[dict]):
    """The session label a frame stream carries (the first record's
    ``link`` field), or None — the N-log pairing key."""
    for fr in frames:
        if fr.get("link"):
            return fr["link"]
    return None


def _audit_role(role: str, frames: list[dict]) -> list[dict]:
    """Flag gaps / reorders / duplicates in ONE direction of one peer's
    frame stream.  Callers split a file's records by action first: a
    duplex peer (the sidecar mirrors its request-side dispatch tags AND
    its reply-side emission tags into one log) carries two independent
    wire streams whose offsets both start at 0 — auditing them as one
    stream would flag a clean session."""
    flags: list[dict] = []
    prev_off: Optional[int] = None
    for fr in frames:  # emission/dispatch order = file order
        if prev_off is not None and fr["offset"] < prev_off:
            flags.append({"flag": "reorder", "role": role,
                          "offset": fr["offset"],
                          "detail": f"frame at offset {fr['offset']} "
                                    f"recorded after offset {prev_off}"})
        prev_off = fr["offset"]
    end: Optional[int] = None
    for fr in sorted(frames, key=lambda fr: (fr["offset"], fr["i"])):
        if end is not None:
            if fr["offset"] < end:
                flags.append({"flag": "duplicate", "role": role,
                              "offset": fr["offset"],
                              "detail": f"frame coverage at offset "
                                        f"{fr['offset']} overlaps bytes "
                                        f"already covered up to {end}"})
            elif fr["offset"] > end:
                flags.append({"flag": "gap", "role": role, "offset": end,
                              "missing": fr["offset"] - end,
                              "detail": f"{fr['offset'] - end} byte(s) of "
                                        f"frame coverage missing at "
                                        f"offset {end}"})
        end = fr["offset"] + fr["wire_len"] if end is None else max(
            end, fr["offset"] + fr["wire_len"])
    return flags


def _coverage(frames: list[dict]) -> tuple[int, int]:
    """(covered bytes, end offset) of a peer's frame stream."""
    total = sum(fr["wire_len"] for fr in frames)
    endo = max((fr["offset"] + fr["wire_len"] for fr in frames), default=0)
    return total, endo


def _record_offset(rec: dict) -> Optional[int]:
    f = rec.get("fields") or {}
    for k in _OFFSET_FIELDS:
        v = f.get(k)
        if isinstance(v, (int, float)):
            return int(v)
    return None


def _merge_timeline(sender: list[dict], receiver: list[dict]) -> list[dict]:
    """Two-peer merge (the classic shape): delegates to the N-peer
    merge with the canonical sender/receiver roles."""
    return _merge_timeline_n([("sender", sender), ("receiver", receiver)])


def _merge_timeline_n(peers: list[tuple[str, list[dict]]]) -> list[dict]:
    """One causally-ordered merged timeline over N peers: primary key
    is the wire offset (earlier-listed peers first at equal offsets —
    CLI order puts emitters before their dispatchers, emission causes
    dispatch); records without an offset of their own inherit the last
    offset seen in their file, preserving their local order."""
    rows: list[dict] = []
    for rank, (role, records) in enumerate(peers):
        last = 0
        for i, r in enumerate(records):
            off = _record_offset(r)
            keyed = off is not None
            if off is None:
                off = last
            else:
                last = off
            rows.append({
                "offset": off, "role": role, "i": i, "keyed": keyed,
                "name": r.get("event") or r.get("span") or "?",
                "kind": "event" if "event" in r else (
                    "span" if "span" in r else "?"),
                "fields": r.get("fields") or {},
                "ts": r.get("ts"),
                "rank": rank,
            })
    rows.sort(key=lambda w: (w["offset"], w["rank"], w["i"]))
    return rows


def _timeline_n(paths: list[str], json_out: bool) -> int:
    """The N-log merge (>= 3 peers): audit every file's emit/dispatch
    streams independently, pair each dispatch stream with its emitting
    peer (exact ``link`` label first, best coverage match as fallback —
    one emitter may serve many dispatchers, the fan-out shape), flag
    per-pair divergence, and merge everything onto the one wire-offset
    axis.  The offline mirror of the fleet aggregator's live join."""
    names: list[str] = []
    for p in paths:
        base = os.path.basename(p)
        # duplicate basenames must stay distinguishable in roles
        names.append(base if base not in names else p)
    files = [(name, _load_jsonl(p)) for name, p in zip(names, paths)]
    flags: list[dict] = []
    streams = []
    for name, records in files:
        by = {a: [f for f in _frames(records) if f["action"] == a]
              for a in ("emit", "dispatch")}
        for action, frames in by.items():
            flags.extend(_audit_role(f"{name}:{action}", frames))
        streams.append({"name": name, "records": records, "by": by})
    emitters = [s for s in streams if s["by"]["emit"]]
    links: list[dict] = []
    for s in streams:
        disp = s["by"]["dispatch"]
        if not disp:
            continue
        cands = [e for e in emitters if e is not s]
        if not cands:
            flags.append({
                "flag": "peer-divergence", "role": f"{s['name']}:dispatch",
                "offset": 0,
                "detail": f"{s['name']} dispatched frames but no other "
                          f"peer emitted any — unpaired wire"})
            continue
        label = _stream_link(disp)
        if label is not None:
            labeled = [e for e in cands
                       if _stream_link(e["by"]["emit"]) == label]
            if labeled:
                cands = labeled
        d_cov, d_end = _coverage(disp)
        emitter = min(cands, key=lambda e: (
            abs(_coverage(e["by"]["emit"])[1] - d_end)
            + abs(_coverage(e["by"]["emit"])[0] - d_cov)))
        e_cov, e_end = _coverage(emitter["by"]["emit"])
        link = label or f"{emitter['name']}->{s['name']}"
        links.append({
            "link": link, "emitter": emitter["name"],
            "dispatcher": s["name"],
            "emit_covered": e_cov, "emit_end": e_end,
            "dispatch_covered": d_cov, "dispatch_end": d_end,
        })
        if (e_cov, e_end) != (d_cov, d_end):
            flags.append({
                "flag": "peer-divergence", "role": link,
                "offset": min(e_end, d_end),
                "detail": f"link {link}: emitter {emitter['name']} "
                          f"covered {e_cov} byte(s) ending at {e_end}, "
                          f"dispatcher {s['name']} {d_cov} ending at "
                          f"{d_end}"})
    rows = _merge_timeline_n([(s["name"], s["records"]) for s in streams])
    peers = {s["name"]: {
        "frames": len(s["by"]["emit"]) + len(s["by"]["dispatch"]),
        "emit": list(_coverage(s["by"]["emit"])),
        "dispatch": list(_coverage(s["by"]["dispatch"])),
    } for s in streams}
    if json_out:
        print(json.dumps({"flags": flags, "peers": peers, "links": links,
                          "timeline": rows}))
    else:
        for w in rows:
            mark = "@" if w["keyed"] else "~"
            extra = ""
            if w["fields"]:
                extra = " " + " ".join(
                    f"{k}={v}" for k, v in sorted(w["fields"].items()))
            print(f"{mark}{w['offset']:<10} {w['role']:<16} "
                  f"{w['name']}{extra}")
        for name, rec in peers.items():
            print(f"-- {name}: {rec['frames']} frame record(s), "
                  f"emit {rec['emit'][0]}B/end {rec['emit'][1]}, "
                  f"dispatch {rec['dispatch'][0]}B/end "
                  f"{rec['dispatch'][1]}")
        for ln in links:
            print(f"-- link {ln['link']}: {ln['emitter']} -> "
                  f"{ln['dispatcher']}, {ln['emit_covered']} -> "
                  f"{ln['dispatch_covered']} byte(s)")
        if flags:
            for fl in flags:
                print(f"FLAG {fl['flag']} [{fl['role']}] @{fl['offset']}: "
                      f"{fl['detail']}")
        else:
            print("-- clean: no gaps, reorders, or duplicate deliveries")
    return 1 if flags else 0


def cmd_timeline(args) -> int:
    if args.peers:
        return _timeline_n([args.sender, args.receiver, *args.peers],
                           args.json)
    sender = _load_jsonl(args.sender)
    receiver = _load_jsonl(args.receiver)
    # split each peer's frames by direction: emissions and dispatches
    # are separate wire streams (a duplex peer logs both)
    s_by = {a: [f for f in _frames(sender) if f["action"] == a]
            for a in ("emit", "dispatch")}
    r_by = {a: [f for f in _frames(receiver) if f["action"] == a]
            for a in ("emit", "dispatch")}
    flags: list[dict] = []
    for role, by in (("sender", s_by), ("receiver", r_by)):
        for action, frames in by.items():
            flags.extend(_audit_role(f"{role}:{action}", frames))
    # cross-peer coverage: one check per wire direction, each side of
    # the pair present — forward (sender emits, receiver dispatches)
    # and, for duplex logs, reverse (receiver emits, sender dispatches)
    for label, a, b in (("forward", s_by["emit"], r_by["dispatch"]),
                        ("reverse", r_by["emit"], s_by["dispatch"])):
        if not (a and b):
            continue
        (a_cov, a_end), (b_cov, b_end) = _coverage(a), _coverage(b)
        if a_cov != b_cov or a_end != b_end:
            flags.append({
                "flag": "peer-divergence", "role": label,
                "offset": min(a_end, b_end),
                "detail": f"{label} wire: emitter covered {a_cov} byte(s) "
                          f"ending at {a_end}, dispatcher {b_cov} ending "
                          f"at {b_end}",
            })
    sf = s_by["emit"] + s_by["dispatch"]
    rf = r_by["emit"] + r_by["dispatch"]
    (s_cov, s_end), (r_cov, r_end) = _coverage(sf), _coverage(rf)
    rows = _merge_timeline(sender, receiver)
    if args.json:
        print(json.dumps({
            "flags": flags,
            "sender": {"frames": len(sf), "covered": s_cov, "end": s_end},
            "receiver": {"frames": len(rf), "covered": r_cov, "end": r_end},
            "timeline": rows,
        }))
    else:
        for w in rows:
            mark = "@" if w["keyed"] else "~"
            extra = ""
            if w["fields"]:
                extra = " " + " ".join(
                    f"{k}={v}" for k, v in sorted(w["fields"].items()))
            print(f"{mark}{w['offset']:<10} {w['role']:<8} {w['name']}{extra}")
        print(f"-- sender: {len(sf)} frame record(s), {s_cov} byte(s) "
              f"covered, end {s_end}")
        print(f"-- receiver: {len(rf)} frame record(s), {r_cov} byte(s) "
              f"covered, end {r_end}")
        if flags:
            for fl in flags:
                print(f"FLAG {fl['flag']} [{fl['role']}] @{fl['offset']}: "
                      f"{fl['detail']}")
        else:
            print("-- clean: no gaps, reorders, or duplicate deliveries")
    return 1 if flags else 0


def cmd_export_trace(args) -> int:
    clock = None
    if os.path.isdir(args.log):
        bundle = read_bundle(args.log)
        records = bundle["spans"] + bundle["events"]
        clock = bundle["manifest"].get("clock")
        default_out = os.path.join(args.log, "trace.json")
    else:
        records = _load_jsonl(args.log)
        default_out = args.log + ".trace.json"
    base_ns = None
    if args.like:
        with open(args.like, encoding="utf-8") as f:
            base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
        try:
            records = rebase(records, base_ns, clock)
        except ValueError as e:
            print(f"export-trace: {args.log}: {e}", file=sys.stderr)
            return 2
    spans = [r for r in records if "span" in r]
    events = [r for r in records if "event" in r]
    out = export_chrome_trace(args.out or default_out, spans, events,
                              base_ns)
    with open(out, encoding="utf-8") as f:
        n = len(json.load(f)["traceEvents"])
    print(f"{out}: {n} trace event(s)")
    return 0


def cmd_dump(args) -> int:
    bundle = read_bundle(args.bundle)
    if args.json:
        print(json.dumps(bundle))
        return 0
    man = bundle["manifest"]
    print(f"bundle: {bundle['path']}")
    print(f"reason: {man.get('reason')}  pid: {man.get('pid')}  "
          f"ts: {man.get('ts')}")
    err = man.get("error")
    if err:
        print(f"error: {err.get('type')}: {err.get('message')}")
        print(f"  coordinates: frame={err.get('frame')} "
              f"offset={err.get('offset')} cause={err.get('cause')}")
    ckpt = man.get("checkpoint")
    if ckpt:
        print(f"checkpoint: {ckpt}")
    extra = man.get("extra")
    if extra:
        # e.g. the backend-init watchdog's stuck stage + stage timeline
        print(f"extra: {extra}")
    for plan in man.get("fault_plans", []):
        active = {k: v for k, v in plan.items()
                  if v not in (None, 0, 0.0) or k == "seed"}
        print(f"fault plan: {active}")
    faults = [e for e in bundle["events"]
              if str(e.get("event", "")).startswith("fault.")]
    for e in faults:
        print(f"injected: {e['event']} {e.get('fields')}")
    print(f"events: {len(bundle['events'])} record(s) "
          f"(dropped {man.get('events_dropped')}), "
          f"spans: {len(bundle['spans'])} record(s) "
          f"(dropped {man.get('spans_dropped')})")
    counters = bundle["metrics"].get("counters", {})
    nonzero = {k: v for k, v in sorted(counters.items()) if v}
    print(f"counters (nonzero): {nonzero}")
    return 0


# -- loopdoctor: offline event-loop stall attribution -------------

# the edge.turn span's phase field names, in the loop's phase order
_TURN_PHASES = ("poll_wait", "accept", "read", "hub_drain", "tx",
                "overload_ladder")

# tiling tolerance: edge.turn spans are change-only but EXACT — each
# span's ts is the previous recorded span's end, float-identical.  The
# epsilon only absorbs JSON round-tripping of the floats.
_TILE_TOL = 1e-6


def _loopdoctor_analyze(spans: list[dict],
                        threshold: Optional[float] = None) -> dict:
    """Attribute loop stall time to phases and sessions from
    ``edge.turn`` spans (the loopprof capture).  Returns
    ``{"loops": {name: report}, "flags": [...]}``; flags:

    * ``tile-gap`` / ``tile-overlap`` — consecutive turn spans do not
      tile the loop's wall time (a profiler bug, not a workload one);
    * ``stall-dominance`` — one session holds more than the stall
      threshold of work inside overrun turns: the doctor names the
      session AND the phase the time went to;
    * ``unattributed-stall`` — an overrun turn carries no session
      capture (the profiler should attach top-K on every lagging turn).

    The stall threshold defaults to ``max(4 * tick, 0.03)`` per loop
    (from the span's own ``tick`` field) — a turn is a stall when its
    non-poll work alone spans multiple ticks."""
    by_loop: dict = {}
    for r in spans:
        if r.get("span") != "edge.turn":
            continue
        f = r.get("fields") or {}
        by_loop.setdefault(str(f.get("loop", "?")), []).append((r, f))
    flags: list[dict] = []
    loops: dict = {}
    for lname, recs in sorted(by_loop.items()):
        recs.sort(key=lambda rf: float(rf[0].get("ts") or 0.0))
        tick = 0.05
        for _r, f in recs:
            if isinstance(f.get("tick"), (int, float)) and f["tick"] > 0:
                tick = float(f["tick"])
                break
        thr = (float(threshold) if threshold is not None
               else max(4.0 * tick, 0.03))
        phase_s = {name: 0.0 for name in _TURN_PHASES}
        sessions: dict = {}
        stall_sessions: dict = {}
        prev_end: Optional[float] = None
        turns = 0
        lag_max = 0.0
        stall_s = 0.0
        stall_turns = 0
        for r, f in recs:
            ts = float(r.get("ts") or 0.0)
            dur = float(r.get("dur") or 0.0)
            if prev_end is not None:
                delta = ts - prev_end
                if delta > _TILE_TOL:
                    flags.append({
                        "flag": "tile-gap", "loop": lname, "ts": ts,
                        "detail": f"{delta:.6f}s of loop wall time "
                                  f"missing before the span at "
                                  f"ts={ts:.6f}"})
                elif delta < -_TILE_TOL:
                    flags.append({
                        "flag": "tile-overlap", "loop": lname, "ts": ts,
                        "detail": f"span at ts={ts:.6f} overlaps the "
                                  f"previous turn by {-delta:.6f}s"})
            prev_end = ts + dur
            turns += int(f.get("turns") or 1)
            for name in _TURN_PHASES:
                v = f.get(name + "_s")
                if isinstance(v, (int, float)):
                    phase_s[name] += float(v)
            work = float(f.get("work_s") or 0.0)
            lag = float(f.get("lag_s") or 0.0)
            lag_max = max(lag_max, lag)
            top = f.get("top") or []
            for ent in top:
                key = str(ent.get("session", "?"))
                s = sessions.setdefault(
                    key, {"seconds": 0.0, "bytes": 0, "phases": {}})
                sec = float(ent.get("seconds") or 0.0)
                s["seconds"] += sec
                s["bytes"] += int(ent.get("bytes") or 0)
                ph = str(ent.get("phase", "?"))
                s["phases"][ph] = s["phases"].get(ph, 0.0) + sec
            if work > thr:
                stall_s += work
                stall_turns += 1
                if not top:
                    flags.append({
                        "flag": "unattributed-stall", "loop": lname,
                        "ts": ts,
                        "detail": f"turn work {work:.3f}s exceeds the "
                                  f"{thr:.3f}s stall threshold with no "
                                  f"session capture"})
                for ent in top:
                    key = str(ent.get("session", "?"))
                    s = stall_sessions.setdefault(
                        key, {"seconds": 0.0, "bytes": 0, "phases": {}})
                    sec = float(ent.get("seconds") or 0.0)
                    s["seconds"] += sec
                    s["bytes"] += int(ent.get("bytes") or 0)
                    ph = str(ent.get("phase", "?"))
                    s["phases"][ph] = s["phases"].get(ph, 0.0) + sec
        for key, s in sorted(stall_sessions.items(),
                             key=lambda kv: kv[1]["seconds"],
                             reverse=True):
            if s["seconds"] <= thr:
                continue
            phase = max(s["phases"].items(),
                        key=lambda kv: kv[1])[0] if s["phases"] else "?"
            flags.append({
                "flag": "stall-dominance", "loop": lname,
                "session": key, "phase": phase,
                "seconds": round(s["seconds"], 6),
                "detail": f"session {key} holds "
                          f"{s['seconds']:.3f}s of stall work, "
                          f"dominated by the {phase} phase"})
        final_lag = float(recs[-1][1].get("lag_s") or 0.0) if recs \
            else 0.0
        wall = (prev_end - float(recs[0][0].get("ts") or 0.0)) \
            if recs else 0.0
        loops[lname] = {
            "spans": len(recs),
            "turns": turns,
            "tick": tick,
            "threshold_s": round(thr, 6),
            "wall_s": round(wall, 6),
            "phase_s": {k: round(v, 6) for k, v in phase_s.items()},
            "final_lag_s": final_lag,
            "lag_max_s": round(lag_max, 6),
            "stall_s": round(stall_s, 6),
            "stall_turns": stall_turns,
            "sessions": {k: {"seconds": round(v["seconds"], 6),
                             "bytes": v["bytes"],
                             "phases": {p: round(sv, 6) for p, sv
                                        in v["phases"].items()}}
                         for k, v in sessions.items()},
        }
    return {"loops": loops, "flags": flags}


def cmd_loopdoctor(args) -> int:
    if os.path.isdir(args.log):
        bundle = read_bundle(args.log)
        spans = bundle["spans"]
    else:
        spans = [r for r in _load_jsonl(args.log) if "span" in r]
    report = _loopdoctor_analyze(spans, threshold=args.threshold)
    flags = report["flags"]
    if args.json:
        print(json.dumps(report))
        return 1 if flags else 0
    if not report["loops"]:
        print("no edge.turn spans found: the loop either never ran lit "
              "(obs gate off) or the log predates the flight deck")
        return 0
    for lname, rec in sorted(report["loops"].items()):
        print(f"loop {lname}: {rec['turns']} turn(s) in "
              f"{rec['spans']} span(s), wall {rec['wall_s']:.3f}s, "
              f"tick {rec['tick']}s")
        busy = {k: v for k, v in rec["phase_s"].items() if v}
        print(f"  phases: " + (", ".join(
            f"{k}={v:.3f}s" for k, v in sorted(
                busy.items(), key=lambda kv: kv[1], reverse=True))
            or "(idle)"))
        print(f"  lag: final {rec['final_lag_s']:.3f}s, "
              f"max {rec['lag_max_s']:.3f}s; stalls: "
              f"{rec['stall_turns']} turn(s), {rec['stall_s']:.3f}s "
              f"(threshold {rec['threshold_s']:.3f}s)")
        heavy = sorted(rec["sessions"].items(),
                       key=lambda kv: kv[1]["seconds"], reverse=True)[:5]
        for key, s in heavy:
            print(f"  session {key}: {s['seconds']:.3f}s, "
                  f"{s['bytes']} byte(s)")
    if flags:
        for fl in flags:
            where = fl.get("session") or fl.get("ts", "-")
            print(f"FLAG {fl['flag']} [{fl['loop']}] {where}: "
                  f"{fl['detail']}")
    else:
        print("-- clean: spans tile, no stall dominance")
    return 1 if flags else 0


# -- meshdoctor: offline gossip-convergence attribution -----------

# an exchange direction that moved (or proved empty) the diff vs one
# that failed: the vocabulary obs/propagation.py records
_X_OK = ("converged", "progress")
_X_FAIL = ("transport",)


def _mesh_records(paths: list[str]) -> tuple[list[dict], list[dict]]:
    """Events + spans from N JSONL logs / flight bundles, merged."""
    events: list[dict] = []
    spans: list[dict] = []
    for path in paths:
        if os.path.isdir(path):
            bundle = read_bundle(path)
            events.extend(bundle["events"])
            spans.extend(bundle["spans"])
        else:
            for r in _load_jsonl(path):
                if "span" in r:
                    spans.append(r)
                elif "event" in r:
                    events.append(r)
    return events, spans


def _dedupe_exchanges(spans: list[dict]) -> list[dict]:
    """One record per exchange: the in-process engine records BOTH
    directions of every exchange (initiator + responder views of the
    same peel), keyed here by (round, dialer, dialee) with the
    initiator's view preferred — its ``delivered``/``delivered_peer``
    orientation is the canonical one.  One-sided records (live dials,
    refusals, dead peers) pass through unchanged."""
    best: dict = {}
    order: list = []
    for r in spans:
        if r.get("span") != "gossip.exchange":
            continue
        f = r.get("fields") or {}
        role = f.get("role")
        me, peer = str(f.get("replica")), str(f.get("peer"))
        dialer, dialee = (me, peer) if role == "initiator" else (peer, me)
        key = (int(f.get("round") or 0), dialer, dialee)
        cur = best.get(key)
        if cur is None:
            best[key] = r
            order.append(key)
        elif role == "initiator" and \
                (cur.get("fields") or {}).get("role") != "initiator":
            best[key] = r
    out = []
    for key in order:
        r = best[key]
        f = dict(r.get("fields") or {})
        rnd, dialer, dialee = key
        if f.get("role") == "initiator":
            deliv_dialer = list(f.get("delivered") or ())
            deliv_dialee = list(f.get("delivered_peer") or ())
        else:
            deliv_dialer = list(f.get("delivered_peer") or ())
            deliv_dialee = list(f.get("delivered") or ())
        out.append({
            "round": rnd, "dialer": dialer, "dialee": dialee,
            "outcome": f.get("outcome"), "error": f.get("error"),
            "seconds": f.get("seconds"), "diff": f.get("diff"),
            "wire_bytes": f.get("wire_bytes"),
            "delivered_dialer": deliv_dialer,
            "delivered_dialee": deliv_dialee,
            "ts": float(r.get("ts") or 0.0),
        })
    out.sort(key=lambda x: (x["round"], x["ts"]))
    return out


def _link_runs(rounds_events: list[tuple[int, bool]]) -> list[list[int]]:
    """Maximal runs of DISTINCT failure rounds uninterrupted by a
    success, over (round, ok) observations sorted by round.  Rounds
    with no observation do not break a run — a partitioned pair is
    only sampled some rounds, and the stall spans the gap."""
    runs: list[list[int]] = []
    cur: list[int] = []
    for rnd, ok in rounds_events:
        if ok:
            if cur:
                runs.append(cur)
            cur = []
        elif not cur or cur[-1] != rnd:
            cur.append(rnd)
    if cur:
        runs.append(cur)
    return runs


def _meshdoctor_analyze(events: list[dict], spans: list[dict]) -> dict:
    """Reconstruct the per-record propagation tree and attribute
    convergence (or its failure) to exact links/rounds/quarantines.
    Flags:

    * ``orphaned-digest`` — an exchange delivered a digest its sender
      was never recorded holding (provenance break: a hold record is
      missing, or the mesh shipped content from nowhere);
    * ``stalled-link`` — an undirected pair failed transport in >= 2
      DISTINCT rounds with no successful exchange in between (the
      partition signature: one-shot chaos faults fire in at most one
      round per link, so a repeat offender is a cut, not a bad cable);
    * ``asymmetric-link`` — one DIRECTION failed >= 2 distinct rounds
      while the reverse direction succeeded inside the same span (a
      half-open link: NAT, a one-way filter, an asymmetric route);
    * ``rounds-bound-exceeded`` — the mesh converged after the
      ``gossip.mesh`` record's ``rounds_bound()`` budget, or never
      converged within it.

    A clean converged log flags nothing and reports final divergence
    exactly 0 (``distinct_frontiers == 1``)."""
    mesh = None
    for r in events:
        if r.get("event") == "gossip.mesh":
            mesh = dict(r.get("fields") or {})
    holds = [r for r in events if r.get("event") == "gossip.hold"]
    frontiers = [r for r in events if r.get("event") == "gossip.frontier"]
    quarantines = [dict((r.get("fields") or {}), ts=r.get("ts"))
                   for r in events
                   if r.get("event") == "gossip.quarantine"]
    exchanges = _dedupe_exchanges(spans)
    flags: list[dict] = []

    # -- the propagation tree: first delivery of each digest ------------------
    holding: dict[str, set] = {}
    tree: dict[str, dict] = {}
    check_provenance = bool(holds)

    def acquire(replica: str, digest: str, rnd: int, via: str) -> None:
        holding.setdefault(replica, set()).add(digest)
        tree.setdefault(digest, {}).setdefault(
            replica, {"round": rnd, "via": via})

    items: list[tuple] = []
    for r in holds:
        f = r.get("fields") or {}
        items.append((int(f.get("round") or 0), float(r.get("ts") or 0.0),
                      0, ("hold", f)))
    for x in exchanges:
        items.append((x["round"], x["ts"], 1, ("exchange", x)))
    items.sort(key=lambda it: it[:3])
    for rnd, _ts, _k, (kind, payload) in items:
        if kind == "hold":
            rep = str(payload.get("replica"))
            for d in payload.get("digests") or ():
                acquire(rep, str(d), rnd, "hold")
            continue
        x = payload
        for receiver, sender, digests in (
                (x["dialer"], x["dialee"], x["delivered_dialer"]),
                (x["dialee"], x["dialer"], x["delivered_dialee"])):
            for d in digests:
                d = str(d)
                if check_provenance and sender in holding \
                        and d not in holding[sender]:
                    flags.append({
                        "flag": "orphaned-digest", "digest": d,
                        "link": f"{sender}->{receiver}", "round": rnd,
                        "detail": f"exchange at round {rnd} delivered "
                                  f"digest {d} to {receiver}, but sender "
                                  f"{sender} was never recorded holding "
                                  f"it (provenance break)"})
                acquire(receiver, d, rnd,
                        f"exchange:{sender}->{receiver}")

    # -- link health: stalls and asymmetry ------------------------------------
    by_dir: dict[tuple, list] = {}
    for x in exchanges:
        if x["outcome"] in _X_OK or x["outcome"] in _X_FAIL:
            by_dir.setdefault((x["dialer"], x["dialee"]), []).append(
                (x["round"], x["outcome"] in _X_OK))
    pairs: dict[tuple, list] = {}
    for (a, b), obs in by_dir.items():
        pairs.setdefault(tuple(sorted((a, b))), []).extend(obs)
    for pair, obs in sorted(pairs.items()):
        obs.sort()
        for run in _link_runs(obs):
            if len(run) >= 2:
                flags.append({
                    "flag": "stalled-link",
                    "link": f"{pair[0]}<->{pair[1]}", "rounds": run,
                    "detail": f"link {pair[0]}<->{pair[1]} failed "
                              f"transport in {len(run)} distinct "
                              f"round(s) {run[0]}..{run[-1]} with no "
                              f"successful exchange in between (the "
                              f"partition signature: one-shot chaos "
                              f"faults fire at most once per link)"})
    for (a, b), obs in sorted(by_dir.items()):
        obs.sort()
        rev = sorted(by_dir.get((b, a), ()))
        for run in _link_runs(obs):
            if len(run) < 2:
                continue
            rev_ok = [rnd for rnd, ok in rev
                      if ok and run[0] <= rnd <= run[-1]]
            if rev_ok:
                flags.append({
                    "flag": "asymmetric-link", "link": f"{a}->{b}",
                    "rounds": run,
                    "detail": f"direction {a}->{b} failed transport in "
                              f"{len(run)} distinct round(s) "
                              f"{run[0]}..{run[-1]} while {b}->{a} "
                              f"succeeded in round(s) {rev_ok} — a "
                              f"half-open link, not a partition"})

    # -- convergence vs the bound ---------------------------------------------
    final: dict[str, dict] = {}
    for r in frontiers:
        f = r.get("fields") or {}
        rep = str(f.get("replica"))
        cur = final.get(rep)
        if cur is None or int(f.get("round") or 0) >= cur["round"]:
            final[rep] = {"round": int(f.get("round") or 0),
                          "digest": f.get("digest"),
                          "records": f.get("records")}
    digests = {v["digest"] for v in final.values()}
    converged = bool(final) and len(digests) == 1
    convergence_round = (max(v["round"] for v in final.values())
                         if converged else None)
    bound = int(mesh["bound"]) if mesh and "bound" in mesh else None
    last_round = max([x["round"] for x in exchanges]
                     + [v["round"] for v in final.values()] + [0])
    if bound is not None:
        if converged and convergence_round > bound:
            flags.append({
                "flag": "rounds-bound-exceeded",
                "round": convergence_round,
                "detail": f"mesh converged at round {convergence_round}, "
                          f"past the rounds_bound() budget of {bound}"})
        elif not converged and final and last_round >= bound:
            flags.append({
                "flag": "rounds-bound-exceeded", "round": last_round,
                "detail": f"mesh never converged: {len(digests)} "
                          f"distinct frontiers at round {last_round}, "
                          f"budget {bound}"})

    # -- slow-convergence attribution -----------------------------------------
    # the digests that arrived LAST, and the exact exchange that
    # finally delivered each — the "which link, which round, which
    # record" answer the plane exists for
    last_arrivals = []
    for d, deliveries in tree.items():
        worst = max(deliveries.items(), key=lambda kv: kv[1]["round"])
        last_arrivals.append({"digest": d, "replica": worst[0],
                              "round": worst[1]["round"],
                              "via": worst[1]["via"]})
    last_arrivals.sort(key=lambda e: (-e["round"], e["digest"]))

    return {
        "mesh": mesh,
        "replicas": final,
        "converged": converged,
        "convergence_round": convergence_round,
        "distinct_frontiers": len(digests),
        "bound": bound,
        "exchanges": len(exchanges),
        "quarantines": quarantines,
        "slowest": last_arrivals[:8],
        "tree_digests": len(tree),
        "flags": flags,
    }


def cmd_meshdoctor(args) -> int:
    events, spans = _mesh_records(args.logs)
    report = _meshdoctor_analyze(events, spans)
    if args.json:
        print(json.dumps(report))
        return 1 if report["flags"] else 0
    if not report["exchanges"] and not report["replicas"]:
        print("no gossip.exchange spans or gossip.frontier events "
              "found: the mesh either never ran lit (obs gate off) or "
              "the log predates the convergence plane")
        return 0
    mesh = report["mesh"] or {}
    print(f"mesh: {mesh.get('n', '?')} replica(s), "
          f"seed {mesh.get('seed', '?')}, "
          f"bound {report['bound'] if report['bound'] is not None else '?'}"
          f" — {report['exchanges']} exchange(s), "
          f"{report['tree_digests']} digest(s) tracked")
    if report["converged"]:
        print(f"converged at round {report['convergence_round']} "
              f"(final divergence exactly 0: every frontier "
              f"byte-identical)")
    else:
        print(f"NOT converged: {report['distinct_frontiers']} distinct "
              f"frontier digest(s)")
    for rep, rec in sorted(report["replicas"].items()):
        print(f"  {rep}: round {rec['round']}, "
              f"{rec.get('records', '?')} record(s), "
              f"{(rec.get('digest') or '?')[:16]}")
    for q in report["quarantines"]:
        print(f"  quarantine: {q.get('replica')} cut {q.get('peer')} "
              f"(arm {q.get('arm')}, offset {q.get('offset')})")
    for e in report["slowest"][:4]:
        print(f"  slowest: digest {e['digest']} reached {e['replica']} "
              f"at round {e['round']} via {e['via']}")
    if report["flags"]:
        for fl in report["flags"]:
            where = fl.get("link") or fl.get("digest") or \
                fl.get("round", "-")
            print(f"FLAG {fl['flag']} [{where}]: {fl['detail']}")
    else:
        print("-- clean: provenance intact, no stalled or asymmetric "
              "links, convergence within bound")
    return 1 if report["flags"] else 0


# -- costdoctor: offline wire-cost ledger audit -------------------


def _cost_records(paths: list[str]) -> tuple[list, list]:
    """Per-origin span records + stats-fd ``wirecost`` sections from N
    JSONL logs / flight bundles.  Unlike :func:`_mesh_records` the file
    origin is kept: frame streams without an explicit ``link`` label
    are keyed by origin (one log = one peer), and the amplification
    series is read per origin in file order."""
    streams: list = []
    stats: list = []
    for path in paths:
        origin = os.path.basename(path.rstrip("/"))
        if os.path.isdir(path):
            bundle = read_bundle(path)
            streams.append((origin, bundle["spans"]))
        else:
            records = _load_jsonl(path)
            streams.append((origin, records))
            for r in records:
                if isinstance(r.get("wirecost"), dict):
                    stats.append((origin, r["wirecost"]))
    return streams, stats


def _split_framing(wire_len: int) -> int:
    """Invert the framing arithmetic: the header length a single frame
    of ``wire_len`` total bytes must carry (header_len is monotone in
    payload length, so the inversion is exact and unique)."""
    from ..wire.framing import header_len
    for hl in range(2, 11):
        p = wire_len - hl
        if p >= 0 and header_len(p) == hl:
            return hl
    return 2


def _costdoctor_analyze(streams: list, stats: list,
                        max_overhead: float,
                        min_goodput: Optional[float]) -> dict:
    """Rebuild the per-stream wire cost ledger from frame instants and
    audit it: coverage must tile (no unattributed bytes), the framing
    overhead must stay under the threshold, and the amplification
    series from stats records must not regress.  Framing is EXACT for
    single-frame records (header inversion); a native dispatch run of
    k frames contributes the 2-byte-per-header lower bound — the
    overhead flag therefore only fires when even the minimum possible
    framing breaches, never on an estimate."""
    flags: list[dict] = []
    ledgers: dict = {}
    for origin, records in streams:
        frames = _frames(records)
        by_stream: dict = {}
        for fr in frames:
            key = (fr.get("link") or origin, fr["action"])
            by_stream.setdefault(key, []).append(fr)
        for (link, action), frs in by_stream.items():
            name = f"{link}|{'tx' if action == 'emit' else 'rx'}"
            classes: dict = {}
            framing_lb = 0
            exact = True
            for fr in frs:
                c = classes.setdefault(
                    fr["kind"] or "?", {"wire": 0, "frames": 0})
                c["wire"] += int(fr["wire_len"])
                c["frames"] += int(fr["frames"])
                if int(fr["frames"]) == 1:
                    framing_lb += _split_framing(int(fr["wire_len"]))
                else:
                    framing_lb += 2 * int(fr["frames"])
                    exact = False
            total = sum(c["wire"] for c in classes.values())
            # coverage audit: frames must tile [start, end) exactly —
            # a hole is wire the ledger cannot attribute to any class
            gaps = overlaps = 0
            cur = None
            for fr in sorted(frs, key=lambda f: f["offset"]):
                off, end = fr["offset"], fr["offset"] + fr["wire_len"]
                if cur is None:
                    cur = end
                elif off > cur:
                    gaps += off - cur
                    cur = end
                else:
                    overlaps += cur - off
                    cur = max(cur, end)
            overhead = (framing_lb / total) if total else None
            ledgers[name] = {
                "classes": classes, "wire_bytes": total,
                "framing_bytes_min": framing_lb,
                "framing_exact": exact,
                "overhead_ratio": overhead,
                "goodput_fraction": (1 - overhead)
                if overhead is not None else None,
                "unattributed_bytes": gaps,
                "overlapping_bytes": overlaps,
            }
            if gaps:
                flags.append({
                    "flag": "unattributed-bytes", "link": name,
                    "detail": f"{gaps} wire byte(s) on {name} fall in "
                              "coverage holes between frame instants — "
                              "bytes no class can account for"})
            if overlaps:
                flags.append({
                    "flag": "unattributed-bytes", "link": name,
                    "detail": f"{overlaps} wire byte(s) on {name} are "
                              "attributed twice (overlapping frames): "
                              "the ledger over-counts the wire"})
            if overhead is not None and overhead > max_overhead:
                qual = "" if exact else "at least "
                flags.append({
                    "flag": "overhead-anomaly", "link": name,
                    "detail": f"framing overhead {qual}{overhead:.4f} "
                              f"on {name} exceeds {max_overhead} "
                              f"({framing_lb}/{total} byte(s))"})
            if min_goodput is not None and overhead is not None \
                    and (1 - overhead) < min_goodput:
                flags.append({
                    "flag": "overhead-anomaly", "link": name,
                    "detail": f"goodput {1 - overhead:.4f} on {name} "
                              f"below the {min_goodput} floor"})
    # amplification series per link, in stats record order: the
    # cumulative delivered/source ratio recovers after transients, so a
    # FINAL value well under the peak means peers stopped draining what
    # the source kept publishing — the under-delivery regression
    amp_series: dict = {}
    residuals: dict = {}
    for _origin, wc in stats:
        for link, view in (wc.get("amplification") or {}).items():
            a = view.get("amplification")
            if a is not None:
                amp_series.setdefault(link, []).append(float(a))
        for lname, rec in (wc.get("links") or {}).items():
            residuals[lname] = rec.get("residual_bytes")
    for link, series in sorted(amp_series.items()):
        peak, final = max(series), series[-1]
        if len(series) >= 2 and final < 0.75 * peak:
            flags.append({
                "flag": "amplification-regression", "link": link,
                "detail": f"amplification on {link} fell to "
                          f"{final:.2f}x from a {peak:.2f}x peak — "
                          "peers are not draining the published "
                          "stream"})
    for lname, rb in sorted(residuals.items()):
        # the live board's own tiling verdict, from the LAST stats
        # record: a nonzero residual at rest is unattributed wire
        if rb is not None and rb != 0:
            flags.append({
                "flag": "unattributed-bytes", "link": lname,
                "detail": f"live ledger residual {rb} byte(s) on "
                          f"{lname}: transport moved wire no class "
                          "accounts for"})
    return {"ledgers": ledgers, "amplification": amp_series,
            "residuals": residuals, "flags": flags}


def cmd_costdoctor(args) -> int:
    streams, stats = _cost_records(args.logs)
    report = _costdoctor_analyze(streams, stats,
                                 max_overhead=args.max_overhead,
                                 min_goodput=args.min_goodput)
    if args.json:
        print(json.dumps(report))
        return 1 if report["flags"] else 0
    if not report["ledgers"] and not report["residuals"] \
            and not report["amplification"]:
        print("no frame instants or wirecost sections found: the wire "
              "cost plane either never ran lit (obs gate off) or the "
              "log predates it")
        return 0
    for name, led in sorted(report["ledgers"].items()):
        ov = led["overhead_ratio"]
        qual = "" if led["framing_exact"] else ">="
        print(f"{name}: {led['wire_bytes']} wire byte(s), "
              f"overhead {qual}"
              f"{('?' if ov is None else f'{ov:.4f}')} — "
              + ", ".join(f"{cls}:{c['wire']}B/{c['frames']}f"
                          for cls, c in sorted(led["classes"].items())))
    for link, series in sorted(report["amplification"].items()):
        print(f"amplification {link}: "
              + " -> ".join(f"{a:.2f}x" for a in series[-6:]))
    if report["flags"]:
        for fl in report["flags"]:
            print(f"FLAG {fl['flag']} [{fl['link']}]: {fl['detail']}")
    else:
        print("-- clean: every wire byte attributed, overhead within "
              "bounds, amplification steady")
    return 1 if report["flags"] else 0


def cmd_fleet(args) -> int:
    from .fleet import FleetView, run_dashboard, run_fleet_check

    if args.check:
        return run_fleet_check(
            args.targets, args.check,
            polls=args.polls if args.polls is not None else 3,
            interval=args.interval)
    if args.watch:
        return run_dashboard(args.targets, interval=args.interval,
                             max_polls=args.polls)
    # one-shot: a single joined sample as JSON (the scripting surface)
    view = FleetView(args.targets)
    polls = args.polls if args.polls is not None else 1
    sample = None
    import time as _time

    for i in range(max(1, polls)):
        if i:
            _time.sleep(args.interval)
        sample = view.poll(healthz=True)
    print(json.dumps(sample, default=repr))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m dat_replication_protocol_tpu_torch.obs",
        description="offline telemetry tools: causal timeline merge, "
                    "Chrome trace export, flight-bundle dumps",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    tl = sub.add_parser(
        "timeline",
        help="merge N JSONL logs into one causally-ordered timeline "
             "keyed on wire offset; flag gaps/reorders/duplicates "
             "(2 logs: the classic sender/receiver audit; more: "
             "per-link pairing, the fleet join's offline mirror)")
    tl.add_argument("sender", help="the sending peer's JSONL event/span log")
    tl.add_argument("receiver", help="the receiving peer's JSONL log")
    tl.add_argument("peers", nargs="*", metavar="PEER",
                    help="further peers' JSONL logs (N-log mode: "
                         "dispatch streams pair with their emitting "
                         "peer by link label, else best coverage match)")
    tl.add_argument("--json", action="store_true",
                    help="machine-readable output")
    tl.set_defaults(fn=cmd_timeline)

    ex = sub.add_parser(
        "export-trace",
        help="convert a JSONL log or a flight bundle into Chrome "
             "trace-event JSON (Perfetto-loadable)")
    ex.add_argument("log", help="JSONL log file, or a bundle directory")
    ex.add_argument("-o", "--out", default=None,
                    help="output path (default: <log>.trace.json)")
    ex.add_argument("--like", default=None, metavar="TRACE",
                    help="a torch.profiler Chrome trace: write times on "
                         "its axis, through the log's obs.clock anchors "
                         "(default: monotonic microseconds)")
    ex.set_defaults(fn=cmd_export_trace)

    dp = sub.add_parser(
        "dump", help="render a flight-recorder bundle directory")
    dp.add_argument("bundle", help="bundle directory (see obs/flight.py)")
    dp.add_argument("--json", action="store_true",
                    help="machine-readable output")
    dp.set_defaults(fn=cmd_dump)

    ld = sub.add_parser(
        "loopdoctor",
        help="attribute event-loop stall time to phases and sessions "
             "from edge.turn spans (JSONL log or flight bundle); "
             "exit 1 on dominance or tiling flags")
    ld.add_argument("log", help="JSONL log file, or a bundle directory")
    ld.add_argument("--threshold", type=float, default=None,
                    metavar="SECONDS",
                    help="stall threshold per turn (default: "
                         "max(4 * tick, 0.03) from each loop's spans)")
    ld.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ld.set_defaults(fn=cmd_loopdoctor)

    md = sub.add_parser(
        "meshdoctor",
        help="reconstruct the per-record propagation tree from "
             "gossip.exchange spans (N JSONL logs / flight bundles), "
             "attribute slow convergence to exact links/rounds/"
             "quarantines; exit 1 on orphaned-digest / stalled-link / "
             "asymmetric-link / rounds-bound-exceeded flags")
    md.add_argument("logs", nargs="+", metavar="LOG",
                    help="JSONL log file(s) and/or bundle directories "
                         "from the mesh's replicas")
    md.add_argument("--json", action="store_true",
                    help="machine-readable output")
    md.set_defaults(fn=cmd_meshdoctor)

    cd = sub.add_parser(
        "costdoctor",
        help="rebuild the per-link wire cost ledger from frame "
             "instants (N JSONL logs / flight bundles) and audit it; "
             "exit 1 on unattributed-bytes / overhead-anomaly / "
             "amplification-regression flags")
    cd.add_argument("logs", nargs="+", metavar="LOG",
                    help="JSONL log file(s), --stats-fd JSONL files, "
                         "and/or bundle directories")
    cd.add_argument("--max-overhead", type=float, default=0.5,
                    metavar="RATIO",
                    help="framing-overhead flag threshold per stream "
                         "(default: 0.5; the flag only fires when even "
                         "the minimum possible framing breaches)")
    cd.add_argument("--min-goodput", type=float, default=None,
                    metavar="FRACTION",
                    help="optional goodput floor per stream (off by "
                         "default)")
    cd.add_argument("--json", action="store_true",
                    help="machine-readable output")
    cd.set_defaults(fn=cmd_costdoctor)

    fl = sub.add_parser(
        "fleet",
        help="poll N replica targets (http:// endpoints and/or "
             "--stats-fd JSONL files), join watermarks into per-link "
             "replication lag; render a live dashboard or gate on a "
             "declarative SLO (exit 1 on breach)")
    fl.add_argument("targets", nargs="+", metavar="TARGET",
                    help="http://host:port scrape endpoint or path to a "
                         "--stats-fd JSONL file")
    fl.add_argument("--check", metavar="SLO.json", default=None,
                    help="evaluate the fleet against a declarative SLO "
                         "file and exit 1 on breach (see "
                         "OBSERVABILITY.md for the schema)")
    fl.add_argument("--watch", action="store_true",
                    help="live TTY dashboard (plain ANSI, one screen "
                         "per poll) instead of a one-shot JSON sample")
    fl.add_argument("--interval", type=float, default=2.0,
                    metavar="SECONDS",
                    help="poll period for --watch / between --check "
                         "polls (default: 2)")
    fl.add_argument("--polls", type=int, default=None, metavar="N",
                    help="stop after N polls (--watch: frames; --check: "
                         "evaluate the final poll; default: --check 3, "
                         "--watch unbounded)")
    fl.set_defaults(fn=cmd_fleet)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
