"""The port's offline CLI (``obs/__main__.py``) against the JAX package's.

Every subcommand of each package's ``main`` runs on the same inputs and
must print the same text (and the same JSON with ``--json``) and exit
with the same code:

* ``timeline``: seeded two-log and N-log frame streams, made with numpy,
  clean and doctored (a dropped frame, a swap, a repeat, a short
  receiver), with link labels, native dispatch runs and keyed and
  unkeyed events between them; and a lit session of the port's encoder
  and decoder logged to two files;
* ``export-trace`` and ``dump``: a seeded log, and flight bundles the
  port's recorder wrote;
* ``loopdoctor``: seeded ``edge.turn`` spans that tile, leave a gap,
  overlap, stall with and without a session capture;
* ``meshdoctor``: lit runs of the port's ``ClusterSim`` (clean and with
  chaos links) logged to a sink, and the reference's hand-made
  asymmetric, orphaned and over-the-bound cases;
* ``costdoctor``: a lit session of the port's encoder, and seeded frames
  with ``--stats-fd`` records (amplification series, residuals);
* ``fleet`` has its own file (``test_torch_obs_fleet.py``).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs.__main__ import main as jmain
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch import CAP_CHANGE_BATCH
from dat_replication_protocol_tpu_torch.cluster import ClusterSim
from dat_replication_protocol_tpu_torch.obs import (
    events, flight, metrics, propagation, tracing, wirecost)
from dat_replication_protocol_tpu_torch.obs.__main__ import main as pmain
from dat_replication_protocol_tpu_torch.session.faults import FaultPlan
from dat_replication_protocol_tpu_torch.session.resume import WireJournal
from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError



def _reset_port() -> None:
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    events.EVENTS.detach_sink()
    tracing.SPANS.clear()
    tracing.SPANS.detach_sink()
    flight.FLIGHT._reset_for_tests()
    propagation.PROPAGATION.reset_for_tests()
    wirecost.WIRECOST.reset_for_tests()


@pytest.fixture
def port_obs():
    was_on = metrics.OBS.on
    _reset_port()
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        _reset_port()


def _both(argv, capsys) -> tuple:
    """Each package's CLI on ``argv``: equal exit codes and stdout."""
    outs = []
    for main in (jmain, pmain):
        rc = main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    return outs[1]


def _write(path, records, torn: bool = False) -> str:
    text = "".join(json.dumps(r) + "\n" for r in records)
    if torn:
        text += '{"span": "encoder.fr'
    Path(path).write_text(text)
    return str(path)


def _logged(path, fn):
    """Run ``fn`` with the port's events and spans mirrored into
    ``path``."""
    sink = tracing.attach_jsonl_sink(str(path))
    try:
        return fn()
    finally:
        events.EVENTS.detach_sink()
        tracing.SPANS.detach_sink()
        sink.close()


# -- timeline -------------------------------------------------------------------


def _stream(rng, n: int) -> list:
    out, off = [], 0
    for _ in range(n):
        wl = int(rng.integers(2, 400))
        out.append((off, wl, ("change", "blob", "change_batch")[
            rng.integers(3)]))
        off += wl
    return out


def _records(rng, frames: list, span: str, link=None, runs=False) -> list:
    recs, seq, ts, i = [], 0, float(rng.uniform(0, 100)), 0
    while i < len(frames):
        off, wl, kind = frames[i]
        fields = {"offset": off, "wire_len": wl, "kind": kind}
        name = span
        if runs and span == "decoder.frame" and rng.integers(3) == 0 \
                and i + 2 < len(frames):
            k = int(rng.integers(2, 4))
            k = min(k, len(frames) - i)
            fields["wire_len"] = sum(f[1] for f in frames[i:i + k])
            fields["frames"] = k
            name = "decoder.frame.run"
            i += k
        else:
            i += 1
        if link is not None:
            fields["link"] = link
        recs.append({"seq": seq, "ts": ts, "dur": 0.0, "span": name,
                     "fields": fields})
        seq += 1
        ts += float(rng.uniform(0, 0.01))
        kind = rng.integers(6)
        if kind == 0:
            recs.append({"seq": seq, "ts": ts, "event": "session.stall",
                         "fields": {("offset", "wire_offset", "at")[
                             rng.integers(3)]: off}})
            seq += 1
        elif kind == 1:
            recs.append({"seq": seq, "ts": ts, "event": "reconnect.attempt",
                         "fields": {"n": int(rng.integers(9))}})
            seq += 1
    return recs


def _doctor(rng, frames: list) -> list:
    frames = list(frames)
    how = rng.integers(5)
    if how == 1 and len(frames) > 3:  # a gap
        del frames[int(rng.integers(1, len(frames) - 1))]
    elif how == 2 and len(frames) > 3:  # a reorder
        i = int(rng.integers(0, len(frames) - 1))
        frames[i], frames[i + 1] = frames[i + 1], frames[i]
    elif how == 3:  # a duplicate delivery
        frames.insert(int(rng.integers(0, len(frames))),
                      frames[int(rng.integers(0, len(frames)))])
    elif how == 4 and len(frames) > 2:  # a short receiver
        frames = frames[:-1]
    return frames


@pytest.mark.parametrize("seed", range(10))
def test_timeline_two_logs_seeded(seed, tmp_path, capsys):
    rng = np.random.default_rng(seed)
    fwd, rev = _stream(rng, int(rng.integers(3, 30))), []
    sender = _records(rng, fwd, "encoder.frame")
    receiver = _records(rng, _doctor(rng, fwd), "decoder.frame", runs=True)
    if rng.integers(2):  # duplex: the reverse wire in the same two logs
        rev = _stream(rng, int(rng.integers(2, 8)))
        receiver += _records(rng, rev, "encoder.frame")
        sender += _records(rng, _doctor(rng, rev), "decoder.frame")
    s = _write(tmp_path / "sender.jsonl", sender, torn=bool(rng.integers(2)))
    r = _write(tmp_path / "receiver.jsonl", receiver)
    for extra in ([], ["--json"]):
        rc, out = _both(["timeline", s, r, *extra], capsys)
    if extra:
        assert rc == int(bool(json.loads(out)["flags"]))


@pytest.mark.parametrize("seed", range(8))
def test_timeline_n_logs_seeded(seed, tmp_path, capsys):
    rng = np.random.default_rng(100 + seed)
    labeled = bool(rng.integers(2))
    paths = []
    for e in range(int(rng.integers(1, 3))):
        frames = _stream(rng, int(rng.integers(3, 20)))
        link = f"link{e}" if labeled else None
        paths.append(_write(tmp_path / f"emit{e}.jsonl",
                            _records(rng, frames, "encoder.frame", link)))
        for d in range(int(rng.integers(1, 3))):
            paths.append(_write(
                tmp_path / f"disp{e}{d}.jsonl",
                _records(rng, _doctor(rng, frames), "decoder.frame", link,
                         runs=True)))
    if rng.integers(3) == 0:  # a dispatcher nobody emitted for
        paths.append(_write(tmp_path / "orphan.jsonl", _records(
            rng, _stream(rng, 3), "decoder.frame")))
    if len(paths) < 3:
        paths.append(_write(tmp_path / "quiet.jsonl", [
            {"seq": 0, "ts": 1.0, "event": "session.connect",
             "fields": {}}]))
    for extra in ([], ["--json"]):
        _both(["timeline", *paths, *extra], capsys)


def test_timeline_of_a_lit_port_session(port_obs, tmp_path, capsys):
    e = protocol.encode()
    j = WireJournal()
    e.attach_journal(j)

    def send():
        for i in range(30):
            e.change({"key": f"k{i}", "change": i, "from": i, "to": i + 1,
                      "value": b"v" * (i % 21)})
        b = e.blob(200)
        b.write(b"x" * 200)
        b.end()
        e.finalize()
        while e.read(4096) is not None:
            pass

    _logged(tmp_path / "s.jsonl", send)
    dec = protocol.decode()
    dec.change(lambda c, done: done())
    dec.blob(lambda b, done: b.collect(lambda _d: done()))

    def receive():
        dec.write(j.read_from(0))
        dec.end()

    _logged(tmp_path / "r.jsonl", receive)
    assert dec.finished
    rc, out = _both(["timeline", str(tmp_path / "s.jsonl"),
                     str(tmp_path / "r.jsonl")], capsys)
    assert rc == 0 and "-- clean" in out
    rc, out = _both(["timeline", "--json", str(tmp_path / "s.jsonl"),
                     str(tmp_path / "r.jsonl")], capsys)
    rep = json.loads(out)
    assert rep["sender"]["covered"] == rep["receiver"]["covered"] == len(
        j.read_from(0))


# -- export-trace and dump ------------------------------------------------------


def _trace(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def test_export_trace_of_a_seeded_log(tmp_path, capsys):
    rng = np.random.default_rng(7)
    recs = _records(rng, _stream(rng, 25), "encoder.frame")
    recs += [{"seq": 99 + k, "ts": float(k), "dur": float(rng.uniform(0, 1)),
              "span": "device.dispatch", "parent": k or None, "tid": 5,
              "fields": {"items": k}} for k in range(5)]
    log = _write(tmp_path / "log.jsonl", recs)
    outs = []
    for main, name in ((jmain, "j.json"), (pmain, "p.json")):
        rc = main(["export-trace", log, "-o", str(tmp_path / name)])
        outs.append((rc, capsys.readouterr().out.replace(name, "T")))
    assert outs[0] == outs[1] and outs[1][0] == 0
    assert _trace(tmp_path / "j.json") == _trace(tmp_path / "p.json")
    assert len(_trace(tmp_path / "p.json")["traceEvents"]) == len(recs)
    # the default path beside the log
    assert pmain(["export-trace", log]) == 0
    assert capsys.readouterr().out.startswith(log + ".trace.json: ")


def _bundle(tmp_path, seed: int) -> str:
    rng = np.random.default_rng(seed)
    flight.FLIGHT.arm(str(tmp_path / "bundles"))
    for k in range(int(rng.integers(1, 6))):
        events.emit("session.connect", attempt=k)
        metrics.counter("decoder.bytes").inc(int(rng.integers(1, 99)))
        with tracing.trace_span("reconnect.attempt", n=k):
            pass
    flight.FLIGHT.note_plan(FaultPlan(seed=seed, stall_at=3, stall_s=0.01))
    events.emit("fault.injected.stall", at=3)
    path = flight.FLIGHT.dump("session-failed", error=ProtocolError(
        "unknown type", frame=2, offset=40))
    assert path is not None
    return path


@pytest.mark.parametrize("seed", range(3))
def test_dump_and_export_trace_of_a_port_bundle(seed, port_obs, tmp_path,
                                                capsys):
    bundle = _bundle(tmp_path, seed)
    for extra in ([], ["--json"]):
        rc, out = _both(["dump", bundle, *extra], capsys)
        assert rc == 0
    assert json.loads(out)["manifest"]["reason"] == "session-failed"
    outs = []
    for main, name in ((jmain, "j.json"), (pmain, "p.json")):
        rc = main(["export-trace", bundle, "-o", str(tmp_path / name)])
        outs.append((rc, capsys.readouterr().out.replace(name, "T")))
    assert outs[0] == outs[1]
    assert _trace(tmp_path / "j.json") == _trace(tmp_path / "p.json")


# -- loopdoctor -----------------------------------------------------------------

_PHASES = ("poll_wait", "accept", "read", "hub_drain", "tx",
           "overload_ladder")


def _turns(rng, loop: str, n: int, tick: float, tiles=None,
           calm=None) -> list:
    recs, ts = [], float(rng.uniform(10, 20))
    tiles = bool(rng.integers(2)) if tiles is None else tiles
    calm = bool(rng.integers(3) == 0) if calm is None else calm
    for k in range(n):
        dur = float(rng.uniform(0.001, 0.3))
        phases = {f"{p}_s": float(rng.uniform(0, dur / 6)) for p in _PHASES
                  if rng.integers(2)}
        work = float(rng.uniform(0, 0.4)) if rng.integers(4) == 0 \
            and not calm else float(rng.uniform(0, 0.02))
        top = [] if rng.integers(3) == 0 else [
            {"session": f"127.0.0.1:{4000 + int(rng.integers(5))}",
             "seconds": float(rng.uniform(0, work + 0.01)),
             "bytes": int(rng.integers(0, 9999)),
             "phase": ("read", "tx", "hub_drain")[rng.integers(3)]}
            for _ in range(int(rng.integers(1, 3)))]
        fields = {"loop": loop, "tick": tick, "turns": int(rng.integers(1, 9)),
                  "work_s": work, "lag_s": float(rng.uniform(0, 0.2)),
                  **phases}
        if top:
            fields["top"] = top
        recs.append({"seq": k, "ts": ts, "dur": dur, "span": "edge.turn",
                     "fields": fields})
        gap = 9 if tiles else rng.integers(10)
        ts = ts + dur + (0.01 if gap == 0 else -0.005 if gap == 1 else 0.0)
    return recs


@pytest.mark.parametrize("seed", range(8))
def test_loopdoctor_seeded_turns(seed, tmp_path, capsys):
    rng = np.random.default_rng(200 + seed)
    recs = []
    for k in range(int(rng.integers(1, 3))):
        recs += _turns(rng, f"edge{k}", int(rng.integers(1, 30)),
                       float(rng.choice([0.02, 0.05])))
    recs.append({"seq": 999, "ts": 1.0, "event": "sidecar.session",
                 "fields": {}})
    log = _write(tmp_path / "loop.jsonl", recs)
    for extra in ([], ["--json"], ["--threshold", "0.1"],
                  ["--json", "--threshold", "0.01"]):
        rc, out = _both(["loopdoctor", log, *extra], capsys)
        if "--json" in extra:
            assert rc == int(bool(json.loads(out)["flags"]))


def test_loopdoctor_clean_turns_flag_nothing(tmp_path, capsys):
    rng = np.random.default_rng(5)
    log = _write(tmp_path / "clean.jsonl", _turns(rng, "edge0", 40, 0.05,
                                                  tiles=True, calm=True))
    rc, out = _both(["loopdoctor", log], capsys)
    assert rc == 0 and "-- clean: spans tile" in out


def test_loopdoctor_with_no_turns_and_over_a_bundle(port_obs, tmp_path,
                                                    capsys):
    log = _write(tmp_path / "none.jsonl", [{"seq": 0, "ts": 1.0,
                                           "event": "x", "fields": {}}])
    rc, out = _both(["loopdoctor", log], capsys)
    assert rc == 0 and "no edge.turn spans found" in out
    bundle = _bundle(tmp_path, 9)
    _both(["loopdoctor", bundle], capsys)


# -- meshdoctor -----------------------------------------------------------------


def _mesh_log(tmp_path, seed: int, chaos: bool) -> str:
    propagation.PROPAGATION.reset_for_tests()
    path = tmp_path / f"mesh{seed}{int(chaos)}.jsonl"
    box = {}

    def run():
        box["sim"] = ClusterSim(4, seed=seed, chaos=chaos, records_per=8,
                                divergence=3, device="cpu")
        return box["sim"].run()

    assert _logged(path, run)["converged"]
    return str(path), box["sim"]


@pytest.mark.parametrize("seed,chaos", [(3, False), (1, True), (4, True)])
def test_meshdoctor_over_a_lit_port_mesh(seed, chaos, port_obs, tmp_path,
                                         capsys):
    log, sim = _mesh_log(tmp_path, seed, chaos)
    rc, out = _both(["meshdoctor", log], capsys)
    rc, out = _both(["meshdoctor", "--json", log], capsys)
    rep = json.loads(out)
    assert rep["converged"] and rep["distinct_frontiers"] == 1
    assert rep["bound"] == sim.rounds_bound()
    if not chaos:
        assert rc == 0 and rep["flags"] == []


def _span(rnd, replica, peer, role, outcome, ts, **fields):
    return {"span": "gossip.exchange", "ts": ts, "dur": 0.001,
            "fields": {"replica": replica, "peer": peer, "role": role,
                       "round": rnd, "outcome": outcome, **fields}}


def test_meshdoctor_hand_made_flags(tmp_path, capsys):
    spans = [_span(r, "a", "b", "initiator", "transport", r * 1.0)
             for r in (1, 2, 3)]
    spans += [_span(2, "b", "a", "initiator", "converged", 2.5)]
    holds = [{"event": "gossip.hold", "ts": 0.0,
              "fields": {"replica": "a", "round": 0, "digests": ["d1"]}}]
    spans += [_span(4, "a", "c", "initiator", "progress", 4.0,
                    delivered=["d9"], delivered_peer=["d1"])]
    mesh = {"event": "gossip.mesh", "ts": 0.0,
            "fields": {"n": 3, "seed": 1, "bound": 2}}
    late = [{"event": "gossip.frontier", "ts": 5.0,
             "fields": {"replica": r, "round": 5, "digest": "ff",
                        "records": 3}} for r in ("a", "b", "c")]
    split = [{"event": "gossip.frontier", "ts": 5.0,
              "fields": {"replica": r, "round": 5, "digest": d,
                         "records": 3}} for r, d in (("a", "1"), ("b", "2"))]
    for k, recs in enumerate((spans, holds + spans, [mesh] + late + spans,
                              [mesh] + split)):
        log = _write(tmp_path / f"m{k}.jsonl", recs)
        for extra in ([], ["--json"]):
            rc, out = _both(["meshdoctor", log, *extra], capsys)
        assert rc == 1
    empty = _write(tmp_path / "empty.jsonl", [])
    rc, out = _both(["meshdoctor", empty], capsys)
    assert rc == 0 and "no gossip.exchange spans" in out


# -- costdoctor -----------------------------------------------------------------


def _session(tmp_path) -> str:
    e = protocol.encode()
    j = WireJournal()
    e.attach_journal(j)

    def send():
        for i in range(40):
            e.change({"key": f"k{i}", "change": i, "from": i, "to": i + 1,
                      "value": b"v" * (i % 25)})
        e.negotiate(CAP_CHANGE_BATCH)
        e.change_many([{"key": f"b{i}", "change": i, "from": 0, "to": 1,
                        "value": b"w" * (i % 7), "subset": "dataset/tag"}
                       for i in range(20)])
        e.flush_batch()
        b = e.blob(150)
        b.write(b"x" * 150)
        b.end()
        e.finalize()
        while e.read(4096) is not None:
            pass

    path = tmp_path / "peer.jsonl"
    _logged(path, send)
    return str(path)


def test_costdoctor_over_a_lit_port_session(port_obs, tmp_path, capsys):
    log = _session(tmp_path)
    rc, out = _both(["costdoctor", log], capsys)
    assert rc == 0 and "-- clean" in out
    for extra in (["--json"], ["--max-overhead", "0.0001"],
                  ["--min-goodput", "0.9999", "--json"]):
        _both(["costdoctor", log, *extra], capsys)


def _maybe(rng, value):
    return None if rng.integers(4) == 0 else value


@pytest.mark.parametrize("seed", range(6))
def test_costdoctor_seeded_frames_and_stats(seed, tmp_path, capsys):
    rng = np.random.default_rng(300 + seed)
    paths = []
    for p in range(int(rng.integers(1, 3))):
        frames = _doctor(rng, _stream(rng, int(rng.integers(3, 25))))
        recs = _records(rng, frames, ("encoder.frame", "decoder.frame")[
            rng.integers(2)], link=(f"l{p}" if rng.integers(2) else None),
            runs=True)
        for k in range(int(rng.integers(0, 4))):
            recs.append({"emit_seq": k, "watermarks": {"links": {}},
                         "wirecost": {
                             "links": {"s|tx": {"residual_bytes": _maybe(
                                 rng, int(rng.integers(0, 3)))}},
                             "amplification": {"fan": {
                                 "amplification": float(
                                     rng.uniform(0.1, 8))}}}})
        paths.append(_write(tmp_path / f"p{p}.jsonl", recs))
    for extra in ([], ["--json"], ["--max-overhead", "0.01"],
                  ["--min-goodput", "0.995", "--json"]):
        rc, out = _both(["costdoctor", *paths, *extra], capsys)
        if "--json" in extra:
            assert rc == int(bool(json.loads(out)["flags"]))


def test_costdoctor_with_nothing_lit(tmp_path, capsys):
    log = _write(tmp_path / "x.jsonl", [{"seq": 0, "ts": 0.0, "event": "e",
                                        "fields": {}}])
    rc, out = _both(["costdoctor", log], capsys)
    assert rc == 0 and "no frame instants or wirecost sections" in out
