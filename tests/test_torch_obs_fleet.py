"""The port's fleet aggregator (``obs/fleet.py``) against the JAX package's.

Three kinds of case:

* **Seeded fleets, made with numpy**: targets whose snapshots carry
  every section the joins read (watermark links and marks, loops,
  gossip, propagation, wire cost, counters, gauges, kernel sites,
  health), unreachable and half-written targets among them, polled by
  one ``FleetView`` of each package under the same fake clock: equal
  samples, equal ``evaluate_slo`` rows for seeded SLOs, equal dashboards;
  the same fleets as ``--stats-fd`` files through ``run_fleet_check`` and
  the ``fleet`` CLI of each (check, one-shot JSON, ``--watch``): equal
  output and exit codes.  Malformed SLO files, HTTP targets on the port's
  endpoint, and ``emit_seq`` gaps in a file: equal too.
* **The reference's fleet cases of ``test_cluster.py``** on the port's
  ``ClusterSim`` (on the CPU): a converged mesh passes, a diverged one
  fails, the rounds-behind column is restart-proof, quarantine
  provenance, the mesh SLO over a lit in-process mesh; each evaluated by
  both packages' fleet code over the same snapshots, with equal output.
* **The chaos sweep of ``test_obs_fleet.py``** on the port's session
  stack, with every assert of the reference's.  The reference's copy is
  load-sensitive: "lag rose under the fault" needs a poll to land while
  the receiver is behind.  Here the receiver's transport holds at a
  known offset, past the fault, until the test has polled, so some poll
  always sees lag.
"""

import copy
import io
import json
import threading
import time

import numpy as np
import pytest

from dat_replication_protocol_tpu.obs import fleet as jfleet
from dat_replication_protocol_tpu.obs.__main__ import main as jmain
import dat_replication_protocol_tpu_torch as protocol
from dat_replication_protocol_tpu_torch.cluster import ClusterSim
from dat_replication_protocol_tpu_torch.obs import (
    events, metrics, propagation, tracing, watermarks, wirecost)
from dat_replication_protocol_tpu_torch.obs import fleet as pfleet
from dat_replication_protocol_tpu_torch.obs.__main__ import main as pmain
from dat_replication_protocol_tpu_torch.obs.http import (
    ObsHttpServer, default_snapshot)
from dat_replication_protocol_tpu_torch.session.faults import (
    FaultPlan, FaultyReader)
from dat_replication_protocol_tpu_torch.session.reconnect import (
    BackoffPolicy, run_resumable)
from dat_replication_protocol_tpu_torch.session.resume import WireJournal

CPU = "cpu"
HARD_TIMEOUT = 30.0


class _Clock:
    """A fake ``time`` for one fleet module: monotonic steps, sleeps add."""

    def __init__(self):
        self.t = 5000.0

    def monotonic(self) -> float:
        self.t += 0.25
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


@pytest.fixture
def clocks(monkeypatch):
    monkeypatch.setattr(jfleet, "time", _Clock())
    monkeypatch.setattr(pfleet, "time", _Clock())


def _reset_port() -> None:
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    tracing.SPANS.clear()
    watermarks.WATERMARKS.reset_for_tests()
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


# -- seeded fleets --------------------------------------------------------------

REPLICAS = ("r0", "r1", "r2", "r3")


def _maybe(rng, value, p: float = 0.2):
    return None if rng.random() < p else value


def _watermarks(rng, i: int, roles: dict) -> dict:
    links = {}
    for lname, (s, r) in roles.items():
        rec: dict = {}
        if s == i:
            append = int(rng.integers(0, 4000))
            offs = np.sort(rng.integers(0, append + 1,
                                        int(rng.integers(0, 5))))
            rec["offsets"] = {"append": append}
            if rng.integers(2):
                rec["offsets"]["acked"] = int(rng.integers(0, append + 1))
            rec["marks"] = [[int(o), float(rng.uniform(0, 100))]
                            for o in offs] + [[append, 100.0]]
            rec["marks_dropped"] = int(rng.integers(0, 3))
        if r == i:
            recv = int(rng.integers(0, 4000))
            rec.setdefault("offsets", {})[
                ("parsed", "delivered")[rng.integers(2)]] = recv
            if s != i:
                rec["marks"] = []
                if rng.integers(3) == 0:
                    rec["marks_from"] = "clock"
        if rec:
            links[lname] = rec
    if rng.integers(2):
        links["clock"] = {"marks": [[10, 50.0], [4000, 99.0]]}
    loops = {}
    for k in range(int(rng.integers(0, 3))):
        loops[f"edge{k}"] = {
            "state": ("live", "live", "dark")[rng.integers(3)],
            "lag_s": float(rng.uniform(0, 0.3)),
            "lag_max_s": float(rng.uniform(0, 2.0)),
            "oldest_ready_s": float(rng.uniform(0, 0.1)),
            "turns": int(rng.integers(0, 500))}
    out = {"monotonic": _maybe(rng, float(rng.uniform(100, 200)), 0.1),
           "links": links}
    if loops:
        out["loops"] = loops
    return out


def _gossip(rng, name: str, rnd: int, digests: list) -> dict:
    peers = [r for r in REPLICAS if r != name]
    quarantined = [p for p in peers if rng.random() < 0.15]
    return {"replica": name, "round": rnd,
            "records": int(rng.integers(0, 5000)),
            "digest": _maybe(rng, digests[rng.integers(len(digests))], 0.1),
            "quarantined": quarantined,
            "quarantine": {p: {"arm": "wrong-symbol",
                               "frame": int(rng.integers(0, 9)),
                               "offset": int(rng.integers(0, 999))}
                           for p in quarantined},
            "suspicion": {p: int(rng.integers(1, 3)) for p in quarantined},
            "state": "live"}


def _propagation(rng, digests: list) -> dict:
    links = {}
    for _ in range(int(rng.integers(0, 5))):
        a, b = rng.choice(REPLICAS, 2, replace=False)
        links[f"{a}->{b}"] = {
            "round": int(rng.integers(0, 30)),
            "divergence_records": _maybe(rng, int(rng.integers(0, 50))),
            "divergence_bytes": _maybe(rng, int(rng.integers(0, 9000))),
            "last_success_age_s": _maybe(rng, float(rng.uniform(0, 9))),
            "outcome": ("converged", "progress", "transport")[
                rng.integers(3)]}
    frontier = {r: {"digest": digests[rng.integers(len(digests))],
                    "records": int(rng.integers(0, 5000)),
                    "round": int(rng.integers(0, 30))}
                for r in REPLICAS if rng.random() < 0.6}
    return {"links": links, "frontier": frontier,
            "exchange_seconds": {"p99": _maybe(rng, float(
                rng.uniform(0.001, 0.5))), "count": int(rng.integers(0, 99))}}


def _wirecost(rng) -> dict:
    links = {}
    for k in range(int(rng.integers(0, 3))):
        total = int(rng.integers(1, 90000))
        framing = int(rng.integers(0, total))
        known = rng.integers(3) > 0
        links[f"s{k}|{('tx', 'rx')[rng.integers(2)]}"] = {
            "ledger_bytes": total, "payload_bytes": total - framing,
            "framing_bytes": framing,
            "goodput_fraction": (total - framing) / total if known else None,
            "overhead_ratio": framing / total if known else None,
            "residual_bytes": _maybe(rng, int(rng.integers(0, 3))),
            "batch_saved_bytes": int(rng.integers(0, 500))}
    amp = {}
    for k in range(int(rng.integers(0, 2))):
        src = int(rng.integers(1, 9000))
        peers = {f"p{j}": int(rng.integers(0, 20000))
                 for j in range(int(rng.integers(0, 4)))}
        amp[f"fan{k}"] = {"source_bytes": src,
                          "delivered_bytes": sum(peers.values()),
                          "amplification": _maybe(rng, sum(peers.values())
                                                  / src),
                          "peers": peers}
    return {"links": links, "amplification": amp}


def _healthz(rng):
    kind = rng.integers(4)
    if kind == 0:
        return None
    if kind == 1:
        return {"ok": False, "error": "URLError: refused"}
    stages = {"loop_lag": {"ok": bool(rng.integers(3))},
              "admission": {"ok": bool(rng.integers(4))},
              "obs_gate": {"ok": True}}
    return {"ok": all(s["ok"] for s in stages.values()), "stages": stages}


def _fleet(seed: int, polls: int) -> dict:
    """target name -> one snapshot a poll (``None``: no snapshot yet,
    ``"raise"``: the target is down)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 5))
    names = [f"t{i}" for i in range(n)]
    roles = {f"L{k}": (int(rng.integers(n)), int(rng.integers(n)))
             for k in range(int(rng.integers(0, 4)))}
    digests = [rng.bytes(32).hex() for _ in range(int(rng.integers(1, 3)))]
    rounds = {t: int(rng.integers(0, 100)) for t in names}
    seq = {t: 0 for t in names}
    out: dict = {t: [] for t in names}
    for _ in range(polls):
        for i, t in enumerate(names):
            kind = rng.integers(14)
            if kind == 0:
                out[t].append("raise")
                continue
            if kind == 1:
                out[t].append(None)
                continue
            seq[t] += 1 + int(rng.integers(0, 2) * rng.integers(1, 4))
            rounds[t] = (int(rng.integers(0, 5)) if rng.integers(8) == 0
                         else rounds[t] + int(rng.integers(0, 4)))
            snap = {"ts": float(rng.uniform(0, 1e6)), "emit_seq": seq[t],
                    "events_dropped": int(rng.integers(0, 3)),
                    "watermarks": _watermarks(rng, i, roles),
                    "jit_sites": {f"site{k}": {
                        "calls": int(rng.integers(0, 99)),
                        "traces": int(rng.integers(0, 6))}
                        for k in range(int(rng.integers(0, 3)))},
                    "metrics": {
                        "counters": {
                            "hub.shed": int(rng.integers(0, 3)),
                            "fanout.peer.shed{peer=p1}":
                                int(rng.integers(0, 2)),
                            "edge.rejected{loop=edge0}":
                                int(rng.integers(0, 2)),
                            "reconcile.rounds": int(rng.integers(0, 9)),
                            "decoder.bytes": int(rng.integers(0, 999))},
                        "gauges": {
                            "reconcile.symbols.seen":
                                float(rng.integers(0, 4096)),
                            "reconcile.decoded.diff":
                                float(rng.integers(0, 64))}},
                    "hub": {"sessions": int(rng.integers(0, 9))},
                    "edge": _maybe(rng, {"served": int(rng.integers(9))})}
            if rng.random() < 0.7:
                snap["gossip"] = _gossip(rng, REPLICAS[i % 4], rounds[t],
                                         digests)
            if rng.random() < 0.6:
                snap["propagation"] = _propagation(rng, digests)
            if rng.random() < 0.6:
                snap["wirecost"] = _wirecost(rng)
            hz = _healthz(rng)
            if hz is not None:
                snap["healthz"] = hz
            out[t].append(snap)
    return out


def _slos(seed: int, k: int = 6) -> list:
    rng = np.random.default_rng(seed + 1000)
    out = []
    for _ in range(k):
        slo: dict = {}
        for key, value in (
                ("max_lag_bytes", int(rng.integers(0, 3000))),
                ("max_lag_seconds", float(rng.uniform(0, 60))),
                ("require_converged", True),
                ("max_shed", int(rng.integers(0, 4))),
                ("max_rejected", int(rng.integers(0, 3))),
                ("recompile_budget", int(rng.integers(0, 6))),
                ("require_healthz", True),
                ("max_events_dropped", int(rng.integers(0, 3))),
                ("max_loop_lag_s", float(rng.uniform(0, 0.3))),
                ("min_goodput_fraction", float(rng.uniform(0.5, 1))),
                ("max_overhead_ratio", float(rng.uniform(0, 0.5))),
                ("max_egress_bytes_per_peer", int(rng.integers(0, 20000)))):
            if rng.random() < 0.4:
                slo[key] = value
        g: dict = {}
        for key, value in (
                ("require_converged", True),
                ("max_rounds_behind", int(rng.integers(0, 4))),
                ("max_quarantined", int(rng.integers(0, 2))),
                ("max_convergence_rounds", int(rng.integers(10, 30))),
                ("max_divergence_bytes", int(rng.integers(0, 9000))),
                ("max_exchange_age_s", float(rng.uniform(0, 9))),
                ("max_exchange_p99_s", float(rng.uniform(0, 0.5)))):
            if rng.random() < 0.4:
                g[key] = value
        if g or not slo:
            slo["gossip"] = g or {"require_converged": True}
        out.append(slo)
    return out


def _callable(snaps: list):
    it = iter(snaps)

    def snap():
        s = next(it)
        if s == "raise":
            raise RuntimeError("target down")
        return copy.deepcopy(s)

    return snap


def _views(fleet: dict):
    return [mod.FleetView([mod.FleetTarget(_callable(snaps), name=t)
                           for t, snaps in fleet.items()])
            for mod in (jfleet, pfleet)]


@pytest.mark.parametrize("seed", range(12))
def test_seeded_fleet_polls_rows_and_dashboards_equal(seed, clocks):
    polls = 4
    fleet = _fleet(seed, polls)
    jview, pview = _views(fleet)
    slos = _slos(seed)
    for p in range(polls):
        healthz = p % 2 == 1
        want = jview.poll(healthz=healthz)
        got = pview.poll(healthz=healthz)
        assert got == want
        for slo in slos:
            assert pfleet.evaluate_slo(slo, got) == \
                jfleet.evaluate_slo(slo, want)
        assert pfleet.render_dashboard(pview, got) == \
            jfleet.render_dashboard(jview, want)
    for lname in got["links"]:
        assert pview.history(lname) == jview.history(lname)
    assert pview.polls == jview.polls == polls


def _write_files(tmp_path, fleet: dict) -> list:
    """Each target's snapshots as a ``--stats-fd`` file: one line each,
    a torn line where the target had none, nothing where it was down."""
    paths = []
    for t, snaps in fleet.items():
        lines = []
        for s in snaps:
            if s is None:
                lines.append('{"watermarks": {"links"')
            elif s != "raise":
                lines.append(json.dumps(s))
        path = tmp_path / f"{t}.jsonl"
        path.write_text("".join(ln + "\n" for ln in lines))
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("seed", range(6))
def test_seeded_fleet_check_and_cli_over_files_equal(seed, clocks, tmp_path,
                                                     capsys):
    files = _write_files(tmp_path, _fleet(seed, 3))
    for k, slo in enumerate(_slos(seed, 3)):
        path = tmp_path / f"slo{k}.json"
        path.write_text(json.dumps(slo))
        outs = []
        for mod in (jfleet, pfleet):
            buf = io.StringIO()
            rc = mod.run_fleet_check(files, str(path), polls=2,
                                     interval=0.5, out=buf)
            outs.append((rc, buf.getvalue()))
        assert outs[0] == outs[1]
        assert outs[1][0] == int(" 0 failed" not in outs[1][1])
        for argv in (["fleet", *files, "--check", str(path), "--polls", "2",
                      "--interval", "0.01"],):
            cli = []
            for main in (jmain, pmain):
                rc = main(argv)
                cli.append((rc, capsys.readouterr().out))
            assert cli[0] == cli[1]
    for argv in (["fleet", *files, "--polls", "1"],
                 ["fleet", *files, "--watch", "--polls", "2",
                  "--interval", "0.01"]):
        cli = []
        for main in (jmain, pmain):
            rc = main(argv)
            cli.append((rc, capsys.readouterr().out))
        assert cli[0] == cli[1] and cli[1][0] == 0


@pytest.mark.parametrize("content", [
    "[1, 2]", "{}", '{"max_lag_bytes": "ten"}', '{"bogus_key": 1}',
    "not json", '{"require_healthz": 1}', '{"min_goodput_fraction": 1.5}',
    '{"gossip": {}}', '{"gossip": {"unknown_key": 1}}',
    '{"gossip": {"max_rounds_behind": "two"}}',
    '{"gossip": {"require_converged": "yes"}}', '{"gossip": 3}',
    *(json.dumps({"gossip": {k: "x"}}) for k in sorted(pfleet.MESH_SLO_KEYS)),
])
def test_malformed_slo_is_loud_and_equal(content, tmp_path, clocks):
    path = tmp_path / "slo.json"
    path.write_text(content)
    errs = []
    for mod in (jfleet, pfleet):
        with pytest.raises((ValueError, json.JSONDecodeError)) as ei:
            mod.load_slo(str(path))
        errs.append((type(ei.value), str(ei.value)))
    assert errs[0] == errs[1]
    target = [lambda: {"watermarks": {"links": {}}}]
    outs = []
    for mod in (jfleet, pfleet):
        buf = io.StringIO()
        outs.append((mod.run_fleet_check(target, str(path), out=buf),
                     buf.getvalue()))
    assert outs[0] == outs[1] and outs[1][0] == 1
    assert outs[1][1].startswith("FAIL slo")


def test_key_sets_and_rounds_floor_equal():
    for name in ("SLO_KEYS", "WIRECOST_SLO_KEYS", "MESH_SLO_KEYS",
                 "GOSSIP_SLO_KEYS"):
        assert getattr(pfleet, name) == getattr(jfleet, name)
    assert [pfleet.mesh_rounds_floor(n) for n in range(0, 300)] == \
        [jfleet.mesh_rounds_floor(n) for n in range(0, 300)]
    assert pfleet.mesh_rounds_floor(4) == 16
    for mod in (jfleet, pfleet):
        with pytest.raises(ValueError, match="at least one target"):
            mod.FleetView([])
        with pytest.raises(ValueError, match="unknown fleet target spec"):
            mod.FleetTarget(3)


def test_duplicate_target_names_are_suffixed_alike():
    views = [mod.FleetView([lambda: None, lambda: None,
                            mod.FleetTarget(lambda: None, name="x"),
                            mod.FleetTarget(lambda: None, name="x")])
             for mod in (jfleet, pfleet)]
    assert [t.name for t in views[0].targets] == \
        [t.name for t in views[1].targets] == \
        ["<lambda>", "<lambda>#2", "x", "x#2"]


def test_file_target_counts_emit_seq_gaps_and_skips_a_torn_tail(tmp_path):
    path = tmp_path / "stats.jsonl"
    lines = [{"emit_seq": 0, "watermarks": {"links": {}}},
             {"emit_seq": 1, "watermarks": {"links": {}}}]
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    targets = [mod.FleetTarget(str(path)) for mod in (jfleet, pfleet)]
    for t in targets:
        assert t.kind == "file" and t.name == "stats.jsonl"
        assert t.poll()["emit_seq"] == 1
    with open(path, "a") as f:
        f.write(json.dumps({"emit_seq": 5, "watermarks": {"links": {}}})
                + "\n" + '{"emit_seq": 6, "watermarks"')
    got = [(t.poll(), t.dropped_lines) for t in targets]
    assert got[0] == got[1] and got[1][1] == 3
    assert got[1][0]["emit_seq"] == 5
    missing = [mod.FleetTarget(str(tmp_path / "nope.jsonl"))
               for mod in (jfleet, pfleet)]
    for t in missing:
        assert t.poll() is None
    assert missing[0].last_error == missing[1].last_error
    assert missing[1].last_error.startswith("FileNotFoundError")


def test_http_targets_on_the_port_endpoint_equal(port_obs, clocks, tmp_path):
    fleet = _fleet(3, 4)
    snaps = [s for s in fleet["t0"] + fleet["t1"] if isinstance(s, dict)]
    health = [{"ok": True, "stages": {"obs_gate": {"ok": True}}},
              {"ok": False, "stages": {"loop_lag": {"ok": False},
                                       "obs_gate": {"ok": True}}}]
    state = {"i": 0}
    with ObsHttpServer(0, snapshot_fn=lambda: snaps[state["i"]],
                       healthz_fn=lambda: health[state["i"] % 2]) as srv:
        for i in range(len(snaps)):
            state["i"] = i
            got = []
            for mod in (jfleet, pfleet):
                t = mod.FleetTarget(srv.url)
                got.append((t.kind, t.name, t.poll(), t.poll_healthz()))
            assert got[0] == got[1]
            assert got[1][2] == snaps[i] and got[1][3] == health[i % 2]
        slo = tmp_path / "slo.json"
        slo.write_text(json.dumps({"require_healthz": True,
                                   "max_shed": 100}))
        outs = []
        for mod in (jfleet, pfleet):
            buf = io.StringIO()
            outs.append((mod.run_fleet_check([srv.url], str(slo), polls=1,
                                             out=buf), buf.getvalue()))
        assert outs[0] == outs[1]
    # the endpoint is gone: unreachable, visibly, never fatal
    down = [mod.FleetView([srv.url]).poll(healthz=True)
            for mod in (jfleet, pfleet)]
    assert down[0]["errors"] == down[1]["errors"] != {}
    assert down[0]["healthz"] == down[1]["healthz"]


def test_sample_over_the_port_default_snapshot_joins_its_watermarks(
        port_obs, clocks):
    j = WireJournal()
    j.watermark("wm-x")
    j.append(b"a" * 100)
    dec = protocol.decode()
    dec.watermark("wm-x")
    dec.change(lambda c, done: done())
    snap = default_snapshot()
    views = [mod.FleetView([mod.FleetTarget(lambda: copy.deepcopy(snap),
                                            name="port")])
             for mod in (jfleet, pfleet)]
    samples = [v.poll() for v in views]
    assert samples[0] == samples[1]
    entry = samples[1]["links"]["wm-x"]
    assert (entry["offsets"]["append"], entry["offsets"]["parsed"]) == \
        (100, 0)
    assert entry["lag_bytes"] == 100
    watermarks.WATERMARKS.untrack("wm-x")


# -- the reference's fleet cases of test_cluster.py, on the port's mesh ---------


def _targets(sim, mod, extra=None):
    def target(key):
        node = sim.nodes[key]

        def snap():
            out = {"ts": 0.0, "watermarks": {"monotonic": 0.0, "links": {}},
                   "gossip": node.snapshot()}
            if extra is not None:
                out.update(extra())
            return out

        return snap

    return [mod.FleetTarget(target(k), name=k) for k in sim.nodes]


def _check_both(sim, slo: dict, tmp_path, extra=None, polls: int = 1):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(slo))
    outs = []
    for mod in (jfleet, pfleet):
        buf = io.StringIO()
        rc = mod.run_fleet_check(_targets(sim, mod, extra), str(path),
                                 polls=polls, interval=0.01, out=buf)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    return outs[1]


@pytest.fixture(scope="module")
def converged_sim():
    sim = ClusterSim(4, seed=2, chaos=False, device=CPU)
    assert sim.run()["converged"]
    return sim


def test_gossip_slo_passes_on_converged_mesh_then_fails_on_divergence(
        tmp_path, clocks):
    sim = ClusterSim(4, seed=2, chaos=False, device=CPU)
    assert sim.run()["converged"]
    rc, text = _check_both(sim, {"gossip": {"require_converged": True,
                                            "max_rounds_behind": 2,
                                            "max_quarantined": 0}}, tmp_path)
    assert rc == 0 and "gossip.require_converged" in text
    sim.nodes["r0"].absorb(
        [{"key": "rogue", "change": 1, "from": 0, "to": 1, "value": b"z"}])
    rc, text = _check_both(sim, {"gossip": {"require_converged": True}},
                           tmp_path)
    assert rc == 1 and "distinct content digests" in text


def test_gossip_rounds_behind_column_is_restart_proof(converged_sim, clocks,
                                                      tmp_path):
    sim = converged_sim
    saved = {k: n.round for k, n in sim.nodes.items()}
    try:
        sim.nodes["r2"].round = 1  # a freshly restarted replica
        views = [mod.FleetView(_targets(sim, mod))
                 for mod in (jfleet, pfleet)]
        for v in views:
            v.poll()  # the baseline
        for k in ("r0", "r1", "r2"):  # r3's timer stops advancing
            sim.nodes[k].round += 3
        samples = [v.poll() for v in views]
        assert samples[0] == samples[1]
        g = samples[1]["gossip"]
        assert (g["r3"]["rounds_behind"], g["r0"]["rounds_behind"],
                g["r2"]["rounds_behind"]) == (3, 0, 0)
        frames = [mod.render_dashboard(v, s) for mod, v, s in
                  zip((jfleet, pfleet), views, samples)]
        assert frames[0] == frames[1]
        assert "behind" in frames[1] and "r3" in frames[1]
    finally:
        for k, r in saved.items():
            sim.nodes[k].round = r


def test_gossip_slo_with_no_reporting_target_fails(tmp_path, clocks):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"gossip": {"require_converged": True}}))
    outs = []
    for mod in (jfleet, pfleet):
        buf = io.StringIO()
        target = mod.FleetTarget(lambda: {
            "ts": 0.0, "watermarks": {"monotonic": 0.0, "links": {}}},
            name="t")
        outs.append((mod.run_fleet_check([target], str(path), polls=1,
                                         out=buf), buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 1 and "no targets report gossip" in outs[1][1]


def test_quarantine_provenance_matches_the_injector(clocks):
    sim = ClusterSim(4, seed=5, chaos=False, byzantine=1,
                     byzantine_arm="wrong-symbol", byzantine_after=1,
                     device=CPU)
    assert sim.run()["converged"]
    views = [mod.FleetView(_targets(sim, mod)) for mod in (jfleet, pfleet)]
    samples = [v.poll() for v in views]
    assert samples[0] == samples[1]
    reporting = 0
    for tname, row in samples[1]["gossip"].items():
        node = sim.nodes[tname]
        truth = {peer: {"arm": d.arm, "frame": d.frame, "offset": d.offset}
                 for peer, d in node.quarantined.items()}
        assert row["quarantine"] == truth, tname
        if tname != sim.byzantine_key and truth:
            reporting += 1
            assert set(truth) == {"r1"}
            assert all(v["arm"] == "wrong-symbol" for v in truth.values())
    assert reporting
    for s in samples:
        s["mesh"] = {"pairs": {}, "exchange_p99_s": None,
                     "exchange_count": 0}
    frames = [mod.render_dashboard(v, s) for mod, v, s in
              zip((jfleet, pfleet), views, samples)]
    assert frames[0] == frames[1]
    assert "arm=wrong-symbol" in frames[1]


def test_mesh_slo_over_a_lit_in_process_mesh(port_obs, tmp_path, clocks):
    sim = ClusterSim(3, seed=7, records_per=6, divergence=2, chaos=False,
                     device=CPU)
    assert sim.run()["converged"]
    slo = {"gossip": {"require_converged": True,
                      "max_convergence_rounds": pfleet.mesh_rounds_floor(3),
                      "max_divergence_bytes": 0,
                      "max_exchange_age_s": 120.0,
                      "max_exchange_p99_s": 30.0}}
    board = propagation.PROPAGATION.snapshot()
    rc, text = _check_both(sim, slo, tmp_path,
                           extra=lambda: {"propagation": board})
    assert rc == 0, text
    assert "gossip.max_convergence_rounds" in text
    assert "divergence exactly 0" in text
    assert "gossip.max_exchange_p99_s" in text
    rc, text = _check_both(sim, slo, tmp_path)  # the plane dark
    assert rc == 1 and "no targets report propagation records" in text


# -- the chaos sweep, with a poll that lands while the receiver is behind -------


def _build_wire(rows: int = 40) -> bytes:
    e = protocol.encode()
    j = WireJournal()
    e.attach_journal(j)
    for i in range(rows):
        e.change({"key": f"k-{i:04d}", "change": i, "from": i, "to": i + 1,
                  "value": b"v" * (i % 23)})
    b = e.blob(64)
    b.write(b"x" * 64)
    b.end()
    e.finalize()
    while e.read(4096) is not None:
        pass
    return j.read_from(0)


def _expected_events(wire: bytes) -> list:
    dec = protocol.decode()
    out: list = []
    dec.change(lambda c, done: (out.append(("change", c.key, c.value)),
                                done()))
    dec.blob(lambda b, done: b.collect(
        lambda data: (out.append(("blob", data)), done())))
    dec.write(wire)
    dec.end()
    assert dec.finished
    return out


class _HeldFollower:
    """A blocking reader over a growing journal, as the reference's
    ``_Follower``; every follower of one run shares ``hold``: a read at
    ``hold.at`` waits until the test releases it, and bytes up to
    ``hold.at`` are all any read returns before that."""

    def __init__(self, journal: WireJournal, start: int,
                 done: threading.Event, hold):
        self._j = journal
        self._pos = start
        self._done = done
        self._hold = hold

    def read(self, n: int) -> bytes:
        while True:
            if not self._hold.released.is_set():
                if self._pos >= self._hold.at:
                    self._hold.reached.set()
                    self._hold.released.wait(HARD_TIMEOUT)
                    continue
                n = min(n, self._hold.at - self._pos)
            if self._j.end > self._pos:
                data = bytes(self._j.read_from(self._pos)[:n])
                self._pos += len(data)
                return data
            if self._done.is_set() and self._j.end <= self._pos:
                return b""
            time.sleep(0.0005)


class _Hold:
    def __init__(self, at: int):
        self.at = at
        self.reached = threading.Event()
        self.released = threading.Event()


_CHAOS_WIRE = _build_wire(40)
_CHAOS_EXPECTED = _expected_events(_CHAOS_WIRE)


def _chaos_seed(seed: int):
    """The reference's run with its fault plans, producer and poll loop;
    the receiver's transport holds at three quarters of the wire (past
    every fault offset) until a poll has landed with the producer done."""
    wire = _CHAOS_WIRE
    scenario = ("stall", "truncate")[seed % 2]
    at = 64 + (seed * 97) % (len(wire) // 2)
    hold = _Hold(len(wire) * 3 // 4)
    assert at < hold.at < len(wire)

    j = WireJournal()
    j.watermark("chaos")
    dec = protocol.decode()
    dec.watermark("chaos")
    got: list = []
    dec.change(lambda c, done: (got.append(("change", c.key, c.value)),
                                done()))
    dec.blob(lambda b, done: b.collect(
        lambda data: (got.append(("blob", data)), done())))
    done_evt = threading.Event()

    def produce():
        step = 192
        for off in range(0, len(wire), step):
            j.append(wire[off:off + step])
            time.sleep(0.001)
        done_evt.set()

    def source(ckpt, failures):
        if failures == 0:
            if scenario == "stall":
                plan = FaultPlan(seed=seed, stall_at=max(0, at - 32),
                                 stall_s=0.06)
            else:
                plan = FaultPlan(seed=seed, truncate_at=at)
        else:
            plan = FaultPlan(seed=seed)
        return FaultyReader(
            _HeldFollower(j, ckpt.wire_offset, done_evt, hold).read, plan)

    view = pfleet.FleetView([default_snapshot])
    samples: list = []
    result: dict = {}

    def drive():
        result["stats"] = run_resumable(
            source, dec, BackoffPolicy(base=0.0005, cap=0.005,
                                       max_retries=8, seed=seed),
            chunk_size=512, expected_total=len(wire),
            stall_timeout=HARD_TIMEOUT / 2)

    producer = threading.Thread(target=produce, daemon=True)
    driver = threading.Thread(target=drive, daemon=True)
    producer.start()
    time.sleep(0.004)
    driver.start()
    deadline = time.monotonic() + HARD_TIMEOUT
    held = []
    while driver.is_alive():
        assert time.monotonic() < deadline, "HANG: chaos run stuck"
        samples.append(view.poll())
        if not hold.released.is_set() and hold.reached.is_set() \
                and done_evt.is_set():
            held.append(samples[-1])
            samples.append(view.poll())
            held.append(samples[-1])
            hold.released.set()
        time.sleep(0.002)
    driver.join()
    producer.join(timeout=5)
    samples.append(view.poll())
    watermarks.WATERMARKS.untrack("chaos")
    return samples, held, result.get("stats"), got, j, dec


@pytest.mark.parametrize("seed", range(20))
def test_chaos_sweep_lag_matches_ground_truth_at_every_poll(seed, port_obs):
    samples, held, stats, got, j, dec = _chaos_seed(seed)
    assert stats is not None, "resumable fault class must converge"
    # the polls taken while the receiver was held at a known offset
    # behind a finished producer
    assert held
    for s in held:
        entry = s["links"]["chaos"]
        assert entry["offsets"]["append"] == len(_CHAOS_WIRE)
        assert entry["offsets"]["parsed"] <= len(_CHAOS_WIRE) * 3 // 4
    lags = []
    for s in samples:
        entry = s["links"].get("chaos")
        if entry is None or entry.get("lag_bytes") is None:
            continue
        offs = entry["offsets"]
        assert entry["lag_bytes"] == max(0, offs["append"] - offs["parsed"])
        lags.append(entry["lag_bytes"])
    assert lags and max(lags) > 0, "no lag ever observed under fault"
    assert lags[-1] == 0
    final = samples[-1]["links"]["chaos"]
    assert final["lag_seconds"] == 0.0
    assert j.end == len(_CHAOS_WIRE)
    assert dec._parsed == dec.bytes == j.end
    assert dec.finished
    assert got == _CHAOS_EXPECTED
    assert stats["reconnects"] == len(stats["faults"])
