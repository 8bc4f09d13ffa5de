"""The port's mesh convergence plane against the JAX package's.

The JAX package's fifteen cases of ``test_propagation.py`` (the board's
watermark semantics, the dark/lit fork of the exchange engine proven on
its bytecode, a dark run leaving the board and rings empty, a lit run
filling them), each on the port's ``obs.propagation`` and
``cluster.node``.  Then the two packages side by side: one
``PropagationBoard`` each fed the same seeded ``record`` and
``note_frontier`` calls, and one lit ``ClusterSim`` each with the same
arguments, must give equal snapshots (ages and clocks left out), equal
collector gauges, equal ``exchange_p99()`` and equal ``gossip.*`` span
and event fields (wall seconds left out).  The port's simulator runs
B1's plain version on the CPU.
"""

import random

import pytest

from dat_replication_protocol_tpu.cluster import ClusterSim as JaxSim
from dat_replication_protocol_tpu.obs import events as jevents
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.obs import propagation as jprop
from dat_replication_protocol_tpu.obs import tracing as jtracing
from dat_replication_protocol_tpu.obs import wirecost as jwirecost
from dat_replication_protocol_tpu_torch.cluster import ClusterSim
from dat_replication_protocol_tpu_torch.cluster import node as cluster_node
from dat_replication_protocol_tpu_torch.obs import events, metrics, propagation
from dat_replication_protocol_tpu_torch.obs import tracing, wirecost
from dat_replication_protocol_tpu_torch.obs.events import EVENTS
from dat_replication_protocol_tpu_torch.obs.metrics import REGISTRY
from dat_replication_protocol_tpu_torch.obs.tracing import SPANS


def _reset_port() -> None:
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    tracing.SPANS.clear()
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


@pytest.fixture
def port_dark():
    was_on = metrics.OBS.on
    metrics.OBS.on = False
    _reset_port()
    try:
        yield metrics
    finally:
        metrics.OBS.on = was_on
        _reset_port()


@pytest.fixture
def both_obs(obs_enabled, port_obs):
    yield


# -- the dark/lit fork, at the bytecode level ---------------------------------


def test_dark_twin_references_no_propagation_symbol():
    names = cluster_node._exchange.__code__.co_names
    assert not any("propagation" in n for n in names), names
    assert "record_exchange" not in names
    assert "note_frontier" not in names


def test_gossip_exchange_fork_is_one_attribute_load():
    names = cluster_node.gossip_exchange.__code__.co_names
    assert {"_OBS", "on", "_exchange", "_exchange_lit"} <= set(names)


def test_lit_twin_does_reference_the_plane():
    names = cluster_node._exchange_lit.__code__.co_names
    assert any("propagation" in n for n in names), names


def test_dark_run_leaves_board_and_rings_empty(port_dark):
    assert not propagation.OBS.on
    sim = ClusterSim(3, seed=5, records_per=4, divergence=2, chaos=False,
                     device="cpu")
    assert sim.run()["converged"]
    snap = propagation.PROPAGATION.snapshot()
    assert snap["links"] == {}
    assert snap["frontier"] == {}
    assert snap["exchange_seconds"]["count"] == 0
    assert SPANS.spans("gossip.exchange") == []
    assert EVENTS.events("gossip.mesh") == []


# -- the board's semantics ------------------------------------------------------


def test_success_sets_watermark_failure_keeps_it():
    board = propagation.PropagationBoard()
    board.record("r0", "r1", role="initiator", rnd=1, outcome="progress",
                 seconds=0.01, diff=7, wire_bytes=900, repair_bytes=640)
    rec = board.snapshot()["links"]["r0->r1"]
    assert rec["divergence_records"] == 7
    assert rec["divergence_bytes"] == 640
    assert rec["failures"] == 0
    # a failed exchange did not heal the divergence: the watermark stays
    board.record("r0", "r1", role="initiator", rnd=2, outcome="transport",
                 seconds=0.02, error="link cut")
    rec = board.snapshot()["links"]["r0->r1"]
    assert rec["divergence_records"] == 7
    assert rec["divergence_bytes"] == 640
    assert rec["failures"] == 1
    assert rec["outcome"] == "transport"
    assert rec["error"] == "link cut"
    assert rec["exchanges"] == 2
    board.record("r0", "r1", role="initiator", rnd=3, outcome="converged",
                 seconds=0.01, diff=0)
    rec = board.snapshot()["links"]["r0->r1"]
    assert rec["divergence_records"] == 0
    assert rec["divergence_bytes"] == 0


def test_failure_before_any_peel_reports_unknown_not_zero():
    board = propagation.PropagationBoard()
    board.record("r0", "r1", role="initiator", rnd=1, outcome="transport",
                 seconds=0.0)
    rec = board.snapshot()["links"]["r0->r1"]
    assert rec["divergence_records"] is None
    assert rec["divergence_bytes"] is None
    assert rec["last_success_age_s"] is None
    assert board._collect()["gauges"] == {}


def test_refused_exchanges_stay_out_of_the_seconds_window():
    board = propagation.PropagationBoard()
    assert board.exchange_p99() is None
    board.record("r0", "r1", role="initiator", rnd=1, outcome="refused",
                 seconds=9.9, error="quarantined")
    assert board.exchange_p99() is None
    board.record("r0", "r1", role="initiator", rnd=2, outcome="progress",
                 seconds=0.25, diff=1)
    assert board.exchange_p99() == 0.25


def test_exchange_quantiles_over_known_window():
    board = propagation.PropagationBoard()
    for i in range(100):
        board.record("r0", "r1", role="initiator", rnd=i,
                     outcome="progress", seconds=(i + 1) / 100.0, diff=1)
    assert board._quantile(0.50) == pytest.approx(0.50)
    assert board.exchange_p99() == pytest.approx(0.99)
    xs = board.snapshot()["exchange_seconds"]
    assert xs["count"] == 100
    assert xs["p50"] == pytest.approx(0.50)
    assert xs["p99"] == pytest.approx(0.99)


def test_snapshot_ages_are_monotonic_clock_relative():
    board = propagation.PropagationBoard()
    board.record("r0", "r1", role="initiator", rnd=1, outcome="converged",
                 seconds=0.01, diff=0)
    rec = board.snapshot()["links"]["r0->r1"]
    assert rec["age_s"] >= 0.0
    assert rec["last_success_age_s"] >= 0.0
    assert rec["last_success_age_s"] <= rec["age_s"] + 0.001


def test_note_frontier_is_change_only():
    board = propagation.PropagationBoard()
    assert board.note_frontier("r0", "aa" * 16, 3, 0)
    assert not board.note_frontier("r0", "aa" * 16, 3, 1)
    assert board.note_frontier("r0", "bb" * 16, 4, 2)
    assert board.snapshot()["frontier"]["r0"] == {
        "digest": "bb" * 16, "records": 4, "round": 2}


def test_collector_exports_divergence_and_frontier_gauges():
    board = propagation.PropagationBoard()
    board.record("r0", "r1", role="initiator", rnd=1, outcome="progress",
                 seconds=0.01, diff=3, repair_bytes=300)
    board.note_frontier("r0", "ff" * 16, 5, 1)
    gauges = board._collect()["gauges"]
    assert gauges["cluster.divergence{replica=r0,peer=r1}"] == 3.0
    assert gauges["cluster.divergence_bytes{replica=r0,peer=r1}"] == 300.0
    assert gauges["cluster.frontier{replica=r0}"] == \
        propagation.frontier_fingerprint("ff" * 16)


def test_frontier_fingerprint_is_an_exact_equality_token():
    a = propagation.frontier_fingerprint("f" * 64)
    assert a == float(int("f" * 13, 16))
    assert a == propagation.frontier_fingerprint("f" * 13)
    assert a != propagation.frontier_fingerprint("e" + "f" * 12)
    assert float(int("f" * 13, 16)) != float(int("f" * 13, 16) - 1)


def test_digest_prefixes_hex16():
    rows = [bytes(range(32)), b"\xff" * 32]
    assert propagation.digest_prefixes(rows) == [
        bytes(range(32)).hex()[:16], "ff" * 8]


def test_reset_for_tests_drops_everything():
    board = propagation.PropagationBoard()
    board.record("r0", "r1", role="initiator", rnd=1, outcome="progress",
                 seconds=0.5, diff=1)
    board.note_frontier("r0", "aa" * 16, 1, 1)
    board.reset_for_tests()
    snap = board.snapshot()
    assert snap["links"] == {} and snap["frontier"] == {}
    assert board.exchange_p99() is None


# -- a lit run records provenance -----------------------------------------------


def test_lit_sim_populates_board_spans_and_gauges(port_obs):
    sim = ClusterSim(4, seed=3, records_per=6, divergence=2, chaos=False,
                     device="cpu")
    assert sim.run()["converged"]
    snap = propagation.PROPAGATION.snapshot()
    assert snap["links"], "lit exchanges must leave link watermarks"
    digests = {rec["digest"] for rec in snap["frontier"].values()}
    assert len(snap["frontier"]) == 4
    assert len(digests) == 1, "converged mesh: one frontier digest"
    assert snap["exchange_seconds"]["p99"] is not None
    spans = SPANS.spans("gossip.exchange")
    assert spans
    for r in spans:
        f = r["fields"]
        assert f["outcome"] in propagation.OUTCOMES
        assert f["role"] in ("initiator", "responder")
        assert {"replica", "peer", "round", "seconds",
                "wire_bytes"} <= set(f)
    roles = {r["fields"]["role"] for r in spans}
    assert roles == {"initiator", "responder"}
    gauges = REGISTRY.snapshot()["gauges"]
    frontier_g = {k: v for k, v in gauges.items()
                  if k.startswith("cluster.frontier{")}
    assert len(frontier_g) == 4
    assert len(set(frontier_g.values())) == 1
    assert any(k.startswith("cluster.divergence{") for k in gauges)
    mesh_ev = EVENTS.events("gossip.mesh")
    assert len(mesh_ev) == 1
    assert mesh_ev[0]["fields"] == {"n": 4, "seed": 3,
                                    "bound": sim.rounds_bound()}
    holds = EVENTS.events("gossip.hold")
    assert {h["fields"]["replica"] for h in holds} == set(sim.nodes)


# -- the two packages side by side ----------------------------------------------


def _untimed_snapshot(snap: dict) -> dict:
    """A board snapshot without its clock, ages and wall seconds."""
    links = {}
    for name, rec in snap["links"].items():
        rec = dict(rec)
        for k in ("age_s", "last_success_age_s", "seconds"):
            rec.pop(k)
        links[name] = rec
    return {"links": links, "frontier": snap["frontier"],
            "exchange_count": snap["exchange_seconds"]["count"]}


def _feed(board, rng: random.Random) -> None:
    outcomes = propagation.OUTCOMES
    for i in range(300):
        a, b = rng.sample(["r0", "r1", "r2", "r3", "j0"], 2)
        outcome = rng.choice(outcomes)
        ok = outcome in ("converged", "progress")
        board.record(a, b, role=rng.choice(("initiator", "responder")),
                     rnd=i // 7, outcome=outcome,
                     seconds=rng.randrange(1, 10_000) / 1e4,
                     diff=(0 if outcome == "converged"
                           else rng.randrange(1, 50)) if ok else None,
                     wire_bytes=rng.randrange(100_000),
                     repair_bytes=rng.randrange(10_000) if ok else 0,
                     error=None if ok else f"e{i}")
        if i % 5 == 0:
            board.note_frontier(a, f"{rng.getrandbits(256):064x}",
                                rng.randrange(1000), i // 7)


def test_board_equals_the_jax_board_on_the_same_calls():
    jb, pb = jprop.PropagationBoard(), propagation.PropagationBoard()
    _feed(jb, random.Random(20261017))
    _feed(pb, random.Random(20261017))
    assert _untimed_snapshot(pb.snapshot()) == \
        _untimed_snapshot(jb.snapshot())
    assert pb._collect() == jb._collect()
    assert pb.exchange_p99() == jb.exchange_p99()
    assert pb._quantile(0.5) == jb._quantile(0.5)
    for a, b in (("r0", "r1"), ("r2", "j0")):
        assert pb.note_frontier(a, "ab" * 32, 1, 99) == \
            jb.note_frontier(a, "ab" * 32, 1, 99)
    assert pb.snapshot()["frontier"] == jb.snapshot()["frontier"]


def _span_fields(spans) -> list:
    out = []
    for r in spans:
        f = dict(r["fields"])
        f.pop("seconds")
        out.append((r["span"], f, r["parent"]))
    return out


def test_record_exchange_spans_equal_the_jax_spans(both_obs):
    rng = random.Random(7)
    calls = []
    for i in range(40):
        ok = i % 3 != 0
        calls.append(dict(
            replica=f"r{i % 4}", peer=f"r{(i + 1) % 4}",
            role=("initiator", "responder")[i % 2], rnd=i,
            outcome="progress" if ok else "transport",
            seconds=rng.random(), diff=rng.randrange(9) if ok else None,
            wire_bytes=rng.randrange(5000), repair_bytes=rng.randrange(900),
            delivered=[f"{rng.getrandbits(64):016x}"] if ok else (),
            delivered_peer=(), error=None if ok else "cut"))
    for c in calls:
        jprop.record_exchange(c["replica"], c["peer"], **{
            k: v for k, v in c.items() if k not in ("replica", "peer")})
        propagation.record_exchange(c["replica"], c["peer"], **{
            k: v for k, v in c.items() if k not in ("replica", "peer")})
    jaxs = _span_fields(jtracing.SPANS.spans("gossip.exchange"))
    port = _span_fields(SPANS.spans("gossip.exchange"))
    assert len(port) == 40 and port == jaxs
    assert _untimed_snapshot(propagation.PROPAGATION.snapshot()) == \
        _untimed_snapshot(jprop.PROPAGATION.snapshot())


def _gossip_events(log) -> list:
    return [(r["event"], r["fields"]) for r in log.events()
            if r["event"].startswith("gossip.")]


def test_lit_sim_records_equal_the_jax_records(both_obs):
    """One lit simulator run a package, the same arguments (chaos links
    and a flash crowd: transport failures, bootstraps and holds): equal
    ``gossip.*`` events, span fields, boards, ``cluster.*`` gauges and
    wire cost links."""
    kw = dict(records_per=8, divergence=3, chaos=True, flash_crowd=1)
    jout = JaxSim(4, 6, **kw).run()
    pout = ClusterSim(4, 6, device="cpu", **kw).run()
    assert pout == jout
    assert _gossip_events(EVENTS) == _gossip_events(jevents.EVENTS)
    assert _span_fields(SPANS.spans("gossip.exchange")) == \
        _span_fields(jtracing.SPANS.spans("gossip.exchange"))
    assert _untimed_snapshot(propagation.PROPAGATION.snapshot()) == \
        _untimed_snapshot(jprop.PROPAGATION.snapshot())

    def cluster_gauges(snap):
        return {k: v for k, v in snap["gauges"].items()
                if k.startswith("cluster.")}

    got = cluster_gauges(REGISTRY.snapshot())
    assert got and got == cluster_gauges(jmetrics.REGISTRY.snapshot())

    def links(snap):
        return {k: {kk: vv for kk, vv in v.items() if "age" not in kk}
                for k, v in snap["links"].items()}

    assert links(wirecost.WIRECOST.snapshot()) == \
        links(jwirecost.WIRECOST.snapshot())
