"""The port's gossip mesh against the JAX package's.

The JAX package's 24 cases of ``test_cluster.py`` that need no fleet
plane (the partition/link fault axis, ``ReplicaNode`` semantics, the
chaos-capable exchange, the byzantine quarantine arms, churn and
bootstrap, determinism), each on the port's ``cluster`` with
``device="cpu"`` (B1 and B6 run their plain versions).

Then the two packages side by side:

* the simulator: ``ClusterSim`` of each package with the same
  ``(n, seed, records_per, divergence, chaos, byzantine, churn,
  flash_crowd, fanout)`` for the scenarios of ``test_cluster_faults.py``
  seeds 0-7 (N = 4, 16 and 64, a partition, churn with a trim, a flash
  crowd, the wrong-symbol and wrong-chunk arms): equal ``run()``
  results, equal per-round events (exchanges with their outcome, diff,
  wire bytes and error; quarantines; bootstraps; joins; digests), equal
  ``expected_digest`` and ``divergence_bytes``, equal ``node.snapshot()``
  records, and the expected digest equal to a ``hashlib`` oracle.  No
  count differs: the simulator ships repairs as byte-preserving batch
  frames and its records carry every optional, so the port's
  ``records_for_rows`` (absent optionals kept absent) never runs on a
  record that lacks one;
* bench.py config 14's clean mesh at N = 4 and 16 at its quick sizes (32
  records, divergence 8), lit on both sides: equal rounds, wire bytes
  and ``cluster.*`` gauges;
* the byzantine wrong-symbol arm corrupts column 3 of the port's coded
  symbols, the first word of the digest sum, as in the reference.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from dat_replication_protocol_tpu.cluster import ClusterSim as JaxSim
from dat_replication_protocol_tpu.obs import metrics as jmetrics
from dat_replication_protocol_tpu.obs import propagation as jprop
from dat_replication_protocol_tpu.obs import wirecost as jwirecost
from dat_replication_protocol_tpu_torch.cluster import (
    ByzantineDivergence,
    ByzantineReplicaNode,
    ClusterSim,
    PeerQuarantined,
    ReplicaNode,
    classify_error,
    gossip_exchange,
)
from dat_replication_protocol_tpu_torch.fanout.log import SnapshotNeeded
from dat_replication_protocol_tpu_torch.obs import events, metrics, tracing
from dat_replication_protocol_tpu_torch.obs import propagation, wirecost
from dat_replication_protocol_tpu_torch.ops import rateless
from dat_replication_protocol_tpu_torch.runtime import replay
from dat_replication_protocol_tpu_torch.session.faults import (
    FaultPlan,
    TransportFault,
)
from dat_replication_protocol_tpu_torch.wire.framing import ProtocolError

from test_cluster_faults import _scenario

CPU = "cpu"


def recs(lo, hi, tag="s", val=b"v"):
    return [{"key": f"k{i}", "change": i, "from": 0, "to": 1,
             "value": val + b"%d" % i, "subset": tag}
            for i in range(lo, hi)]


def node(key, records=(), **kw):
    return ReplicaNode(key, records, device=CPU, **kw)


def sim(n, seed, **kw):
    return ClusterSim(n, seed, device=CPU, **kw)


def _content_order(d: bytes) -> tuple:
    # the content digest's order: by the digest's four little-endian
    # 64-bit words, the first word first
    return tuple(int.from_bytes(d[i:i + 8], "little") for i in (0, 8, 16, 24))


def oracle(records) -> str:
    """``hashlib`` over the sorted unique canonical record digests, each
    taken with ``hashlib``."""
    wire = replay.encode_change_log(records)
    cols, _ = replay.replay_log(np.frombuffer(wire, np.uint8))
    digests = {hashlib.blake2b(p, digest_size=32).digest()
               for p in replay.canonical_change_payloads(cols)}
    return hashlib.blake2b(b"".join(sorted(digests, key=_content_order)),
                           digest_size=32).hexdigest()


# -- partition/link axis --------------------------------------------------------


def test_for_sweep_default_path_golden_byte_identical():
    golden = {
        (0, 1000, 0): (827307999, 64, None, None, None, 255, 988,
                       0.02, 0.0, 0.001),
        (1, 1000, 0): (687482608, 1024, None, 472, None, 255, None,
                       0.0, 0.0, 0.001),
        (2, 5000, 1): (1042467055, 1024, None, None, None, 255, 1043,
                       0.02, 0.05, 0.001),
        (7, 1234, 0): (324967622, None, None, 1193, None, 255, None,
                       0.0, 0.0, 0.001),
        (13, 64, 2): (845453773, 64, None, None, None, 255, None,
                      0.0, 0.0, 0.001),
        (5, 999, 1): (250431313, None, None, 551, None, 255, None,
                      0.0, 0.0, 0.001),
    }
    for (seed, wl, att), want in golden.items():
        got = dataclasses.astuple(FaultPlan.for_sweep(seed, wl, att))
        assert got == want, (seed, wl, att)
    assert dataclasses.astuple(
        FaultPlan.for_sweep(3, 2048, 0, session=2, n_sessions=4)) == \
        (438892869, 7, None, None, None, 255, None, 0.0, 0.0, 0.0005)


def test_partition_scenario_partitions_the_replica_range():
    for seed in range(8):
        for n in (2, 4, 16, 64):
            sc = FaultPlan.partition_scenario(seed, n)
            a, b = sc["groups"]
            assert a | b == frozenset(range(n))
            assert not (a & b)
            assert a and b
            assert 1 <= sc["cut_round"] < sc["heal_round"]
            assert sc == FaultPlan.partition_scenario(seed, n)


def test_cluster_plans_cut_cross_group_links_and_heal():
    seed, n = 9, 16
    sc = FaultPlan.partition_scenario(seed, n)
    a = next(iter(sc["groups"][0]))
    b = next(iter(sc["groups"][1]))
    during = FaultPlan.for_sweep(seed, 1000, link=(a, b), n_replicas=n,
                                 gossip_round=sc["cut_round"])
    assert during.drop_at == 0
    after = FaultPlan.for_sweep(seed, 1000, link=(a, b), n_replicas=n,
                                gossip_round=sc["heal_round"])
    assert after.drop_at != 0
    c, d = sorted(sc["groups"][1])[:2]
    intra = FaultPlan.for_sweep(seed, 1000, link=(c, d), n_replicas=n,
                                gossip_round=sc["cut_round"])
    assert intra.drop_at is None or intra.drop_at > 0


def test_link_scenario_deterministic_and_order_free():
    s1 = FaultPlan.link_scenario(5, 8, (1, 3))
    assert s1 == FaultPlan.link_scenario(5, 8, (3, 1))
    assert s1[0] in FaultPlan.LINK_SCENARIOS
    assert 1 <= s1[1] < 8


# -- ReplicaNode ----------------------------------------------------------------


def test_content_digest_is_order_and_duplicate_free():
    a = node("a", recs(0, 10))
    b = node("b", list(reversed(recs(0, 10))))
    assert a.content_digest() == b.content_digest()
    b.absorb(recs(3, 7))
    assert a.content_digest() == b.content_digest()
    assert b.record_count == 10
    assert a.content_digest().hex() == oracle(recs(0, 10))


def test_absent_optionals_survive_gossip_byte_exactly():
    bare = [{"key": f"n{i}", "change": i, "from": 0, "to": 1}
            for i in range(6)]
    a = node("a", bare + recs(0, 4))
    b = node("b", recs(0, 4))
    gossip_exchange(a, b)
    assert a.content_digest() == b.content_digest()
    out = gossip_exchange(a, b)
    assert out["diff"] == 0


def test_checkpoint_restore_roundtrip():
    a = node("a", recs(0, 12), fanout_retention=1 << 14)
    a.round = 7
    ckpt = a.checkpoint()
    back = ReplicaNode.from_checkpoint(ckpt, fanout_retention=1 << 14,
                                       device=CPU)
    assert back.key == "a"
    assert back.round == 7
    assert back.content_digest() == a.content_digest()
    assert back.log_gen == 1


def test_replica_key_validation():
    with pytest.raises(ValueError):
        node("bad{key}")
    with pytest.raises(ValueError):
        node("")


# -- the exchange engine --------------------------------------------------------


def test_exchange_converges_and_wire_tracks_diff():
    big = recs(0, 400)
    a = node("a", big + recs(1000, 1004, tag="u"))
    b = node("b", big)
    out = gossip_exchange(a, b)
    assert a.content_digest() == b.content_digest()
    full = len(a.canonical_wire())
    assert out["wire_bytes"] < full
    assert out["diff"] == 4


def test_exchange_truncation_is_transport_class_and_stateless():
    a = node("a", recs(0, 20))
    b = node("b", recs(10, 30))
    da, db = a.content_digest(), b.content_digest()
    plan = FaultPlan(seed=1, truncate_at=40)
    with pytest.raises(TransportFault):
        gossip_exchange(a, b, plan_out=plan)
    assert a.content_digest() == da
    assert b.content_digest() == db
    assert classify_error(TransportFault("x")) == "transport"


def test_exchange_flip_is_one_structured_error():
    a = node("a", recs(0, 20))
    b = node("b", recs(10, 30))
    da, db = a.content_digest(), b.content_digest()
    plan = FaultPlan(seed=2, flip_at=30, flip_mask=0x40)
    with pytest.raises(ProtocolError) as ei:
        gossip_exchange(a, b, plan_out=plan)
    assert classify_error(ei.value) == "corruption"
    assert a.content_digest() == da
    assert b.content_digest() == db


def test_quarantine_needs_repeated_corruption():
    a = node("a", byzantine_after=2)
    err = ProtocolError("corrupt", offset=3)
    assert a.note_corruption("p", err) is None
    assert a.note_corruption("p", err) is not None
    assert a.is_quarantined("p")
    with pytest.raises(PeerQuarantined) as ei:
        a.refuse_if_quarantined("p")
    assert ei.value.peer == "p"


def test_suspicion_is_cumulative_not_laundered_by_success():
    a = node("a", byzantine_after=2)
    err = ProtocolError("corrupt")
    assert a.note_corruption("p", err) is None
    a.note_success("p")
    assert a.note_corruption("p", err) is not None
    assert a.is_quarantined("p")


def test_sampling_skips_quarantined_peers():
    a = node("a", byzantine_after=1)
    a.note_corruption("bad", ProtocolError("corrupt"))
    picks = {a.sample_peer(["a", "bad", "good"]) for _ in range(20)}
    assert picks == {"good"}


# -- byzantine arms -------------------------------------------------------------


def _byz_sim(arm, **kw):
    return sim(4, seed=5, chaos=False, byzantine=1, byzantine_arm=arm,
               byzantine_after=1, **kw)


def test_byzantine_wrong_symbol_one_error_quarantine_rest_converge():
    s = _byz_sim("wrong-symbol")
    out = s.run()
    corrupt = [ex for ev in s.events for ex in ev["exchanges"]
               if ex["outcome"] == "corruption"]
    assert corrupt
    for ex in corrupt:
        assert "r1" in (ex["initiator"], ex["responder"])
        assert ex["error"] is not None
    assert any(q["peer"] == "r1" for q in out["quarantines"])
    assert out["converged"]
    healthy = {s.nodes[k].content_digest() for k in s.healthy()}
    assert len(healthy) == 1


def test_byzantine_wrong_chunk_digest_detected_at_apply():
    s = _byz_sim("wrong-chunk")
    out = s.run()
    q = [q for q in out["quarantines"] if q["peer"] == "r1"]
    assert q and all(x["arm"] == "wrong-chunk-digest" for x in q)
    assert out["converged"]


def test_byzantine_ack_regression_quarantined_by_owner():
    owner = node("owner", recs(0, 8), fanout_retention=1 << 14)
    byz = ByzantineReplicaNode("byz", (), arm="ack-regression", device=CPU)
    owner.publish_repairs(owner.canonical_wire())
    byz.drain_feed(owner)
    owner.publish_repairs(node("t", recs(8, 12)).canonical_wire())
    with pytest.raises(ByzantineDivergence) as ei:
        byz.drain_feed(owner)
    assert ei.value.arm == "ack-regression"
    assert ei.value.peer == "byz"
    assert ei.value.offset is not None
    assert owner.is_quarantined("byz")


def test_byzantine_feed_corrupt_quarantined_by_follower():
    owner = ByzantineReplicaNode("byz", recs(0, 8), arm="feed-corrupt",
                                 fanout_retention=1 << 14, device=CPU)
    follower = node("f", ())
    d0 = follower.content_digest()
    owner.publish_repairs(owner.canonical_wire())
    with pytest.raises(ByzantineDivergence) as ei:
        follower.drain_feed(owner)
    assert ei.value.arm == "feed-corrupt"
    assert ei.value.peer == "byz"
    assert follower.is_quarantined("byz")
    assert follower.content_digest() == d0


def test_byzantine_divergence_is_structured():
    e = ByzantineDivergence("msg", peer="p", arm="wrong-symbol",
                            frame=3, offset=99)
    assert e.peer == "p" and e.frame == 3 and e.offset == 99
    assert "frame=3" in str(e) and "byte=99" in str(e)
    assert isinstance(e, ProtocolError)


# -- churn / flash crowd / bootstrap --------------------------------------------


def test_churn_restart_resumes_from_checkpoint_and_converges():
    s = sim(8, seed=5, chaos=True, churn=True)
    out = s.run()
    assert out["converged"] and out["rounds"] <= out["bound"]
    crashed = [ev["churn"] for ev in s.events
               if ev["churn"] and "crashed" in ev["churn"]]
    restarted = [ev["churn"] for ev in s.events
                 if ev["churn"] and "restarted" in ev["churn"]]
    assert crashed and restarted


def test_trim_past_follower_bootstraps_over_snapshot_protocol():
    s = sim(8, seed=0, chaos=True, churn=True, fanout=True,
            fanout_retention=512, records_per=32, divergence=8)
    out = s.run()
    assert out["bootstraps"], "retention budget never trimmed a laggard"
    assert out["converged"] and out["rounds"] <= out["bound"]


def test_flash_crowd_joins_cold_and_converges():
    s = sim(8, seed=11, chaos=True, flash_crowd=3)
    out = s.run()
    joined = [j for ev in s.events for j in ev["joined"]]
    assert len(joined) == 3
    assert all(j["wire_bytes"] > 0 for j in joined)
    assert out["converged"]
    assert len(set(out["digests"].values())) == 1


def test_snapshot_needed_surfaces_structured_from_log():
    owner = node("o", recs(0, 64), fanout_retention=256)
    follower = node("f", ())
    for i in range(6):
        owner.publish_repairs(
            node("t", recs(i * 10, i * 10 + 10)).canonical_wire())
        owner.log.enforce_retention()
    with pytest.raises(SnapshotNeeded):
        follower.drain_feed(owner)
    res = follower.bootstrap_from(owner)
    assert res["wire_bytes"] > 0
    assert follower.stats["bootstraps"] == 1


# -- determinism ----------------------------------------------------------------


def test_sim_is_deterministic_per_seed():
    outs = []
    for _ in range(2):
        s = sim(8, seed=13, chaos=True, churn=True, fanout=True)
        outs.append(s.run())
    assert outs[0]["digests"] == outs[1]["digests"]
    assert outs[0]["rounds"] == outs[1]["rounds"]
    assert outs[0]["wire_bytes"] == outs[1]["wire_bytes"]
    assert outs[0]["quarantines"] == outs[1]["quarantines"]


# -- one device path --------------------------------------------------------------


def test_cuda_without_a_card_raises_at_the_first_build():
    if torch.cuda.is_available():
        pytest.skip("the refusal is what a host without a card does")
    n = ReplicaNode("a", recs(0, 3))  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        n.content_digest()
    with pytest.raises(RuntimeError, match="cuda"):
        ClusterSim(4, 0, chaos=False)


# -- the wrong-symbol arm on the port's cell layout -----------------------------


def test_wrong_symbol_arm_corrupts_a_digest_word():
    """Column 3 of a coded-symbol cell is the first word of the digest
    sum (``[count | checksum lo | checksum hi | sum[0..8)]``): on a
    one-element set every cell that holds it equals its digest words and
    its checksum, and the arm's XOR breaks the checksum."""
    honest = node("h", recs(0, 1))
    digest = honest.replica.digests[0]
    cells = honest.coded_symbols_out().extend(64)
    held = cells[cells[:, 0] == 1]
    assert len(held)
    words = np.frombuffer(digest.tobytes(), "<u4")
    assert (held[:, 3:] == words).all()
    assert (held[:, 1:3] == rateless.checksum_words(held[:, 3:])).all()
    byz = ByzantineReplicaNode("b", recs(0, 1), arm="wrong-symbol",
                               device=CPU)
    bad = byz.coded_symbols_out().extend(64)
    bad_held = bad[cells[:, 0] == 1]
    assert (bad_held[:, 4:] == words[1:]).all()
    assert (bad_held[:, 3] != words[0]).all()
    assert not (bad_held[:, 1:3]
                == rateless.checksum_words(bad_held[:, 3:])).all(axis=1).any()


# -- the simulators side by side ------------------------------------------------


def _same_sims(kw: dict):
    kw = dict(kw)
    kw.pop("_arm")
    n = kw.pop("n")
    jsim = JaxSim(n, **kw)
    jout = jsim.run()
    psim = ClusterSim(n, device=CPU, **kw)
    pout = psim.run()
    return jsim, jout, psim, pout


@pytest.mark.parametrize("seed", range(8))
def test_simulator_equals_the_jax_simulator(seed):
    jsim, jout, psim, pout = _same_sims(_scenario(seed))
    assert pout["converged"]
    assert pout == jout
    assert psim.events == jsim.events
    assert psim.expected_digest == jsim.expected_digest
    assert psim.divergence_bytes == jsim.divergence_bytes
    assert psim.union_wire_bytes == jsim.union_wire_bytes
    assert psim.wire_bytes == jsim.wire_bytes
    assert set(psim.nodes) == set(jsim.nodes)
    for key, nd in psim.nodes.items():
        assert nd.snapshot() == jsim.nodes[key].snapshot(), key
        assert nd.canonical_wire() == jsim.nodes[key].canonical_wire(), key
    # the ground truth against hashlib: the honest union's digest
    if psim.byzantine_key is None:
        honest = ReplicaNode("u", b"".join(
            psim.nodes[k].canonical_wire() for k in psim.healthy()),
            device=CPU)
        assert honest.content_digest() == psim.expected_digest
        union = replay.replay_log(np.frombuffer(
            honest.canonical_wire(), np.uint8))[0]
        assert oracle([union.row(i) for i in range(len(union))]) == \
            psim.expected_digest.hex()


@pytest.fixture
def both_lit(obs_enabled):
    was_on = metrics.OBS.on
    metrics.REGISTRY.reset()
    events.EVENTS.clear()
    tracing.SPANS.clear()
    propagation.PROPAGATION.reset_for_tests()
    wirecost.WIRECOST.reset_for_tests()
    metrics.enable()
    try:
        yield
    finally:
        metrics.OBS.on = was_on
        metrics.REGISTRY.reset()
        events.EVENTS.clear()
        tracing.SPANS.clear()
        propagation.PROPAGATION.reset_for_tests()
        wirecost.WIRECOST.reset_for_tests()


def _ratios(board) -> tuple:
    payload = framing = total = 0
    for rec in board.snapshot()["links"].values():
        payload += rec["payload_bytes"]
        framing += rec["framing_bytes"]
        total += rec["ledger_bytes"]
    return payload, framing, total


@pytest.mark.parametrize("n", (4, 16))
def test_config14_clean_mesh_equals_the_jax_mesh(both_lit, n):
    """bench.py config 14 at its quick sizes, lit on both sides."""
    out = {}
    for name, cls, kw, prop, wc, reg in (
            ("jax", JaxSim, {}, jprop, jwirecost, jmetrics.REGISTRY),
            ("port", ClusterSim, {"device": CPU}, propagation, wirecost,
             metrics.REGISTRY)):
        prop.PROPAGATION.reset_for_tests()
        wc.WIRECOST.reset_for_tests()
        s = cls(n, seed=20_240, chaos=False, records_per=32, divergence=8,
                **kw)
        res = s.run()
        assert res["converged"] and res["rounds"] <= s.rounds_bound()
        gauges = {k: v for k, v in reg.snapshot()["gauges"].items()
                  if k.startswith("cluster.")}
        out[name] = {"rounds": res["rounds"], "wire_bytes": s.wire_bytes,
                     "divergence_bytes": s.divergence_bytes,
                     "digests": res["digests"], "gauges": gauges,
                     "ledger": _ratios(wc.WIRECOST),
                     "p99_known": prop.PROPAGATION.exchange_p99() is not None}
    assert out["port"] == out["jax"]
    assert out["port"]["gauges"]
