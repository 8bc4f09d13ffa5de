"""The gossip mesh's chaos sweep on the port: the JAX package's
``test_cluster_faults.py`` sweep, seeds 0-19 in tier-1 and the 100-seed
soak (seeds 20-119) under the ``slow`` marker, as the reference marks it.

Every seed derives a full scenario (the reference's ``_scenario``: N in
{4, 16, 64}, a partition that heals at a seeded round, chaos links, and
one of churn with a trim, a flash crowd or a byzantine replica) and runs
the port's ``ClusterSim`` with ``device="cpu"`` (B1 and B6 as their plain
versions) under the reference's asserts: convergence within
``rounds_bound``, byte-identical healthy replicas, the exact union with
no byzantine replica, no cross-partition exchange during the cut, and
every quarantine explained by the byzantine replica or a link that drew
the ``flip`` scenario.
"""

import pytest

from dat_replication_protocol_tpu_torch.cluster import ClusterSim
from dat_replication_protocol_tpu_torch.session.faults import FaultPlan

from test_cluster_faults import _scenario


def _run_seed(seed: int) -> None:
    kw = _scenario(seed)
    arm = kw.pop("_arm")
    n = kw.pop("n")
    sim = ClusterSim(n, device="cpu", **kw)
    out = sim.run()
    # 1. convergence within the bounded round budget
    assert out["converged"], (
        f"seed {seed} (n={n}) did not converge within {out['bound']} "
        f"rounds: digests {out['digests']}")
    assert out["rounds"] <= out["bound"]
    # 2. byte-identical healthy replicas; the exact union with no byzantine
    healthy = {sim.nodes[k].content_digest().hex()
               for k in sim.healthy()}
    assert len(healthy) == 1, f"seed {seed}: healthy replicas diverge"
    if sim.byzantine_key is None:
        assert healthy == {out["expected_digest"]}, (
            f"seed {seed}: converged to the wrong content")
    # 3. the partition oracle: no successful cross-group exchange during
    # [cut_round, heal_round)
    sc = out["partition"]
    minority = sc["groups"][0]
    for ev in sim.events:
        if not sc["cut_round"] <= ev["round"] < sc["heal_round"]:
            continue
        for ex in ev["exchanges"]:
            if ex["outcome"] != "ok":
                continue
            li = sim._index.get(ex["initiator"])
            lt = sim._index.get(ex["responder"])
            if li is None or lt is None or li >= sim.n0 or lt >= sim.n0:
                continue  # flash joiners sit outside the cut schedule
            assert (li in minority) == (lt in minority), (
                f"seed {seed}: exchange {ex} crossed the partition "
                f"during the cut")
    # 4. byzantine: quarantined (for the arms that always lie) or every
    # lie refused with a divergence naming the liar (wrong-chunk), and
    # every quarantine explained against the injector's ground truth
    if sim.byzantine_key is not None:
        if arm in ("wrong-symbol", "feed-corrupt"):
            assert any(q["peer"] == sim.byzantine_key
                       for q in out["quarantines"]), (
                f"seed {seed}: byzantine ({arm}) never quarantined")
        byz_corrupt = [
            ex for ev in sim.events for ex in ev["exchanges"]
            if ex["outcome"] == "corruption"
            and sim.byzantine_key in (ex["initiator"], ex["responder"])]
        if arm == "wrong-chunk":
            assert byz_corrupt, (
                f"seed {seed}: wrong-chunk byzantine never caught lying")
            assert any(
                f"repair records from '{sim.byzantine_key}'"
                in ex["error"] for ex in byz_corrupt), (
                f"seed {seed}: no wrong-chunk lie surfaced a "
                f"divergence naming the liar")
    for q in out["quarantines"]:
        if sim.byzantine_key in (q["by"], q["peer"]):
            continue
        li, lt = sim._index[q["by"]], sim._index[q["peer"]]
        scen, _rnd = FaultPlan.link_scenario(seed, sim.n0,
                                             (min(li, lt), max(li, lt)))
        assert scen == "flip", (
            f"seed {seed}: quarantine {q} has no corruption source; "
            f"link scenario is {scen!r}")
    # 5. anti-entropy did real work over real wire
    assert out["wire_bytes"] > 0


@pytest.mark.parametrize("seed", range(20))
def test_cluster_chaos_sweep(seed):
    _run_seed(seed)


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(20, 120))
def test_cluster_chaos_soak(seed):
    _run_seed(seed)
