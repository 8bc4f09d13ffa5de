"""In-process cluster harness: N replicas over FaultPlan-seeded links.

A trimmed copy of ``dat_replication_protocol_tpu/cluster/sim.py``.
Everything derives from ONE seed: the record sets, the peer sampling,
the link chaos, the partition cut and its heal round, the churn
schedule, the flash-crowd join, the byzantine replica and its arm; so a
failing seed is a reproducer, and the same seed gives the same run as
the reference's simulator.

One :meth:`ClusterSim.step` is one gossip round:

1. scheduled events fire (churn crash/restart, flash-crowd joins,
   periodic checkpoints);
2. every alive replica samples a peer and runs one
   :func:`~.node.gossip_exchange` over the link's chaos plans
   (:meth:`~..session.faults.FaultPlan.for_sweep`'s partition/link
   axis): transport failures change nothing, corruption surfaces
   structurally, repeated corruption quarantines;
3. the fan-out leg drains every follower's broadcast feed; the retention
   budget is enforced, and a follower trimmed past bootstraps over the
   snapshot protocol;
4. convergence: every healthy replica's content digest is identical
   (and, with no byzantine replica, equal to the ground-truth union).

:meth:`ClusterSim.run` steps until convergence or the round budget
(:meth:`rounds_bound`) runs out.  Every replica (and the ground-truth
node) runs on ``device``: its replica builds, repair checks and
bootstraps launch B1 and B6 there.
"""

from __future__ import annotations

import math
import random
from typing import Optional

from ..fanout.log import SnapshotNeeded
from ..obs import propagation as _propagation
from ..obs.metrics import OBS as _OBS
from ..session.faults import FaultPlan, TransportFault
from ..wire.framing import ProtocolError
from .node import (
    DEFAULT_BYZANTINE_AFTER,
    ByzantineDivergence,
    ByzantineReplicaNode,
    PeerQuarantined,
    ReplicaNode,
    classify_error,
    gossip_exchange,
)

__all__ = ["ClusterSim"]

# per-exchange wire-length scale handed to the fault-plan generator
# (fault offsets are drawn inside it; an exchange that ends sooner
# simply never reaches the coordinate)
DEFAULT_WIRE_EST = 4096


def _rand_value(rng: random.Random, lo: int = 12, hi: int = 48) -> bytes:
    return bytes(rng.randrange(256) for _ in range(rng.randrange(lo, hi)))


class ClusterSim:
    """See module docstring.

    ``byzantine`` is a replica index (or None); ``byzantine_arm`` one
    of :data:`~.node.ByzantineReplicaNode.ARMS`.  ``churn=True``
    schedules one crash/restart-from-checkpoint; ``flash_crowd=J``
    joins J empty replicas mid-run (cold snapshot bootstrap);
    ``fanout=True`` gives every replica a broadcast log with
    ``fanout_retention`` bytes of history (small budgets exercise the
    trim -> SnapshotNeeded -> bootstrap arm).
    """

    def __init__(self, n: int, seed: int, *, records_per: int = 24,
                 divergence: int = 6, device="cuda",
                 chaos: bool = True, byzantine: Optional[int] = None,
                 byzantine_arm: str = "wrong-symbol",
                 byzantine_after: int = DEFAULT_BYZANTINE_AFTER,
                 churn: bool = False, flash_crowd: int = 0,
                 fanout: bool = False, fanout_retention: int = 1 << 15,
                 checkpoint_every: int = 3,
                 wire_est: int = DEFAULT_WIRE_EST):
        if n < 2:
            raise ValueError("a cluster needs at least 2 replicas")
        if byzantine is not None and not 0 <= byzantine < n:
            raise ValueError(f"byzantine index {byzantine} outside 0..{n-1}")
        self.n0 = n
        self.seed = seed
        self.device = device
        self.chaos = chaos
        self.fanout = fanout
        self.wire_est = wire_est
        self.checkpoint_every = max(1, checkpoint_every)
        self.byzantine_key = None if byzantine is None else f"r{byzantine}"
        self.round = 0
        self.wire_bytes = 0
        self.converged_at: Optional[int] = None
        self.events: list[dict] = []
        rng = random.Random(seed * 48_271 + n)
        node_kw = dict(device=device, byzantine_after=byzantine_after,
                       fanout_retention=fanout_retention if fanout
                       else None)
        self._node_kw = node_kw
        # the record universe: a shared base plus per-replica unique
        # divergence — every replica starts strictly diverged from
        # every other, with no distinguished source holding the union
        base = [{"key": f"base-{i}", "change": i, "from": 0, "to": 1,
                 "value": _rand_value(rng), "subset": "base"}
                for i in range(records_per)]
        self.nodes: dict[str, ReplicaNode] = {}
        self._index: dict[str, int] = {}
        honest_records = list(base)
        for i in range(n):
            key = f"r{i}"
            uniq = [{"key": f"u{i}-{j}", "change": j, "from": 0, "to": 1,
                     "value": _rand_value(rng), "subset": f"u{i}"}
                    for j in range(divergence)]
            if key == self.byzantine_key:
                # the liar holds real unique records too (so the
                # wrong-chunk arm has content to corrupt when honest
                # peers request it), but they are EXCLUDED from the
                # honest ground-truth union: with a byzantine replica
                # the sweep asserts healthy-set equality, not equality
                # to a fixed union (which arm fired decides whether the
                # liar's records ever legitimately spread)
                node = ByzantineReplicaNode(key, base + uniq,
                                            arm=byzantine_arm,
                                            seed=seed * 131 + i, **node_kw)
            else:
                node = ReplicaNode(key, base + uniq,
                                   seed=seed * 131 + i, **node_kw)
                honest_records.extend(uniq)
            self.nodes[key] = node
            self._index[key] = i
        expected_node = ReplicaNode("expected", honest_records,
                                    device=device)
        self.expected_digest = expected_node.content_digest()
        # divergence size in bytes (the bench's denominator): wire the
        # mesh MUST move for every replica to reach the union
        self.union_wire_bytes = len(expected_node.canonical_wire())
        self.divergence_bytes = sum(
            max(0, self.union_wire_bytes - len(nd.canonical_wire()))
            for nd in self.nodes.values())
        # deterministic schedules, all from the one seed
        self.partition = (FaultPlan.partition_scenario(seed, n)
                          if chaos else None)
        self._churn: Optional[dict] = None
        if churn:
            victims = [i for i in range(n) if i != byzantine]
            crash = rng.randrange(2, 5)
            self._churn = {"replica": rng.choice(victims),
                           "crash_round": crash,
                           "restart_round": crash + rng.randrange(2, 4)}
        self._flash: Optional[dict] = None
        if flash_crowd:
            self._flash = {"round": rng.randrange(2, 5),
                           "joiners": int(flash_crowd)}
        # static follow graph for the fan-out leg: each replica follows
        # its two ring predecessors' broadcast logs
        self._follows: dict[str, list[str]] = {}
        if fanout:
            for i in range(n):
                owners = {f"r{(i - 1) % n}", f"r{(i - 2) % n}"} - {f"r{i}"}
                self._follows[f"r{i}"] = sorted(owners)
        self._checkpoints: dict[str, dict] = {
            k: nd.checkpoint() for k, nd in self.nodes.items()}
        self._down: dict[str, ReplicaNode] = {}
        self._rng = rng
        if _OBS.on:
            # the meshdoctor's ground-truth frame + provenance roots:
            # what each replica held BEFORE any exchange (round 0)
            _propagation.note_mesh(n, seed, self.rounds_bound())
            for key, nd in self.nodes.items():
                _propagation.note_hold(
                    key, _propagation.digest_prefixes(nd.replica.digests))
                _propagation.note_frontier(
                    key, nd.content_digest().hex(), nd.record_count, 0)

    # -- views ---------------------------------------------------------------

    def alive(self) -> list[str]:
        return [k for k, nd in self.nodes.items()
                if nd.state != "crashed"]

    def healthy(self) -> list[str]:
        """Alive and not the byzantine replica — the set the
        convergence invariant quantifies over."""
        return [k for k in self.alive() if k != self.byzantine_key]

    def content_digests(self) -> dict:
        return {k: self.nodes[k].content_digest().hex()
                for k in self.alive()}

    def converged(self) -> bool:
        """Every healthy replica byte-identical (and equal to the
        ground-truth union when no byzantine replica is configured) —
        only evaluable once all scheduled churn/joins have happened."""
        if self._churn and self.round < self._churn["restart_round"]:
            return False
        if self._flash and self.round < self._flash["round"]:
            return False
        digests = {self.nodes[k].content_digest()
                   for k in self.healthy()}
        if len(digests) != 1:
            return False
        if self.byzantine_key is None:
            return digests == {self.expected_digest}
        return True

    def rounds_bound(self) -> int:
        """The asserted convergence budget: epidemic spread is
        O(log n) rounds; partitions/churn/joins shift the start line;
        chaos links and a byzantine replica eat a bounded number of
        exchanges.  Generous but FINITE — the sweep fails any seed
        that wanders past it."""
        n = max(2, self.n0 + (self._flash["joiners"]
                              if self._flash else 0))
        base = 3 * math.ceil(math.log2(n)) + 10
        start = 0
        if self.partition is not None:
            start = max(start, self.partition["heal_round"])
        if self._churn is not None:
            start = max(start, self._churn["restart_round"])
        if self._flash is not None:
            start = max(start, self._flash["round"])
        if self.byzantine_key is not None:
            base += 4
        return start + base

    # -- one gossip round ----------------------------------------------------

    def step(self) -> dict:
        self.round += 1
        rnd = self.round
        ev: dict = {"round": rnd, "exchanges": [], "quarantines": [],
                    "bootstraps": [], "churn": None, "joined": []}
        self._fire_schedules(rnd, ev)
        if rnd % self.checkpoint_every == 0:
            for k in self.alive():
                self._checkpoints[k] = self.nodes[k].checkpoint()
        keys = self.alive()
        for key in keys:
            node = self.nodes.get(key)
            if node is None or node.state == "crashed":
                continue
            node.begin_round(rnd)
            peer_key = node.sample_peer(keys)
            if peer_key is None:
                continue
            target = self.nodes[peer_key]
            rec = {"round": rnd, "initiator": key, "responder": peer_key,
                   "outcome": "ok", "error": None}
            if target.state == "crashed":
                node.note_transport_failure(peer_key)
                rec["outcome"] = "transport"
                rec["error"] = "peer crashed"
                if _OBS.on:
                    # never reaches gossip_exchange's lit fork: the
                    # dial itself found a dead peer
                    _propagation.record_exchange(
                        key, peer_key, role="initiator", rnd=rnd,
                        outcome="transport", seconds=0.0,
                        error="peer crashed")
                ev["exchanges"].append(rec)
                continue
            plan_out = plan_back = None
            if self.chaos:
                li, lt = self._index[key], self._index[peer_key]
                plan_out = FaultPlan.for_sweep(
                    self.seed, self.wire_est, link=(li, lt),
                    n_replicas=self.n0, gossip_round=rnd)
                plan_back = FaultPlan.for_sweep(
                    self.seed, self.wire_est, link=(lt, li),
                    n_replicas=self.n0, gossip_round=rnd)
            try:
                res = gossip_exchange(node, target, plan_out=plan_out,
                                      plan_back=plan_back)
            except PeerQuarantined as e:
                node.stats["refusals"] += 1
                rec["outcome"] = "refused"
                rec["error"] = str(e)
                if _OBS.on:
                    # refusal happens BEFORE the exchange engine's lit
                    # fork (the quarantine check is the front door), so
                    # the provenance record is made here
                    _propagation.record_exchange(
                        key, peer_key, role="initiator", rnd=rnd,
                        outcome="refused", seconds=0.0, error=str(e))
            except TransportFault as e:
                node.note_transport_failure(peer_key)
                target.note_transport_failure(key)
                rec["outcome"] = "transport"
                rec["error"] = str(e)
            except (ProtocolError, ValueError) as e:
                rec["outcome"] = classify_error(e)
                rec["error"] = f"{type(e).__name__}: {e}"
                for by, suspect in ((node, peer_key), (target, key)):
                    div = by.note_corruption(suspect, e)
                    if div is not None:
                        ev["quarantines"].append(
                            {"round": rnd, "by": by.key, "peer": div.peer,
                             "arm": div.arm})
            else:
                node.note_success(peer_key)
                target.note_success(key)
                self.wire_bytes += res["wire_bytes"]
                rec["wire_bytes"] = res["wire_bytes"]
                rec["diff"] = res["diff"]
                if self.fanout:
                    node.publish_repairs(res["wire_initiator"])
                    target.publish_repairs(res["wire_responder"])
            ev["exchanges"].append(rec)
        if self.fanout:
            self._fanout_leg(rnd, ev)
        ev["digests"] = self.content_digests()
        if self.converged_at is None and self.converged():
            self.converged_at = rnd
        self.events.append(ev)
        return ev

    def _fire_schedules(self, rnd: int, ev: dict) -> None:
        ch = self._churn
        if ch is not None:
            key = f"r{ch['replica']}"
            if rnd == ch["crash_round"]:
                node = self.nodes.pop(key)
                node.crash()
                self._down[key] = node
                ev["churn"] = {"crashed": key}
            elif rnd == ch["restart_round"]:
                old = self._down.pop(key)
                node = type(old).from_checkpoint(
                    self._checkpoints[key],
                    seed=self.seed * 131 + ch["replica"], **self._node_kw)
                node.log_gen = old.log_gen + 1
                self.nodes[key] = node
                ev["churn"] = {"restarted": key,
                               "from_round":
                                   self._checkpoints[key]["round"]}
        if self._flash is not None and rnd == self._flash["round"]:
            donors = self.healthy()
            for j in range(self._flash["joiners"]):
                key = f"j{j}"
                node = ReplicaNode(key, (),
                                   seed=self.seed * 977 + j,
                                   **self._node_kw)
                self.nodes[key] = node
                self._index[key] = self.n0 + j
                donor = self.nodes[self._rng.choice(donors)]
                res = node.bootstrap_from(donor)
                self.wire_bytes += res["wire_bytes"]
                if self.fanout:
                    self._follows[key] = [donor.key]
                if _OBS.on:
                    # snapshot bootstrap is an out-of-band acquisition:
                    # a provenance ROOT, not an exchange delivery
                    _propagation.note_hold(
                        key,
                        _propagation.digest_prefixes(node.replica.digests),
                        rnd=rnd)
                    _propagation.note_frontier(
                        key, node.content_digest().hex(),
                        node.record_count, rnd)
                ev["joined"].append({"replica": key, "donor": donor.key,
                                     "wire_bytes": res["wire_bytes"]})

    def _fanout_leg(self, rnd: int, ev: dict) -> None:
        for key in self.alive():
            node = self.nodes[key]
            for owner_key in self._follows.get(key, ()):
                owner = self.nodes.get(owner_key)
                if owner is None or owner.state == "crashed":
                    continue
                try:
                    node.drain_feed(owner)
                except SnapshotNeeded:
                    # the retention budget trimmed past this follower:
                    # the snapshot bootstrap is the recovery protocol
                    res = node.bootstrap_from(owner)
                    self.wire_bytes += res["wire_bytes"]
                    ev["bootstraps"].append(
                        {"round": rnd, "replica": key,
                         "owner": owner_key,
                         "wire_bytes": res["wire_bytes"]})
                except ByzantineDivergence as e:
                    by = owner.key if e.arm == "ack-regression" else key
                    ev["quarantines"].append(
                        {"round": rnd, "by": by, "peer": e.peer,
                         "arm": e.arm})
        for key in self.alive():
            log = self.nodes[key].log
            if log is not None:
                log.enforce_retention()
        if _OBS.on:
            # feed drains deliver records OUTSIDE any exchange: record
            # them as provenance holds (change-only via the frontier),
            # or the meshdoctor would flag feed-spread digests as
            # orphaned when a follower later re-ships them
            for key in self.alive():
                nd = self.nodes[key]
                if _propagation.note_frontier(
                        key, nd.content_digest().hex(),
                        nd.record_count, rnd):
                    _propagation.note_hold(
                        key,
                        _propagation.digest_prefixes(nd.replica.digests),
                        rnd=rnd)

    # -- running rounds -----------------------------------------------------

    def byzantine_quarantined(self) -> bool:
        return self.byzantine_key is not None and any(
            q["peer"] == self.byzantine_key
            for e in self.events for q in e["quarantines"])

    def run(self, max_rounds: Optional[int] = None) -> dict:
        """Step until convergence or the bounded round budget runs
        out.  With a byzantine replica the mesh keeps gossiping past
        convergence (still bounded) until the liar is quarantined —
        exactly what a live mesh does; ``rounds`` reports the
        convergence round either way."""
        bound = self.rounds_bound() if max_rounds is None else max_rounds
        while self.round < bound:
            if self.converged_at is not None and (
                    self.byzantine_key is None
                    or self.byzantine_quarantined()):
                break
            self.step()
        quarantines = [q for e in self.events for q in e["quarantines"]]
        bootstraps = [b for e in self.events for b in e["bootstraps"]]
        return {
            "converged": self.converged_at is not None,
            "rounds": self.converged_at
            if self.converged_at is not None else self.round,
            "bound": bound,
            "wire_bytes": self.wire_bytes,
            "digests": self.content_digests(),
            "expected_digest": self.expected_digest.hex(),
            "quarantines": quarantines,
            "bootstraps": bootstraps,
            "byzantine": self.byzantine_key,
            "partition": self.partition,
        }
