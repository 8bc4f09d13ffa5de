"""N-replica epidemic anti-entropy: the gossip mesh.

The port of ``dat_replication_protocol_tpu/cluster/``.  It composes
rateless reconciliation, broadcast fan-out, snapshot bootstrap and the
chaos transport into a replica-set runtime with no distinguished source:

* :class:`~.node.ReplicaNode`: one replica's state machine;
* :func:`~.node.gossip_exchange`: one chaos-capable anti-entropy
  exchange (the exact diff, ONE structured error, or a clean transport
  failure; never a wrong diff, never a partial apply);
* :class:`~.sim.ClusterSim`: the in-process harness (partitions that
  heal, churn, flash crowds, byzantine replicas);
* :class:`~.live.GossipDriver`: the sidecar ``--replica`` timer loop
  dialing real peers over TCP.

Record digests are kernel B1's, bootstrap chunk cuts kernel B6's, on the
``device`` each node is given (default ``"cuda"``).
"""

from .live import GossipDriver, serve_responder_session
from .node import (
    ByzantineDivergence,
    ByzantineReplicaNode,
    PeerQuarantined,
    ReplicaNode,
    classify_error,
    gossip_exchange,
)
from .sim import ClusterSim

__all__ = [
    "ByzantineDivergence",
    "ByzantineReplicaNode",
    "PeerQuarantined",
    "ReplicaNode",
    "ClusterSim",
    "GossipDriver",
    "classify_error",
    "gossip_exchange",
    "serve_responder_session",
]
