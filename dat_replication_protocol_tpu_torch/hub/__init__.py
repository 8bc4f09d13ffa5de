"""The multi-session replication hub: one shared engine on kernel B1,
many sessions.

The port of ``dat_replication_protocol_tpu/hub/``.  Sessions register
with a key; their digest work is batched across sessions into single
dispatches on one shared :class:`~..backend.cuda_backend.DigestPipeline`
(or a mesh of them), and completions route back by session.  See
:mod:`.engine` for admission, windows, weighted-fair batching, shedding
and the mesh.
"""

from .engine import (
    HubBusy,
    HubError,
    HubSession,
    ReplicationHub,
    SessionShed,
    mesh_follower,
)

__all__ = [
    "ReplicationHub",
    "HubSession",
    "HubBusy",
    "HubError",
    "SessionShed",
    "mesh_follower",
]
