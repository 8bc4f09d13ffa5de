"""Multi-device scale-out on ``torch.distributed``: the mesh and the
sharded digest, Merkle, diff, sketch and gear-scan steps."""

from .cdc_mesh import sharded_gear_scan
from .mesh import (
    DATA_AXIS,
    Mesh,
    broadcast_payloads,
    broadcast_stop,
    digest_root_step,
    make_mesh,
    pad_batch,
    receive_payloads,
    shard,
    sharded_diff,
    sharded_hash_begin,
    sharded_sketch,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "broadcast_payloads",
    "broadcast_stop",
    "digest_root_step",
    "make_mesh",
    "pad_batch",
    "receive_payloads",
    "shard",
    "sharded_diff",
    "sharded_gear_scan",
    "sharded_hash_begin",
    "sharded_sketch",
]
