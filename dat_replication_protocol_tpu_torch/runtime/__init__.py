"""Change-log replay, content addressing, the tree-sync descent and the
anti-entropy drivers (rateless reconcile, snapshot bootstrap) on top of
the device ops."""

from .content import (ContentSummary, content_address, content_digests,
                      delta, reassemble)
from .reconcile_driver import (RatelessReplica, ResponderState,
                               reconcile_local, run_initiator, run_responder)
from .replay import (ChangeColumns, FrameIndex, decode_change_columns,
                     encode_change_columns, encode_change_log, replay_log,
                     split_frames)
from .snapshot_driver import (SnapshotJoiner, SnapshotResponder,
                              SnapshotSource, run_snapshot_joiner,
                              run_snapshot_responder, snapshot_local)
from .tree_sync import TreeSyncSession
from .tree_sync import sync as tree_sync

__all__ = ["ChangeColumns", "ContentSummary", "FrameIndex",
           "RatelessReplica", "ResponderState", "SnapshotJoiner",
           "SnapshotResponder", "SnapshotSource", "TreeSyncSession",
           "content_address", "content_digests", "decode_change_columns",
           "delta", "encode_change_columns", "encode_change_log",
           "reassemble", "reconcile_local", "replay_log", "run_initiator",
           "run_responder", "run_snapshot_joiner", "run_snapshot_responder",
           "snapshot_local", "split_frames", "tree_sync"]
