"""Change-log replay, content addressing and the tree-sync descent on
top of the device ops."""

from .content import (ContentSummary, content_address, content_digests,
                      delta, reassemble)
from .replay import (ChangeColumns, FrameIndex, decode_change_columns,
                     encode_change_columns, encode_change_log, replay_log,
                     split_frames)
from .tree_sync import TreeSyncSession
from .tree_sync import sync as tree_sync

__all__ = ["ChangeColumns", "ContentSummary", "FrameIndex",
           "TreeSyncSession", "content_address", "content_digests",
           "decode_change_columns", "delta", "encode_change_columns",
           "encode_change_log", "reassemble", "replay_log", "split_frames",
           "tree_sync"]
