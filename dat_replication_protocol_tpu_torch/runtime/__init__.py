"""Content addressing and the tree-sync descent on top of the device
ops."""

from .content import (ContentSummary, content_address, content_digests,
                      delta, reassemble)
from .tree_sync import TreeSyncSession
from .tree_sync import sync as tree_sync

__all__ = ["ContentSummary", "TreeSyncSession", "content_address",
           "content_digests", "delta", "reassemble", "tree_sync"]
