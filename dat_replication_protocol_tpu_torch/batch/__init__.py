"""Batching feed: ragged host extents -> padded BLAKE2b batches, and
replayed change records -> Merkle leaves."""

from .feed import (DeviceChangeBatch, bucketed_extents, decode_batch_device,
                   hash_extents, leaves_from_change_columns,
                   leaves_from_columns, pack_ragged)

__all__ = ["DeviceChangeBatch", "bucketed_extents", "decode_batch_device",
           "hash_extents", "leaves_from_change_columns",
           "leaves_from_columns", "pack_ragged"]
