"""Batching feed: ragged host extents -> padded BLAKE2b batches."""
