"""Device ops: batched BLAKE2b (kernel B1), Merkle levels (kernel B2) and
the gear CDC scans (kernels B3-B6).

Importing this package builds nothing: the CUDA kernels are compiled at
their first launch (:mod:`._build`).
"""

from .blake2b import blake2b_batch, blake2b_batch_begin, blake2b_packed
from .merkle import build_tree, merkle_level, root
from .rabin import chunk_stream

__all__ = ["blake2b_batch", "blake2b_batch_begin", "blake2b_packed",
           "build_tree", "chunk_stream", "merkle_level", "root"]
