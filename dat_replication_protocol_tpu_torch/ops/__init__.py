"""Device ops: batched BLAKE2b (kernel B1), Merkle levels, diff and proofs
(kernel B2), the gear CDC scans (kernels B3-B6), and set reconciliation
(sketch tables and rateless coded symbols).

Importing this package builds nothing: the CUDA kernels are compiled at
their first launch (:mod:`._build`).
"""

from .blake2b import (blake2b_batch, blake2b_batch_begin, blake2b_packed,
                      digests_to_bytes, pack_payloads)
from .merkle import (build_tree, diff_leaves, diff_root_guided,
                     diff_root_guided_packed, diff_snapshots, merkle_level,
                     prove, root, update_leaves, verify_proof)
from .rabin import chunk_stream, gear_candidates_tiled
from .rateless import CodedSymbols, PeelDecoder
from .reconcile import LogSummary

__all__ = ["CodedSymbols", "LogSummary", "PeelDecoder", "blake2b_batch",
           "blake2b_batch_begin", "blake2b_packed", "build_tree",
           "chunk_stream", "diff_leaves", "diff_root_guided",
           "diff_root_guided_packed", "diff_snapshots", "digests_to_bytes",
           "gear_candidates_tiled", "merkle_level", "pack_payloads",
           "prove", "root", "update_leaves", "verify_proof"]
