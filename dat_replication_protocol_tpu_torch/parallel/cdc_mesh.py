"""Sequence-parallel content-defined chunking over the mesh.

The counterpart of ``dat_replication_protocol_tpu/parallel/cdc_mesh.py``.
The byte stream is tiled as :mod:`..ops.rabin` tiles it, rows of ``[GROUP
context | stride payload]``, and the row axis is split over the ranks.
Each rank builds its rows from its contiguous slice of the payload rows
plus the context tail of the row before its slice, the **halo**, and runs
the same gear scan as one device: kernel B3
(:func:`..ops.rabin_cuda.gear_candidates_kernel`) on the card, its plain
version on CPU tensors.  The gear hash forgets past WINDOW bytes, so one
fixed-size halo a rank is the whole exchange.

The reference sends each rank's tail to its right neighbour with a
``ppermute``.  Here every rank's (1, 64)-word tail is gathered with one
``all_gather`` and each rank keeps its left neighbour's: a send to self
fails under NCCL with one rank, and the gather is O(ranks) words and runs
on both backends.  The reference's ``use_pallas=`` has no counterpart:
the port has one device path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rabin import GROUP, _PREFIX_WORDS
from ..ops.rabin_cuda import gear_candidates_kernel
from .mesh import Mesh, _all_gather, shard


def sharded_gear_scan(mesh: Mesh, payload_rows, prefix=None,
                      avg_bits: int = 13):
    """Candidate bitmask of a stream split over the ranks, one halo
    exchange.

    ``payload_rows``: (T, stride/4) int32 global payload tiles holding u32
    words (row t = bytes [t*stride, (t+1)*stride), zero-padded tail), T
    divisible by the mesh size.  ``prefix``: optional WINDOW bytes before
    the stream as 16 u32 words (None = the zero seed).  Returns this rank's
    (T/n, width/32) packed candidate bitmask; the valid bit-words of each
    row are ``[GROUP/32, GROUP/32 + stride/32)``, as on one device.
    """
    T, sw = payload_rows.shape
    if (sw * 4) % GROUP:
        raise ValueError(f"stride must be a multiple of {GROUP}")
    n = mesh.size
    if T % n:
        raise ValueError(f"row count {T} not divisible by mesh size {n}")
    payload = shard(mesh, payload_rows)
    pre = torch.zeros((1, _PREFIX_WORDS), dtype=torch.int32,
                      device=mesh.device)
    if prefix is not None:
        ctx = np.asarray(prefix, dtype=np.uint32).reshape(1, -1)
        pre[:, -ctx.shape[1]:] = torch.from_numpy(ctx.view(np.int32))
    tails = _all_gather(mesh, payload[-1:, -_PREFIX_WORDS:])
    first_ctx = pre if mesh.rank == 0 else tails[mesh.rank - 1:mesh.rank]
    ctx = torch.cat([first_ctx, payload[:-1, -_PREFIX_WORDS:]], dim=0)
    rows = torch.cat([ctx, payload], dim=1)
    return gear_candidates_kernel(rows, avg_bits)
