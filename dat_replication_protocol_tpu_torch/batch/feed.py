"""Batching feed: ragged extents of one host buffer -> B1 batches.

The counterpart of ``dat_replication_protocol_tpu/batch/feed.py``
(``pack_ragged`` :51, ``bucketed_extents`` :104, ``hash_extents`` /
``hash_extents_device`` :115-244).  Every bucket goes to kernel B1's
wrapper, staged in pinned host memory and copied without blocking on
CUDA; there is no item floor and no buffer donation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import blake2b
from ..utils.device import resolve_device

BLOCK_BYTES = blake2b.BLOCK_BYTES
PIPELINE_BYTES = 64 << 20  # padded message bytes per B1 launch, at most


def pack_ragged(buf: np.ndarray, offs, lens, nblocks: int | None = None):
    """Pack extents of ``buf`` into zero-padded (B, nblocks, 16) hi/lo
    uint32 words plus (B,) uint32 lengths (numpy), as
    ``blake2b.pack_payloads`` would pack the extents' bytes."""
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    B = len(offs)
    need = max(1, -(-(int(lens.max()) if B else 0) // BLOCK_BYTES))
    if nblocks is None:
        nblocks = need
    elif nblocks < need:
        raise ValueError(f"nblocks={nblocks} < required {need}")
    width = nblocks * BLOCK_BYTES
    out = np.zeros((B, width), dtype=np.uint8)
    total = int(lens.sum())
    if total and B <= 4096:
        # few items: one memcpy each
        for i in range(B):
            out[i, :lens[i]] = buf[offs[i]:offs[i] + lens[i]]
    elif total:
        # ragged scatter: within-item ranks, then source and destination
        ranks = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens)
        src = np.repeat(offs, lens) + ranks
        dst = np.repeat(np.arange(B, dtype=np.int64) * width, lens) + ranks
        out.reshape(-1)[dst] = buf[src]
    words = out.view("<u4").reshape(B, nblocks, 32)
    return (np.ascontiguousarray(words[:, :, 1::2]),
            np.ascontiguousarray(words[:, :, 0::2]),
            lens.astype(np.uint32))


def bucketed_extents(lens) -> dict[int, np.ndarray]:
    """Extent indices grouped by power-of-two padded block count."""
    lens = np.asarray(lens, dtype=np.int64)
    blocks = np.maximum(1, -(-lens // BLOCK_BYTES))
    nb = 1 << np.ceil(np.log2(blocks)).astype(np.int64)
    return {int(b): np.nonzero(nb == b)[0] for b in np.unique(nb)}


def hash_extents_device(buf: np.ndarray, offs, lens, device="cuda",
                        pipeline_bytes: int = PIPELINE_BYTES):
    """BLAKE2b-256 of extents of a host buffer, as ``(hh, hl)`` tensors
    on ``device``, each (N, 4) int32, in extent order.

    Each bucket is packed on the host in chunks of at most
    ``pipeline_bytes`` of padded messages; on CUDA each chunk is staged
    in pinned memory and copied without blocking, so the host packs
    chunk k+1 while B1 hashes chunk k.
    """
    dev = resolve_device(device)
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    return _hash_buckets(
        lens, dev, pipeline_bytes,
        lambda idx, nb: _stage(pack_ragged(buf, offs[idx], lens[idx], nb),
                               dev))


def _stage(packed, dev: torch.device):
    on_cuda = dev.type == "cuda"
    out = []
    for arr in packed:
        t = torch.empty(arr.shape, dtype=torch.int32, pin_memory=on_cuda)
        t.numpy()[...] = arr.view(np.int32)
        out.append(t.to(dev, non_blocking=True) if on_cuda else t)
    return out


def _hash_buckets(lens: np.ndarray, dev: torch.device, pipeline_bytes: int,
                  pack):
    """Shared bucket loop of the two chunk-hash paths: ``pack(idx, nb)``
    gives (mh, ml, lengths) on ``dev`` for extents ``idx`` at ``nb``
    blocks; every chunk goes to B1; digests land in extent order."""
    from ..ops.blake2b_cuda import blake2b_packed_kernel

    n = len(lens)
    out_hh = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    out_hl = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    for nb, idx in bucketed_extents(lens).items():
        chunk_b = max(1, pipeline_bytes // (nb * BLOCK_BYTES))
        for c0 in range(0, len(idx), chunk_b):
            sub = idx[c0:c0 + chunk_b]
            hh, hl = blake2b_packed_kernel(*pack(sub, nb))
            at = torch.as_tensor(sub, device=dev)
            out_hh[at] = hh[:, :4]
            out_hl[at] = hl[:, :4]
    return out_hh, out_hl


def hash_extents(buf: np.ndarray, offs, lens, device="cuda",
                 pipeline_bytes: int = PIPELINE_BYTES) -> np.ndarray:
    """BLAKE2b-256 digests of extents of ``buf``, (N, 32) uint8 numpy."""
    from ..ops.merkle import digest_matrix

    if not len(offs):
        return np.empty((0, 32), dtype=np.uint8)
    return digest_matrix(*hash_extents_device(buf, offs, lens, device,
                                              pipeline_bytes))
