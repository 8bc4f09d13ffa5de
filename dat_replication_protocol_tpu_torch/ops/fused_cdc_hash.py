"""Single-residency content addressing on the card, and kernel B6.

The counterpart of ``dat_replication_protocol_tpu/ops/
fused_cdc_hash_pallas.py``:

* :func:`gear_window_first_checked_kernel` wraps kernel B6
  (``csrc/gear_window_first_checked.cu``; the TPU kernel is
  ``gear_window_first_checked_native`` :163): B5's per-window first
  candidate plus an independent occupancy fold, and ``viol``, the count
  of windows where the two disagree, reduced here with torch ops as the
  reference wrapper does (:250-252).  CPU tensors take the plain
  version, :func:`.rabin.gear_window_first_checked`.
* :func:`pack_extents_device` gathers chunk extents out of the resident
  byte buffer into B1's (B, nblocks, 16) layout with torch ops, where
  the reference left the gather to XLA.
* :func:`hash_cuts_device` hashes every chunk on B1, bucket by bucket.
* :func:`content_begin` uploads a blob once; the CDC scan and the chunk
  hash both read that one resident buffer.  Its ``collect`` counts the
  blob in ``cdc.fused.bytes`` and its chunks in ``cdc.fused.chunks``.

B6's wrapper and the extent pack are kernel-sentinel sites
(``ops.fused_cdc_hash.window_first_checked``, ``.pack_extents``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.device import kernel_site
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..utils.device import resolve_device
from .rabin import (GROUP, TILE_BYTES, _SENT_OFF, _clamp_thin_bits,
                    _greedy_select, candidates_begin, check_route,
                    default_sizes, gear_window_first_checked, stage_words)
from .rabin_cuda import _device_of, _launch, check_rows

# per-call residency cap: the reference computes extent-pack positions
# in int32 and keeps a 64 MiB margin below 2 GiB for the padded width of
# the last chunk; the port keeps the same threshold so that it routes
# every blob as the reference does
RESIDENCY_CAP = (1 << 31) - (1 << 26)

# blobs and chunks through the single-residency pipeline
_M_FUSED_BYTES = _counter("cdc.fused.bytes")
_M_FUSED_CHUNKS = _counter("cdc.fused.chunks")


def gear_window_first_checked_kernel(rows: torch.Tensor, avg_bits: int,
                                     thin_bits: int):
    """(T, S/4) rows -> ``(first, viol)``: kernel B6 on CUDA, the plain
    version on CPU.  ``first`` (T * nwin,) int32, ``1 << 30`` for an
    empty window; ``viol`` a 0-d int64 tensor on the rows' device.
    Counts its launches in ``gear_window_first_checked_kernel.launches``.
    """
    if _device_of(rows) == "cpu":
        return gear_window_first_checked(rows, avg_bits, thin_bits)
    check_rows(rows, avg_bits, thin_bits)
    T, nwords = rows.shape
    nwin = (nwords * 4 - GROUP) >> thin_bits
    first = torch.empty((T * nwin,), dtype=torch.int32, device=rows.device)
    occ = torch.empty((T * nwin,), dtype=torch.int32, device=rows.device)
    if T * nwin:
        _launch("gear_window_first_checked", rows, (first, occ), avg_bits,
                thin_bits)
        gear_window_first_checked_kernel.launches += 1
    viol = ((occ != 0) != (first != _SENT_OFF)).sum()
    return first, viol


gear_window_first_checked_kernel.launches = 0
gear_window_first_checked_kernel = kernel_site(
    "ops.fused_cdc_hash.window_first_checked",
    gear_window_first_checked_kernel)


def pack_extents_device(data: torch.Tensor, offs, lens, nblocks: int):
    """(B,) extents of a resident byte buffer -> ``(mh, ml, lengths)`` on
    its device in the :func:`.blake2b.blake2b_packed` contract, padding
    zero.  ``data`` is the stream as a flat uint8 tensor (a word buffer
    viewed as bytes).  Refuses positions past the residency cap, as the
    reference does (its positions are int32)."""
    offs = np.asarray(offs, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    width = nblocks * 128
    if len(offs) and int(offs.max()) + width >= 1 << 31:
        raise ValueError(
            f"extent pack positions exceed int32 range (max offset "
            f"{int(offs.max())} + padded width {width}); keep residencies "
            f"under RESIDENCY_CAP")
    dev = data.device
    offs_d = torch.as_tensor(offs, device=dev)
    lens_d = torch.as_tensor(lens, device=dev)
    idx = offs_d[:, None] + torch.arange(width, dtype=torch.int64,
                                         device=dev)
    valid = idx < (offs_d + lens_d)[:, None]
    raw = torch.where(valid, data[idx.clamp_(max=data.numel() - 1)], 0)
    words = raw.to(torch.uint8).view(torch.int32).view(len(offs), nblocks,
                                                        32)
    return (words[:, :, 1::2].contiguous(), words[:, :, 0::2].contiguous(),
            lens_d.to(torch.int32))


# keyed on the bucketed block count: the extent count only sizes the
# gather
pack_extents_device = kernel_site(
    "ops.fused_cdc_hash.pack_extents", pack_extents_device,
    key=lambda data, offs, lens, nblocks: (str(data.dtype), nblocks))


def hash_cuts_device(words: torch.Tensor, cuts):
    """Chunk digests for ``cuts`` over a resident word buffer, as
    ``(hh, hl)`` tensors on its device, each (nchunks, 4) int32, in cut
    order.  Extents are bucketed by power-of-two block count, packed on
    the device in chunks of at most ``feed.PIPELINE_BYTES`` and hashed by
    B1.
    """
    from ..batch.feed import PIPELINE_BYTES, _hash_buckets

    ends = np.asarray(cuts, dtype=np.int64)
    offs = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
    lens = ends - offs
    data = words.view(torch.uint8)
    return _hash_buckets(
        lens, words.device, PIPELINE_BYTES,
        lambda idx, nb: pack_extents_device(data, offs[idx], lens[idx], nb),
        site="fused_cdc_hash.hash_cuts")


def content_begin(buf: np.ndarray, avg_bits: int = 13,
                  min_size: int | None = None, max_size: int | None = None,
                  route: str = "bitmask", device: torch.device | str = "cuda"):
    """Single-residency content addressing of one host buffer.

    Uploads the blob's words once (pinned staging, no blocking copy) in
    tiles of ``TILE_BYTES``; the candidate scan (``route``'s kernel) and
    the chunk hash read the same resident buffer.  Returns ``collect()`` -> ``(cuts, hh, hl)``:
    cut end-offsets (list) and the chunk digests as (nchunks, 4) int32
    tensors on ``device``, ready for a Merkle fold there.
    """
    check_route(route)
    dev = resolve_device(device)
    min_size, max_size = default_sizes(avg_bits, min_size, max_size)
    nbytes = len(buf)
    if nbytes >= RESIDENCY_CAP:
        raise ValueError(f"{nbytes} bytes reach RESIDENCY_CAP; use the "
                         "slabbed route")
    thin_bits = _clamp_thin_bits(max(min_size, 1).bit_length() - 1,
                                 TILE_BYTES)
    T = -(-nbytes // TILE_BYTES)
    words = stage_words(buf, T * TILE_BYTES // 4, dev)  # the one upload
    cand = candidates_begin(words, nbytes, avg_bits, TILE_BYTES,
                            thin_bits=thin_bits, route=route)

    def collect():
        cuts = _greedy_select(cand(), nbytes, min_size, max_size)
        hh, hl = hash_cuts_device(words, cuts)
        if _OBS.on:
            _M_FUSED_BYTES.inc(nbytes)
            _M_FUSED_CHUNKS.inc(len(cuts))
        return cuts, hh, hl

    return collect
