"""Kernel B1's wrapper: batched BLAKE2b on the card.

The counterpart of ``dat_replication_protocol_tpu/ops/blake2b_pallas.py``
``blake2b_packed_pallas`` (kernel ``blake2b_native``, :228).  The kernel
is ``csrc/blake2b.cu`` in two variants, one thread per item or four lanes
per item; :func:`lanes_per_item` picks one from the batch size, and
the source note says what bounds each.  The wrapper keeps the
reference's public layout: (B, nblocks, 16) hi/lo message words in,
(B, 8) hi/lo digest words out, as int32 tensors holding uint32 bits.

The chained entry (``dat_blake2b_update`` in the same source, on the
same round code and in the same two variants) advances per-item chaining
states and 64-bit byte counters over one segment each; its wrapper is
:func:`blake2b_update_kernel`, the counterpart of the reference's
``blake2b_update`` (``ops/blake2b.py:383``), a ``jax.jit`` scan.

CPU tensors take the plain versions, :func:`.blake2b.blake2b_packed` and
:func:`.blake2b.blake2b_update`; a CUDA tensor launches the kernel or
raises.  Both wrappers are kernel-sentinel sites
(``ops.blake2b_cuda.packed``, ``ops.blake2b_cuda.update``).
"""

from __future__ import annotations

import torch

from ..obs.device import kernel_site, rows_key
from . import _build
from .blake2b import DIGEST_SIZE, blake2b_packed, blake2b_update

LANES = (1, 4)
# An H100 has 132 SMs x 4 schedulers: at one warp of 32 items each, 16,896
# items.  Up to the power of two below it (buckets are powers of two), one
# thread per item leaves every scheduler one warp at most.
QUAD_MAX_ITEMS = 16384


def lanes_per_item(batch: int) -> int:
    """Lanes per item for a bucket of ``batch`` items: 4 or 1.

    A warp issues in order, so a scheduler that holds one warp waits out
    every dependent step of that warp's compressions.  Up to
    ``QUAD_MAX_ITEMS`` items, one thread per item leaves each scheduler
    one warp at most, and four lanes per item (a quarter of the
    instructions per lane, four times the warps) finish sooner: the
    digest session's blob and change buckets and content addressing's
    chunk buckets.  Past it the card is full either way, and one thread
    per item issues fewer instructions per item (shuffles and staged
    message loads are the quad variant's extra): ``entry()``'s 2^20
    items.  The block count does not move the choice, since both
    variants take time in proportion to it (``PERF.md``).
    """
    return 4 if batch <= QUAD_MAX_ITEMS else 1


def variant_name(batch: int, device) -> str:
    """What runs a bucket of ``batch`` items on ``device``: B1's ``quad``
    or ``thread`` variant, or the ``plain`` version on the CPU (the
    engine notes' name)."""
    if device.type == "cpu":
        return "plain"
    return "quad" if lanes_per_item(batch) == 4 else "thread"


def _check(mh, ml, lengths, digest_size):
    if not 1 <= digest_size <= 64:
        raise ValueError(f"digest_size must be in [1, 64], got {digest_size}")
    for name, t in (("mh", mh), ("ml", ml), ("lengths", lengths)):
        if t.device != mh.device:
            raise ValueError(f"{name} is on {t.device}, mh on {mh.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if mh.dim() != 3 or mh.shape[2] != 16 or ml.shape != mh.shape:
        raise ValueError(f"expected (B, nblocks, 16) halves, got "
                         f"{tuple(mh.shape)} and {tuple(ml.shape)}")
    if lengths.shape != (mh.shape[0],):
        raise ValueError(f"lengths must be ({mh.shape[0]},), got "
                         f"{tuple(lengths.shape)}")
    for t in (mh, ml):  # the kernels read 16-byte pieces of each block
        if t.data_ptr() % 16:
            raise ValueError("message halves must be 16-byte aligned")


def launch(mh, ml, lengths, digest_size: int, lanes: int):
    """Launch the variant with ``lanes`` lanes per item on CUDA tensors
    (no plain fallback); counts the launch."""
    if mh.device.type != "cuda":
        raise ValueError(f"unsupported device {mh.device}")
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    _check(mh, ml, lengths, digest_size)
    B, nblocks, _ = mh.shape
    hh = torch.empty((B, 8), dtype=torch.int32, device=mh.device)
    hl = torch.empty((B, 8), dtype=torch.int32, device=mh.device)
    if B == 0:
        return hh, hl
    lib = _build.load("blake2b")
    with torch.cuda.device(mh.device):
        stream = torch.cuda.current_stream(mh.device).cuda_stream
        rc = lib.dat_blake2b_packed(
            mh.data_ptr(), ml.data_ptr(), lengths.data_ptr(),
            hh.data_ptr(), hl.data_ptr(), B, nblocks, digest_size, lanes,
            stream)
    if rc != 0:
        raise RuntimeError(f"blake2b kernel launch failed: cudaError {rc}")
    blake2b_packed_kernel.launches += 1
    blake2b_packed_kernel.launches_by_lanes[lanes] += 1
    by_blocks = blake2b_packed_kernel.launches_by_blocks
    by_blocks[nblocks] = by_blocks.get(nblocks, 0) + 1
    return hh, hl


def blake2b_packed_kernel(mh, ml, lengths, digest_size: int = DIGEST_SIZE):
    """Hash a padded batch: kernel B1 on CUDA, the plain version on CPU.

    Same contract as :func:`.blake2b.blake2b_packed`: returns ``(hh, hl)``,
    each (B, 8) int32.  Counts its launches in
    ``blake2b_packed_kernel.launches``, by variant in
    ``blake2b_packed_kernel.launches_by_lanes`` and by the bucket's block
    count in ``blake2b_packed_kernel.launches_by_blocks``.
    """
    if mh.device.type == "cpu":
        return blake2b_packed(mh, ml, lengths, digest_size)
    return launch(mh, ml, lengths, digest_size,
                  lanes_per_item(mh.shape[0]))


blake2b_packed_kernel.launches = 0
blake2b_packed_kernel.launches_by_lanes = dict.fromkeys(LANES, 0)
blake2b_packed_kernel.launches_by_blocks = {}
# the host buckets the block count; the item count only sizes the grid
blake2b_packed_kernel = kernel_site("ops.blake2b_cuda.packed",
                                    blake2b_packed_kernel, key=rows_key(0))


def _check_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last):
    _check(mh, ml, seg_lengths, DIGEST_SIZE)
    B = mh.shape[0]
    for name, t, shape, dtype in (
            ("hh", hh, (B, 8), torch.int32), ("hl", hl, (B, 8), torch.int32),
            ("t_hi", t_hi, (B,), torch.int32),
            ("t_lo", t_lo, (B,), torch.int32),
            ("is_last", is_last, (B,), torch.bool)):
        if t.device != mh.device:
            raise ValueError(f"{name} is on {t.device}, mh on {mh.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(t.shape)}")


def launch_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last,
                  lanes: int):
    """Launch the chained entry's variant with ``lanes`` lanes per item on
    CUDA tensors (no plain fallback); counts the launch."""
    if mh.device.type != "cuda":
        raise ValueError(f"unsupported device {mh.device}")
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    _check_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last)
    B, nblocks, _ = mh.shape
    out = (torch.empty((B, 8), dtype=torch.int32, device=mh.device),
           torch.empty((B, 8), dtype=torch.int32, device=mh.device),
           torch.empty((B,), dtype=torch.int32, device=mh.device),
           torch.empty((B,), dtype=torch.int32, device=mh.device))
    if B == 0:
        return out
    lib = _build.load("blake2b")
    with torch.cuda.device(mh.device):
        stream = torch.cuda.current_stream(mh.device).cuda_stream
        rc = lib.dat_blake2b_update(
            *(t.data_ptr() for t in (hh, hl, t_hi, t_lo, mh, ml, seg_lengths,
                                     is_last) + out),
            B, nblocks, lanes, stream)
    if rc != 0:
        raise RuntimeError(f"blake2b update kernel launch failed: "
                           f"cudaError {rc}")
    blake2b_update_kernel.launches += 1
    blake2b_update_kernel.launches_by_lanes[lanes] += 1
    return out


def blake2b_update_kernel(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last):
    """Advance chaining states over one segment per item: B1's chained
    entry on CUDA, :func:`.blake2b.blake2b_update` on CPU.

    Same contract as the plain version: (B, 8) int32 state halves, (B,)
    int32 counter halves, (B, nblocks, 16) segment halves, (B,) int32
    segment lengths and (B,) bool last flags in; ``(hh, hl, t_hi, t_lo)``
    out.  The variant is :func:`lanes_per_item`'s.  Counts its launches in
    ``blake2b_update_kernel.launches`` and by variant in
    ``blake2b_update_kernel.launches_by_lanes``.
    """
    if mh.device.type == "cpu":
        return blake2b_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths,
                              is_last)
    return launch_update(hh, hl, t_hi, t_lo, mh, ml, seg_lengths, is_last,
                         lanes_per_item(mh.shape[0]))


blake2b_update_kernel.launches = 0
blake2b_update_kernel.launches_by_lanes = dict.fromkeys(LANES, 0)
blake2b_update_kernel = kernel_site("ops.blake2b_cuda.update",
                                    blake2b_update_kernel, key=rows_key(4))
