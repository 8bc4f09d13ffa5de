"""Kernel B1's wrapper: batched BLAKE2b on the card.

The counterpart of ``dat_replication_protocol_tpu/ops/blake2b_pallas.py``
``blake2b_packed_pallas`` (kernel ``blake2b_native``, :228).  The kernel
is ``csrc/blake2b.cu`` (one thread per item, chaining state in
registers; its source note says what bounds it).  The wrapper keeps the
reference's public layout: (B, nblocks, 16) hi/lo message words in,
(B, 8) hi/lo digest words out, as int32 tensors holding uint32 bits.

CPU tensors take the plain version, :func:`.blake2b.blake2b_packed`; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .blake2b import DIGEST_SIZE, blake2b_packed


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
    for t in (mh, ml):  # the kernel reads each block as four uint4
        if t.data_ptr() % 16:
            raise ValueError("message halves must be 16-byte aligned")


def blake2b_packed_kernel(mh, ml, lengths, digest_size: int = DIGEST_SIZE):
    """Hash a padded batch: kernel B1 on CUDA, the plain version on CPU.

    Same contract as :func:`.blake2b.blake2b_packed`: returns ``(hh, hl)``,
    each (B, 8) int32.  Counts its launches in
    ``blake2b_packed_kernel.launches``.
    """
    if mh.device.type == "cpu":
        return blake2b_packed(mh, ml, lengths, digest_size)
    if mh.device.type != "cuda":
        raise ValueError(f"unsupported device {mh.device}")
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
            hh.data_ptr(), hl.data_ptr(), B, nblocks, digest_size, stream)
    if rc != 0:
        raise RuntimeError(f"blake2b kernel launch failed: cudaError {rc}")
    blake2b_packed_kernel.launches += 1
    return hh, hl


blake2b_packed_kernel.launches = 0
