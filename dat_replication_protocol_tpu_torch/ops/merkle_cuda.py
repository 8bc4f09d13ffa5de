"""Kernel B2's wrapper: one Merkle tree level on the card.

The counterpart of ``dat_replication_protocol_tpu/ops/merkle_pallas.py``
``merkle_level_pallas`` (kernel ``merkle_level_native``, :69).  The
kernel is ``csrc/merkle_level.cu`` (one thread per parent, one final
compression of left || right with t = 64).  (N, 4) hi/lo digest words
in, (N/2, 4) parents out, as int32 tensors holding uint32 bits; children
pair even and odd rows.

CPU tensors take the plain version, :func:`.merkle.merkle_level`; a CUDA
tensor launches the kernel or raises.  The wrapper is the kernel-sentinel
site ``ops.merkle_cuda.level``.
"""

from __future__ import annotations

import torch

from ..obs.device import kernel_site, rows_key
from . import _build
from .merkle import merkle_level


def merkle_level_kernel(hh, hl):
    """(N, 4) digests -> (N//2, 4) parents: kernel B2 on CUDA, the plain
    version on CPU.  Counts its launches in
    ``merkle_level_kernel.launches``."""
    if hh.device.type == "cpu":
        return merkle_level(hh, hl)
    if hh.device.type != "cuda":
        raise ValueError(f"unsupported device {hh.device}")
    for name, t in (("hh", hh), ("hl", hl)):
        if t.device != hh.device:
            raise ValueError(f"{name} is on {t.device}, hh on {hh.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    n = hh.shape[0]
    if hh.dim() != 2 or hh.shape[1] != 4 or hl.shape != hh.shape or n % 2:
        raise ValueError(f"expected (N, 4) halves with N even, got "
                         f"{tuple(hh.shape)} and {tuple(hl.shape)}")
    P = n // 2
    ph = torch.empty((P, 4), dtype=torch.int32, device=hh.device)
    pl = torch.empty((P, 4), dtype=torch.int32, device=hh.device)
    if P == 0:
        return ph, pl
    lib = _build.load("merkle_level")
    with torch.cuda.device(hh.device):
        stream = torch.cuda.current_stream(hh.device).cuda_stream
        rc = lib.dat_merkle_level(hh.data_ptr(), hl.data_ptr(),
                                  ph.data_ptr(), pl.data_ptr(), P, stream)
    if rc != 0:
        raise RuntimeError(f"merkle level kernel launch failed: cudaError {rc}")
    merkle_level_kernel.launches += 1
    return ph, pl


merkle_level_kernel.launches = 0
# a level's row count only sizes the grid: a tree's levels share one
# signature
merkle_level_kernel = kernel_site("ops.merkle_cuda.level",
                                  merkle_level_kernel, key=rows_key(0))
