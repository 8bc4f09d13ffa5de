"""Wrappers of kernels B3, B4 and B5: the gear scans on the card, and the
launch geometry of B4's staged scan.

The counterparts of ``dat_replication_protocol_tpu/ops/rabin_pallas.py``
``gear_candidates_pallas`` (B3, kernel ``gear_candidates_native`` :112),
``gear_first_pallas`` (B4, ``gear_first_native`` :407) and
``gear_window_first_pallas`` (B5, ``gear_window_first_native`` :284).
The kernels are ``csrc/gear_candidates.cu``, ``csrc/gear_first.cu`` and
``csrc/gear_window_first.cu`` over the shared step in ``csrc/gear.cuh``;
B5 runs the window scan there that B6 runs with its occupancy fold, and
B4 scans through the shared-memory ring of ``csrc/gear_staged.cuh``,
whose geometry :func:`staged_geometry` computes here.  The source notes
say what bounds each kernel.  Each wrapper keeps the reference wrapper's
public shapes: (T, S/4) int32 rows of u32 words in.
The TPU's ``(ng, 64, 8, T/8)`` layout is not carried over.

CPU tensors take the plain versions in :mod:`.rabin`; a CUDA tensor
launches the kernel or raises.  Each wrapper counts its launches in its
``launches`` attribute and is a kernel-sentinel site
(``ops.rabin_cuda.candidates|first|window_first``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.device import kernel_site
from . import _build
from .rabin import (GROUP, _SENT_OFF, gear_candidates_tiled,
                    gear_first_tiled, gear_window_first)


def check_rows(rows: torch.Tensor, avg_bits: int,
               thin_bits: int | None = None) -> None:
    """Raise on rows the gear kernels do not take."""
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")
    if rows.dim() != 2 or (rows.shape[1] * 4) % GROUP:
        raise ValueError(f"expected (T, S/4) rows with S a multiple of "
                         f"{GROUP}, got {tuple(rows.shape)}")
    if not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError("rows must be contiguous and 16-byte aligned")
    if not 1 <= avg_bits <= 31:
        raise ValueError(f"avg_bits must be in [1, 31], got {avg_bits}")
    if rows.numel() * 4 >= 1 << 31:
        raise ValueError("rows hold 2 GiB or more; slab the stream")
    if thin_bits is not None:
        payload = rows.shape[1] * 4 - GROUP
        if not 8 <= thin_bits <= 16 or payload % (1 << thin_bits):
            raise ValueError(f"window of 2**{thin_bits} B must be 256 B to "
                             f"64 KiB and divide the payload ({payload} B)")


# the staged scan of B4 (csrc/gear_staged.cuh): threads a CTA, which is
# also groups a span, and the shared memory of its ring of two spans
STAGED_THREADS = 256
STAGED_SMEM = 2 * (STAGED_THREADS + 1) * (GROUP + 16)
_SMEM_PER_SM = 228 << 10  # an H100 SM's shared memory, 1 KiB of it per CTA


class StagedGeometry(NamedTuple):
    """A launch of B4's staged scan: the (T, S) rows read as one run of
    T * S/256 groups, cut into ``total_spans`` spans of
    ``STAGED_THREADS`` groups (a span may cross a row boundary; only the
    last one is ragged), walked by a persistent grid of ``ctas`` CTAs."""
    ctas: int
    total_spans: int


def staged_geometry(T: int, S: int, sms: int = 132) -> StagedGeometry:
    """B4's launch over T rows of S bytes on a card of ``sms`` SMs: as
    many CTAs as stay resident (shared memory allows one an SM), at most
    one a span.  Raises on rows the kernel does not take."""
    if S % GROUP or S <= 0 or T < 0:
        raise ValueError(f"rows of {S} B: not a positive multiple of "
                         f"{GROUP}")
    total = -(-T * (S // GROUP) // STAGED_THREADS)
    per_sm = _SMEM_PER_SM // (STAGED_SMEM + 1024)
    return StagedGeometry(min(total, sms * per_sm), total)


def window_reduce(words: torch.Tensor, firsts: torch.Tensor,
                  thin_bits: int):
    """B5's and B6's reduction as their window scan (``csrc/gear.cuh``
    ``gear_window_scan``) decomposes it, from per-group results:
    ``words`` (T, S/32) packed hit words (B3's output) and ``firsts``
    (T, S/256) group-local first hits (B4's).  Group 0 of a row is
    dropped; a window's ``first`` is the hit of its earliest group
    that has one, as an offset in the window (``1 << 30`` when empty),
    and its ``occ`` the OR of its words.  Returns both as (T * nwin,)
    int32, in stream order."""
    T = firsts.shape[0]
    gpw = (1 << thin_bits) // GROUP
    f = firsts[:, 1:].to(torch.int64).reshape(T, -1, gpw)
    at = torch.arange(gpw, dtype=torch.int64, device=f.device) * GROUP
    first = torch.where(f < GROUP, f + at, _SENT_OFF).amin(-1)
    w = words[:, GROUP // 32:].to(torch.int64).reshape(T, first.shape[1], -1)
    occ = w[..., 0]
    for k in range(1, w.shape[-1]):
        occ = occ | w[..., k]
    return (first.reshape(-1).to(torch.int32),
            occ.reshape(-1).to(torch.int32))


def _launch(name: str, rows: torch.Tensor, outs, *ints) -> None:
    lib = _build.load(name)
    fn = getattr(lib, f"dat_{name}")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = fn(rows.data_ptr(), *(o.data_ptr() for o in outs),
                rows.shape[0], rows.shape[1] * 4, *ints, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _device_of(rows: torch.Tensor) -> str:
    if rows.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {rows.device}")
    return rows.device.type


def gear_candidates_kernel(rows: torch.Tensor, avg_bits: int = 13):
    """(T, S/4) rows -> (T, S/32) int32 packed candidate bitmask: kernel
    B3 on CUDA, :func:`.rabin.gear_candidates_tiled` on CPU."""
    if _device_of(rows) == "cpu":
        return gear_candidates_tiled(rows, avg_bits)
    check_rows(rows, avg_bits)
    T, nwords = rows.shape
    bits = torch.empty((T, nwords // 8), dtype=torch.int32,
                       device=rows.device)
    _launch("gear_candidates", rows, (bits,), avg_bits)
    gear_candidates_kernel.launches += 1
    return bits


def gear_first_kernel(rows: torch.Tensor, avg_bits: int = 13):
    """(T, S/4) rows -> (T, S/256) int32 first-hit offsets or ``NO_HIT``:
    kernel B4 on CUDA, :func:`.rabin.gear_first_tiled` on CPU."""
    if _device_of(rows) == "cpu":
        return gear_first_tiled(rows, avg_bits)
    check_rows(rows, avg_bits)
    T, nwords = rows.shape
    first = torch.empty((T, nwords * 4 // GROUP), dtype=torch.int32,
                        device=rows.device)
    if T:
        geom = staged_geometry(T, nwords * 4, sms=sm_count(rows.device))
        _launch("gear_first", rows, (first,), avg_bits, *geom)
        gear_first_kernel.launches += 1
    return first


def gear_window_first_kernel(rows: torch.Tensor, avg_bits: int,
                             thin_bits: int):
    """(T, S/4) rows -> (T * nwin,) int32 first candidate per window or
    ``1 << 30``: kernel B5 on CUDA, :func:`.rabin.gear_window_first` on
    CPU."""
    if _device_of(rows) == "cpu":
        return gear_window_first(rows, avg_bits, thin_bits)
    check_rows(rows, avg_bits, thin_bits)
    T, nwords = rows.shape
    nwin = (nwords * 4 - GROUP) >> thin_bits
    first = torch.empty((T * nwin,), dtype=torch.int32, device=rows.device)
    _launch("gear_window_first", rows, (first,), avg_bits, thin_bits)
    gear_window_first_kernel.launches += 1
    return first


gear_candidates_kernel.launches = 0
gear_first_kernel.launches = 0
gear_window_first_kernel.launches = 0
gear_candidates_kernel = kernel_site("ops.rabin_cuda.candidates",
                                     gear_candidates_kernel)
gear_first_kernel = kernel_site("ops.rabin_cuda.first", gear_first_kernel)
gear_window_first_kernel = kernel_site("ops.rabin_cuda.window_first",
                                       gear_window_first_kernel)
