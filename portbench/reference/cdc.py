"""Content-defined chunking, chunk digests and the Merkle root, plain.

The chunking the ``content-import`` configuration states:

* the gear rolling hash ``h_j = (h_{j-1} << 1) + g(b_j) mod 2^64`` with
  ``g(b) = ((b+1) C1 mod 2^32) | ((b+1) C2 mod 2^32) << 32``, the stream
  seeded with 64 zero bytes; since a byte leaves the state after 64
  shifts, ``h_j = sum_{k<64} g(b_{j-k}) << k`` with ``b_{<0} = 0``;
* position ``j`` is a candidate when ``(h_j >> 32) & (2^avg_bits - 1)``
  is 0;
* only the first candidate of each aligned ``2^thin_bits``-byte window
  survives;
* a greedy pass cuts at the first surviving candidate at least
  ``min_size`` past the previous cut, or ``max_size`` past it when none
  lands by then; the last chunk ends at the stream's end.

The hash is evaluated here by doubling the window, not along the
byte chain: ``H_2w(j) = H_w(j) + (H_w(j - w) << w)`` from ``H_1 = g``,
six passes of whole-array PyTorch operations on ``device`` in blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from .digests import blake2b_extents
from .merkle import root

GEAR_C1 = 0x9E3779B1
GEAR_C2 = 0x85EBCA77
WINDOW = 64
BLOCK = 1 << 27  # positions a pass holds at once


def gear_table(c1: int = GEAR_C1, c2: int = GEAR_C2) -> np.ndarray:
    """g(b) for every byte value, as uint64."""
    v = np.arange(1, 257, dtype=np.uint64)
    m = np.uint64(0xFFFFFFFF)
    return ((v * np.uint64(c1)) & m) | (((v * np.uint64(c2)) & m)
                                        << np.uint64(32))


def candidates(buf: np.ndarray, avg_bits: int, device, c1: int = GEAR_C1,
               c2: int = GEAR_C2) -> np.ndarray:
    """Every candidate position of the stream, ascending (int64)."""
    table = torch.from_numpy(gear_table(c1, c2).view(np.int64)).to(device)
    mask = (1 << avg_bits) - 1
    n = len(buf)
    out = []
    for a in range(0, n, BLOCK):
        b = min(n, a + BLOCK)
        lo = max(0, a - (WINDOW - 1))
        seg = torch.from_numpy(np.ascontiguousarray(buf[lo:b])).to(device)
        h = table[seg.long()]
        if a - lo < WINDOW - 1:  # the stream head: zero bytes before it
            h = torch.cat([table[0].repeat(WINDOW - 1 - (a - lo)), h])
        w = 1
        while w < WINDOW:
            h = h[w:] + (h[:-w] << w)
            w *= 2
        hit = ((h >> 32) & mask) == 0
        out.append(torch.nonzero(hit).flatten().cpu().numpy() + a)
        del seg, h, hit
    return np.concatenate(out) if out else np.empty(0, np.int64)


def thin(cands: np.ndarray, thin_bits: int) -> np.ndarray:
    """The first candidate of each aligned window."""
    if len(cands) == 0:
        return cands
    win = cands >> thin_bits
    keep = np.concatenate([[True], win[1:] != win[:-1]])
    return cands[keep]


def greedy(cands: np.ndarray, length: int, min_size: int,
           max_size: int) -> list[int]:
    """Chunk end-offsets (exclusive), the last ``length``."""
    cs = cands.tolist()
    out, start, i, n = [], 0, 0, len(cs)
    while length - start > max_size:
        lo, hi = start + min_size, start + max_size
        while i < n and cs[i] < lo:
            i += 1
        if i < n and cs[i] <= hi:
            cut = cs[i]
            i += 1
        else:
            cut = hi
        out.append(cut)
        start = cut
    out.append(length)
    return out


def cuts(buf: np.ndarray, chunking: dict, device, thinned: bool = True):
    """The configuration's cuts of ``buf``; ``thinned=False`` skips the
    window thinning (the control's broken guarantee)."""
    c = candidates(buf, int(chunking["avg_bits"]), device,
                   int(chunking["gear_c1"]), int(chunking["gear_c2"]))
    if thinned:
        c = thin(c, int(chunking["thin_bits"]))
    return greedy(c, len(buf), int(chunking["min_size"]),
                  int(chunking["max_size"]))


def summary(buf: np.ndarray, chunking: dict, device, thinned: bool = True):
    """``(cuts, digests, root)``: chunk end-offsets, the (nchunks, 32)
    uint8 BLAKE2b-256 of each chunk and the Merkle root over them."""
    if len(buf) == 0:
        return [], np.empty((0, 32), np.uint8), root([])
    ends = cuts(buf, chunking, device, thinned)
    starts = [0] + ends[:-1]
    digests = blake2b_extents(buf, starts, ends)
    return (ends, np.frombuffer(b"".join(digests), np.uint8).reshape(-1, 32),
            root(digests))
