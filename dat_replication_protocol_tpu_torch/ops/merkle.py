"""Merkle tree build over BLAKE2b-256 digests.

The counterpart of ``dat_replication_protocol_tpu/ops/merkle.py``
(:44-132 and the host helpers).  A node digest is BLAKE2b-256 of the
64-byte concatenation of its two children's digests — one compression
per parent — so one tree level is one batched call over N/2 parents.
Digests travel as (N, 4) hi/lo uint32 word halves in int32 tensors, the
first four word pairs of :func:`.blake2b.digests_to_bytes`' layout.

:func:`merkle_level` is the plain version of kernel B2.
:func:`build_tree` routes every level through B2's wrapper
(:mod:`.merkle_cuda`): on CUDA every level goes to the kernel (the
reference's ``_PALLAS_MIN_PARENTS`` floor is not carried over: there is
no second device path); on the CPU the wrapper takes the plain version.

``host_parent``/``host_tree``/``root_host`` are hashlib references.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils.device import resolve_device
from .blake2b import _compress_words, initial_state, join_words, split_words

DIGEST_SIZE = 32
_DIGEST_WORDS = 4  # 32 bytes = 4 64-bit words


def merkle_parent(ahh, ahl, bhh, bhl):
    """Hash pairs of sibling digests into parents: all (N, 4) int32.

    Parent = BLAKE2b-256(left || right): a 64-byte message, one final
    compression with t = 64 per parent, vectorized over all N pairs.
    """
    n = ahh.shape[0]
    m = torch.zeros((16, n), dtype=torch.int64, device=ahh.device)
    m[0:4] = join_words(ahh, ahl).T
    m[4:8] = join_words(bhh, bhl).T
    hh, hl = initial_state(n, DIGEST_SIZE, ahh.device)
    h = join_words(hh, hl).T
    t = torch.full((n,), 2 * DIGEST_SIZE, dtype=torch.int64,
                   device=ahh.device)
    final = torch.ones((n,), dtype=torch.bool, device=ahh.device)
    ph, pl = split_words(_compress_words(h, m, t, final)[:_DIGEST_WORDS].T)
    return ph.contiguous(), pl.contiguous()


def merkle_level(hh, hl):
    """One tree level: (N, 4) digests -> (N//2, 4) parents — the plain
    version of kernel B2.  Left/right children are even/odd rows."""
    return merkle_parent(hh[0::2], hl[0::2], hh[1::2], hl[1::2])


def build_tree(leaf_hh, leaf_hl):
    """All levels, leaves -> root; the leaf count must be a power of two.

    Returns ``(levels_hh, levels_hl)``: tuples of per-level (n, 4) int32
    tensors, leaves first, root (shape (1, 4)) last.
    """
    from .merkle_cuda import merkle_level_kernel

    n = leaf_hh.shape[0]
    if n == 0 or n & (n - 1):
        raise ValueError(f"leaf count {n} is not a power of two; pad first")
    levels_hh, levels_hl = [leaf_hh], [leaf_hl]
    while leaf_hh.shape[0] > 1:
        leaf_hh, leaf_hl = merkle_level_kernel(leaf_hh, leaf_hl)
        levels_hh.append(leaf_hh)
        levels_hl.append(leaf_hl)
    return tuple(levels_hh), tuple(levels_hl)


def root(leaf_hh, leaf_hl):
    """Root digest only: (1, 4) hi/lo word halves."""
    hhs, hls = build_tree(leaf_hh, leaf_hl)
    return hhs[-1], hls[-1]


def pad_leaves(hh, hl):
    """Zero-pad the leaf axis up to the next power of two: zero digests
    are the empty-subtree sentinel, as in :func:`root_host`."""
    n = hh.shape[0]
    p = 1 << max(0, n - 1).bit_length()
    if p == n:
        return hh, hl
    pad = (0, 0, 0, p - n)
    return (torch.nn.functional.pad(hh, pad),
            torch.nn.functional.pad(hl, pad))


def unpack_mask(bits, n: int) -> np.ndarray:
    """Packed u32 words (LSB first; any 32-bit dtype) -> (n,) 0/1 uint8."""
    words = np.ascontiguousarray(bits).view(np.uint32)
    return np.unpackbits(words.view(np.uint8), bitorder="little")[:n]


def digests_to_device(digests: list[bytes], device="cuda"):
    """32-byte digests -> (N, 4) hi/lo int32 tensors on ``device``
    (little-endian 64-bit words; u32 word 2k is word k's low half)."""
    dev = resolve_device(device)
    raw = np.frombuffer(b"".join(digests), dtype="<u4").reshape(-1, 8)
    hh = torch.from_numpy(raw[:, 1::2].astype(np.uint32).view(np.int32))
    hl = torch.from_numpy(raw[:, 0::2].astype(np.uint32).view(np.int32))
    return hh.to(dev), hl.to(dev)


def digest_matrix(hh, hl) -> np.ndarray:
    """(N, 4) hi/lo word halves -> (N, 32) uint8 digest bytes."""
    hh = np.asarray(hh.cpu() if isinstance(hh, torch.Tensor) else hh)
    hl = np.asarray(hl.cpu() if isinstance(hl, torch.Tensor) else hl)
    out = np.empty((hh.shape[0], 8), dtype="<u4")
    out[:, 0::2] = hl.view(np.uint32)
    out[:, 1::2] = hh.view(np.uint32)
    return out.view(np.uint8).reshape(hh.shape[0], 32)


def digests_from_device(hh, hl) -> list[bytes]:
    """(N, 4) hi/lo word halves -> list of 32-byte digests."""
    raw = digest_matrix(hh, hl)
    return [raw[i].tobytes() for i in range(raw.shape[0])]


# ---------------------------------------------------------------------------
# host references (hashlib)
# ---------------------------------------------------------------------------


def host_parent(left: bytes, right: bytes) -> bytes:
    return hashlib.blake2b(left + right, digest_size=DIGEST_SIZE).digest()


def host_tree(leaves: list[bytes]) -> list[list[bytes]]:
    """Every level of the tree over ``leaves`` (a power of two), leaves
    first."""
    levels = [list(leaves)]
    while len(levels[-1]) > 1:
        prev = levels[-1]
        levels.append([host_parent(prev[i], prev[i + 1])
                       for i in range(0, len(prev), 2)])
    return levels


def root_host(digests) -> bytes:
    """Merkle root of (N, 32) uint8 leaf digests (or a list of 32-byte
    digests), zero-digest padded to a power of two, as the reference's
    ``root_host`` pads."""
    leaves = [bytes(d) for d in digests]
    if not leaves:
        return b"\0" * DIGEST_SIZE
    p = 1 << (len(leaves) - 1).bit_length()
    leaves += [b"\0" * DIGEST_SIZE] * (p - len(leaves))
    return host_tree(leaves)[-1][0]
