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

The diff builds A||B as one concatenated tree (every level on B2) and
narrows a leaf mask top-down; :func:`update_leaves` recomputes only the
K root paths, each level's parents on B2; :func:`prove` gathers the
sibling path on the device.  The mask combines and gathers are torch
ops, as the reference leaves them to XLA.

``host_parent``/``host_tree``/``root_host``/``host_diff`` and
:func:`verify_proof` are hashlib references.

:func:`build_tree`, :func:`diff_root_guided`,
:func:`diff_root_guided_packed` and :func:`update_leaves` are
kernel-sentinel sites under the reference's ``jit_site`` names.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..obs.device import kernel_site
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


build_tree = kernel_site("ops.merkle.build_tree", build_tree)


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


def _node_neq(ahh, ahl, bhh, bhl):
    """(N,) bool: per-node digest inequality."""
    return ((ahh != bhh) | (ahl != bhl)).any(dim=1)


def _check_snapshots(n: int, m: int) -> None:
    if n == 0 or n & (n - 1):
        raise ValueError(f"leaf count {n} is not a power of two; pad first")
    if m != n:
        raise ValueError(f"snapshot widths differ: {n} vs {m}; pad first")


def diff_root_guided(a_leaf_hh, a_leaf_hl, b_leaf_hh, b_leaf_hl):
    """Build both trees and diff them: ``(mask, a_root, b_root)``, the
    mask (N,) bool over leaves, each root a (1, 4) hi/lo pair.

    Both trees are built as one tree over A||B: with a power-of-two width
    the sibling pairing never crosses the midpoint, so each level's two
    halves are the two trees' levels, and every level is one B2 call.
    The loop stops at two rows (the two roots); the mask is then narrowed
    top-down, each level's inequality AND-ed with its parent's mask
    repeated over the children.
    """
    from .merkle_cuda import merkle_level_kernel

    _check_snapshots(a_leaf_hh.shape[0], b_leaf_hh.shape[0])
    hh = torch.cat([a_leaf_hh, b_leaf_hh])
    hl = torch.cat([a_leaf_hl, b_leaf_hl])
    levels = []
    while hh.shape[0] > 2:
        levels.append((hh, hl))
        hh, hl = merkle_level_kernel(hh, hl)
    # hh/hl is now (2, 4): row 0 = A's root, row 1 = B's root
    mask = _node_neq(hh[:1], hl[:1], hh[1:], hl[1:])
    for lhh, lhl in reversed(levels):
        half = lhh.shape[0] // 2
        mask = mask.repeat_interleave(2) & _node_neq(
            lhh[:half], lhl[:half], lhh[half:], lhl[half:])
    return mask, (hh[:1], hl[:1]), (hh[1:], hl[1:])


diff_root_guided = kernel_site("ops.merkle.diff_root_guided",
                               diff_root_guided)


def pack_mask(mask):
    """(N,) bool -> (ceil(N/32),) int32 words holding the mask's bits, LSB
    first, zero-padded.  The sum runs in int64 (bit 31 overflows int32)
    and keeps the low 32 bits."""
    n = mask.shape[0]
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, -n % 32))
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    return (m.view(-1, 32) << shifts).sum(dim=1).to(torch.int32)


def diff_root_guided_packed(a_leaf_hh, a_leaf_hl, b_leaf_hh, b_leaf_hl):
    """:func:`diff_root_guided` with the leaf mask packed 32 to a word
    (:func:`pack_mask`), so one bit per leaf crosses D2H; read it back
    with :func:`unpack_mask`."""
    mask, root_a, root_b = diff_root_guided(a_leaf_hh, a_leaf_hl,
                                            b_leaf_hh, b_leaf_hl)
    return pack_mask(mask), root_a, root_b


diff_root_guided_packed = kernel_site("ops.merkle.diff_root_guided_packed",
                                      diff_root_guided_packed)


def update_leaves(levels_hh, levels_hl, idx, new_hh, new_hl):
    """Apply K leaf updates to a built tree, recomputing only the K root
    paths: new level tuples, the caller's levels left unchanged.

    ``idx``: (K,) leaf positions; ``new_hh``/``new_hl``: (K, 4) digests
    on the levels' device.  Per level, the K parents' left and right
    children are gathered and interleaved into one contiguous (2K, 4)
    pair of halves for B2; duplicate parents are recomputed to the same
    value.  Among duplicate leaf positions the winner is unspecified, as
    in the reference.
    """
    from .merkle_cuda import merkle_level_kernel

    leaf_hh = levels_hh[0]
    n = leaf_hh.shape[0]
    idx = torch.as_tensor(idx, dtype=torch.int64).reshape(-1)
    if idx.numel() and not (0 <= int(idx.min()) and int(idx.max()) < n):
        raise IndexError(f"leaf positions must lie in [0, {n})")
    idx = idx.to(leaf_hh.device)
    out_hh = [leaf_hh.clone()]
    out_hl = [levels_hl[0].clone()]
    out_hh[0][idx] = new_hh
    out_hl[0][idx] = new_hl
    for lvl in range(1, len(levels_hh)):
        pidx = idx >> 1
        pair = torch.stack([2 * pidx, 2 * pidx + 1], dim=1).reshape(-1)
        p_hh, p_hl = merkle_level_kernel(out_hh[-1].index_select(0, pair),
                                         out_hl[-1].index_select(0, pair))
        out_hh.append(levels_hh[lvl].clone())
        out_hl.append(levels_hl[lvl].clone())
        out_hh[-1][pidx] = p_hh
        out_hl[-1][pidx] = p_hl
        idx = pidx
    return tuple(out_hh), tuple(out_hl)


# keyed on the tree's depth: the update count only sizes the gathers
update_leaves = kernel_site(
    "ops.merkle.update_leaves", update_leaves,
    key=lambda levels_hh, *args: (len(levels_hh),))


def unpack_mask(bits, n: int) -> np.ndarray:
    """Packed u32 words (LSB first; any 32-bit dtype, numpy or a tensor on
    any device) -> (n,) 0/1 uint8."""
    if isinstance(bits, torch.Tensor):
        bits = bits.cpu().numpy()
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


def diff_leaves(a_digests: list[bytes], b_digests: list[bytes],
                device="cuda") -> list[int]:
    """Differing leaf indices of two equal-length digest lists, by the
    tree diff on ``device`` (both zero-padded to a power of two)."""
    if len(a_digests) != len(b_digests):
        raise ValueError("snapshots must have equal leaf counts; pad first")
    if not a_digests:
        return []
    a_hh, a_hl = pad_leaves(*digests_to_device(a_digests, device))
    b_hh, b_hl = pad_leaves(*digests_to_device(b_digests, device))
    mask, _, _ = diff_root_guided(a_hh, a_hl, b_hh, b_hl)
    return torch.nonzero(mask[:len(a_digests)]).flatten().tolist()


def diff_snapshots(a_hh, a_hl, b_hh, b_hl) -> np.ndarray:
    """Differing leaf indices (ascending int64) between two equal,
    power-of-two width snapshots, by the packed tree diff on the device
    the tensors live on: one bit per leaf crosses to the host."""
    n = a_hh.shape[0]
    if b_hh.shape[0] != n:
        raise ValueError("snapshots must have equal (padded) leaf counts")
    bits, _, _ = diff_root_guided_packed(a_hh, a_hl, b_hh, b_hl)
    return np.nonzero(unpack_mask(bits, n))[0]


def prove(levels_hh, levels_hl, idx: int) -> list[bytes]:
    """Inclusion proof for leaf ``idx`` of a :func:`build_tree` tree: the
    sibling digest per level, bottom-up.  The siblings are gathered on the
    device and cross to the host in one copy."""
    n = levels_hh[0].shape[0]
    if not 0 <= idx < n:
        raise IndexError(f"leaf {idx} out of range [0, {n})")
    nlev = len(levels_hh) - 1
    if nlev == 0:
        return []
    sib_hh = torch.cat([levels_hh[lvl][((idx >> lvl) ^ 1)][None]
                        for lvl in range(nlev)])
    sib_hl = torch.cat([levels_hl[lvl][((idx >> lvl) ^ 1)][None]
                        for lvl in range(nlev)])
    return digests_from_device(sib_hh, sib_hl)


def verify_proof(root: bytes, leaf: bytes, idx: int,
                 path: list[bytes], nleaves: int) -> bool:
    """Check an inclusion proof against a 32-byte root (hashlib).

    ``nleaves`` pins the path length to the padded tree height, so an
    interior digest cannot pass as a leaf and an index cannot alias
    modulo the width."""
    if nleaves <= 0 or not 0 <= idx < nleaves:
        return False
    depth = max(0, int(nleaves) - 1).bit_length()
    if len(path) != depth:
        return False
    node = leaf
    for lvl, sib in enumerate(path):
        bit = (idx >> lvl) & 1
        node = host_parent(sib, node) if bit else host_parent(node, sib)
    return node == root


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


def host_diff(a: list[bytes], b: list[bytes]) -> list[int]:
    """Recursive descend-on-difference reference diff (ascending)."""
    out: list[int] = []

    def walk(ta, tb, lvl, idx):
        if ta[lvl][idx] == tb[lvl][idx]:
            return
        if lvl == 0:
            out.append(idx)
            return
        walk(ta, tb, lvl - 1, 2 * idx)
        walk(ta, tb, lvl - 1, 2 * idx + 1)

    ta, tb = host_tree(a), host_tree(b)
    walk(ta, tb, len(ta) - 1, 0)
    return out
