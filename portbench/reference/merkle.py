"""The Merkle root of a list of leaf digests: leaves zero-padded to a
power of two with 32 zero bytes, each parent the BLAKE2b-256 of its left
child's digest followed by its right child's; no leaves give 32 zero
bytes, one leaf is its own root."""

from __future__ import annotations

import hashlib

ZERO = b"\0" * 32


def root(leaves: list[bytes]) -> bytes:
    if not leaves:
        return ZERO
    level = list(leaves)
    level += [ZERO] * ((1 << (len(level) - 1).bit_length()) - len(level))
    b2 = hashlib.blake2b
    while len(level) > 1:
        level = [b2(level[i] + level[i + 1], digest_size=32).digest()
                 for i in range(0, len(level), 2)]
    return level[0]
