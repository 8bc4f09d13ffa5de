"""The work of BLAKE2b-256 over a batch of items (RFC 7693).

An item of ``n`` bytes takes ``max(1, ceil(n / 128))`` compressions.
One compression is 12 rounds of 8 calls of G, each on four 64-bit words
and two message words::

    a = a + b + x;  d = (d ^ a) >>> 32;  c = c + d;  b = (b ^ c) >>> 24
    a = a + b + y;  d = (d ^ a) >>> 16;  c = c + d;  b = (b ^ c) >>> 63

counted in the fewest 32-bit integer operations a 64-bit word needs: a
two- or three-input add is two (the low half, the high half with the
carry), an xor two, a rotation by 32 none (the halves trade names), any
other rotation two funnel shifts.  G is 8 + 8 + 6 = 22; the compression
adds the counter and final-block xors into ``v`` (three words, 6) and
the feed-forward ``h ^= v_i ^ v_{i+8}`` (8 three-input xors, 16).
Bytes: each input byte read once and 32 bytes written an item.
"""

from __future__ import annotations

import numpy as np

G_OPS = 8 + 8 + 6
OPS_PER_COMPRESSION = 12 * 8 * G_OPS + 6 + 16
DIGEST_BYTES = 32


def compressions(lengths) -> int:
    lens = np.asarray(lengths, dtype=np.int64)
    return int(np.maximum(1, -(-lens // 128)).sum())


def work(lengths) -> dict:
    """``{"bytes", "ops", "items"}`` of hashing items of these lengths."""
    lens = np.asarray(lengths, dtype=np.int64)
    return {"bytes": int(lens.sum()) + DIGEST_BYTES * len(lens),
            "ops": compressions(lens) * OPS_PER_COMPRESSION,
            "items": len(lens)}
