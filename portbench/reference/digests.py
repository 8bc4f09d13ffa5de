"""BLAKE2b-256 of byte extents, by ``hashlib`` (RFC 7693)."""

from __future__ import annotations

import hashlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DIGEST_SIZE = 32
WORKERS = 8
_SPLIT = 1 << 22  # bytes of extents a task hashes, about


def _hash_range(mv: memoryview, starts, ends) -> list[bytes]:
    b2 = hashlib.blake2b
    return [b2(mv[s:e], digest_size=DIGEST_SIZE).digest()
            for s, e in zip(starts, ends)]


def blake2b_extents(buf: np.ndarray, starts, ends) -> list[bytes]:
    """The digest of every ``buf[starts[i]:ends[i]]``, in order.  Runs of
    about 4 MiB go to a pool of threads; ``hashlib`` hashes without the
    GIL above 2 KiB."""
    mv = memoryview(np.ascontiguousarray(buf))
    starts = np.asarray(starts, dtype=np.int64).tolist()
    ends = np.asarray(ends, dtype=np.int64).tolist()
    tasks, first, acc = [], 0, 0
    for i, (s, e) in enumerate(zip(starts, ends)):
        acc += e - s
        if acc >= _SPLIT:
            tasks.append((starts[first:i + 1], ends[first:i + 1]))
            first, acc = i + 1, 0
    if first < len(starts):
        tasks.append((starts[first:], ends[first:]))
    with ThreadPoolExecutor(WORKERS) as pool:
        parts = list(pool.map(lambda t: _hash_range(mv, *t), tasks))
    return [d for part in parts for d in part]
