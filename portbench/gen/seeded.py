"""Random bytes from a seed, made in pieces on threads.

A stream is PCG64 seeded by ``SeedSequence([seed, stream])``; its byte
``k`` is byte ``k % 8`` (little endian) of the stream's draw ``k // 8``.
A piece at a byte offset that is a multiple of 8 starts from the
generator advanced by ``offset // 8`` draws, so the bytes do not depend
on how the work is split or on the number of threads.  numpy fills each
piece without the GIL.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

PIECE = 64 << 20  # bytes a worker fills at a time
WORKERS = 8


def seed_words(seed: int, stream: int) -> list[int]:
    """The ``SeedSequence`` entropy of one stream of ``--seed``: any
    whole number, negative ones and ones past 64 bits included."""
    return [seed % (1 << 64), (seed >> 64) % (1 << 64), stream]


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for the small draws of one stream."""
    return np.random.default_rng(np.random.SeedSequence(
        seed_words(seed, stream)))


def _fill(dst: np.ndarray, seed: int, stream: int, at: int) -> None:
    bits = np.random.PCG64(np.random.SeedSequence(seed_words(seed, stream)))
    bits.advance(at // 8)
    n = len(dst)
    dst[:] = bits.random_raw(-(-n // 8)).view(np.uint8)[:n]


def fill_stream(jobs, seed: int, stream: int) -> None:
    """Fill each ``(dst, offset)`` of ``jobs`` with the stream's bytes
    from ``offset`` on: ``dst`` a flat uint8 view, ``offset`` a multiple
    of 8.  Large views are split into pieces of :data:`PIECE`."""
    pieces = []
    for dst, offset in jobs:
        if offset % 8:
            raise ValueError("stream offsets must be multiples of 8")
        for at in range(0, len(dst), PIECE):
            pieces.append((dst[at:at + PIECE], offset + at))
    with ThreadPoolExecutor(WORKERS) as pool:
        for f in [pool.submit(_fill, d, seed, stream, o) for d, o in pieces]:
            f.result()


def random_bytes(n: int, seed: int, stream: int) -> np.ndarray:
    """``n`` bytes of one stream as a uint8 array."""
    out = np.empty(n, dtype=np.uint8)
    fill_stream([(out, 0)], seed, stream)
    return out
