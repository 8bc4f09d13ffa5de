"""The files of an import, from the traffic's sizes and ``--seed``.

Every seed gets the same set of sizes: ``count`` quantiles of a
log-uniform distribution over [``min_bytes``, ``max_bytes``], at
``(i + 0.5) / count``.  The seed changes only the order in which they
are imported and their bytes, so runs on different seeds do the same
work.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

from . import seeded

_STREAM_ORDER = 11
_STREAM_FILES = 12  # file i's bytes are stream _STREAM_FILES + i


def sizes(traffic: dict) -> list[int]:
    """The file sizes in bytes, smallest first."""
    n = int(traffic["count"])
    lo, hi = int(traffic["min_bytes"]), int(traffic["max_bytes"])
    return [int(lo * math.exp(math.log(hi / lo) * (i + 0.5) / n))
            for i in range(n)]


def make_files(traffic: dict, seed: int) -> list[np.ndarray]:
    """The files in the order the seed imports them."""
    order = seeded.rng(seed, _STREAM_ORDER).permutation(int(traffic["count"]))
    sz = sizes(traffic)
    return [seeded.random_bytes(sz[i], seed, _STREAM_FILES + int(i))
            for i in order]
