"""The plain writer of a change log: BASELINE.json configs[1]'s rows as
per-record ``Change`` frames, and no blobs.

Row ``i`` is the record shape the JAX-era ``bench.py:bench_replay``
replays: key ``key-%07d`` of ``i``, change ``i``, from ``i``, to ``i +
1``, a value of ``i mod 48`` bytes (present, so an empty one is written
as an empty field) and, where ``i mod 3 != 0``, subset ``"s"``.  The
value's bytes are drawn from the seed (``bench_replay`` writes ``b"v"``),
so that the answers differ by seed.

Frames are ``varint(len(payload) + 1) | 0x01 | payload`` with the
payload's fields in field order, ``subset`` (tag ``0x0a``) first where
present (``gen/wire.py`` has the schema).  The log is built column by
column in NumPy: each row's bytes in one row of a padded matrix, the
rows joined by a mask.  This module is the benchmark's own writer: it
imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import seeded
from .wire import KIND_CHANGE, TYPE_CHANGE, Wire

MAX_VALUE = 48  # a value is ``i mod 48`` bytes
SUBSET = "s"
_KEY_DIGITS = 7
_VALUE_STREAM = 4  # the seed's stream of the values' bytes

# tags of the Change fields (field << 3 | wire type)
_TAG_SUBSET, _TAG_KEY, _TAG_CHANGE = 0x0A, 0x12, 0x18
_TAG_FROM, _TAG_TO, _TAG_VALUE = 0x20, 0x28, 0x32


def _uvarints(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unsigned LEB128 of each value: a (n, 10) byte matrix and the
    byte count of each."""
    v = np.asarray(values, dtype=np.uint64)
    out = np.zeros((len(v), 10), dtype=np.uint8)
    lens = np.ones(len(v), dtype=np.int64)
    for k in range(10):
        rest = v >> np.uint64(7 * (k + 1))
        more = rest != 0
        out[:, k] = ((v >> np.uint64(7 * k)) & np.uint64(0x7F)).astype(
            np.uint8) | (more.astype(np.uint8) << 7)
        lens += more
        if not more.any():
            return out[:, :k + 1], lens
    return out, lens


def _fixed(n: int, data: bytes, present=None):
    """The same bytes in every row (where ``present``)."""
    m = np.broadcast_to(np.frombuffer(data, dtype=np.uint8), (n, len(data)))
    lens = np.full(n, len(data), dtype=np.int64)
    return m, lens if present is None else np.where(present, lens, 0)


def _tagged(tag: int, values: np.ndarray):
    body, lens = _uvarints(values)
    m = np.concatenate([np.full((len(values), 1), tag, np.uint8), body], 1)
    return m, lens + 1


def _keys(i: np.ndarray):
    """``0x12 0x0b`` and ``key-%07d`` of each row."""
    digits = np.stack([(i // 10 ** (_KEY_DIGITS - 1 - d)) % 10
                       for d in range(_KEY_DIGITS)], 1) + ord("0")
    head = np.frombuffer(bytes((_TAG_KEY, 4 + _KEY_DIGITS)) + b"key-",
                         dtype=np.uint8)
    m = np.concatenate([np.broadcast_to(head, (len(i), len(head))),
                        digits.astype(np.uint8)], 1)
    return m, np.full(len(i), m.shape[1], dtype=np.int64)


def _join(segments) -> tuple[np.ndarray, np.ndarray]:
    """Each row's segments end to end, the rows end to end: the flat
    bytes and each row's length."""
    n = len(segments[0][1])
    lens = sum(seg_lens for _, seg_lens in segments)
    width = int(sum(m.shape[1] for m, _ in segments))
    rows = np.zeros(n * width, dtype=np.uint8)
    at = np.arange(n, dtype=np.int64) * width  # flat index of each row
    for m, seg_lens in segments:
        for k in range(m.shape[1]):
            has = seg_lens > k
            if has.all():
                rows[at + k] = m[:, k]
            else:
                rows[at[has] + k] = m[has, k]
        at += seg_lens
    mask = np.arange(width) < lens[:, None]
    return rows.reshape(n, width)[mask], lens


@dataclasses.dataclass
class ChangeLog(Wire):
    """The log's wire and its table (``Wire``'s, every item a change).
    Change ``i``'s value is ``values[value_offs[i]:value_offs[i + 1]]``.
    """

    def change_record(self, i: int) -> tuple:
        """Change ``i`` as the writer wrote it, in field order: (subset,
        key, change, from, to, value); an absent subset is ``""``, the
        protobuf default."""
        v = self.values[self.value_offs[i]:self.value_offs[i + 1]]
        return (SUBSET if i % 3 else "", f"key-{i:0{_KEY_DIGITS}d}", i, i,
                i + 1, v)


def make_log(spec: dict, seed: int) -> ChangeLog:
    """``spec["rows"]`` rows in configs[1]'s shape."""
    n = int(spec["rows"])
    if not 0 < n <= 10 ** _KEY_DIGITS:
        raise ValueError(f"rows must be in 1..{10 ** _KEY_DIGITS}")
    i = np.arange(n, dtype=np.int64)
    vlens = i % MAX_VALUE
    voffs = np.concatenate([[0], np.cumsum(vlens)])
    values = seeded.random_bytes(int(voffs[-1]), seed, _VALUE_STREAM)
    # each row's value in a padded row of the matrix
    vmat = np.zeros((n, MAX_VALUE - 1), dtype=np.uint8)
    vmat[np.arange(MAX_VALUE - 1) < vlens[:, None]] = values
    fields = [
        _fixed(n, bytes((_TAG_SUBSET, len(SUBSET))) + SUBSET.encode(),
               present=i % 3 != 0),
        _keys(i),
        _tagged(_TAG_CHANGE, i),
        _tagged(_TAG_FROM, i),
        _tagged(_TAG_TO, i + 1),
        _tagged(_TAG_VALUE, vlens),
        (vmat, vlens),
    ]
    plens = sum(lens for _, lens in fields)
    header = _uvarints(plens + 1)
    buf, rlens = _join([header, _fixed(n, bytes((TYPE_CHANGE,))), *fields])
    ends = np.cumsum(rlens)
    return ChangeLog(buf=buf, kinds=np.full(n, KIND_CHANGE, dtype=np.int8),
                     starts=ends - plens, ends=ends, seqs=i,
                     values=values.tobytes(), value_offs=voffs)
