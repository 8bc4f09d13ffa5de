"""What a receiving peer owes for one change log's wire: every ``Change``
record in wire order, and the BLAKE2b-256 of every change payload.

The wire is walked here, with nothing of the program: frame by frame (a
varint length, the type byte, the payload), then every payload's
protobuf fields in lockstep across the records with NumPy, one field of
every record a step (``gen/wire.py`` has the schema: proto2, ``subset``
1 and ``value`` 6 optional, ``key`` 2, ``change`` 3, ``from`` 4 and
``to`` 5 required; a field given twice keeps its last value).  An
absent ``subset`` reads ``""`` and an absent ``value`` ``b""``, the
protobuf defaults, as the reference implementation's own test expects
(``test/basic.js:10-17``).  Anything else on the wire (a blob, another
frame type, an unknown field, a missing required field, a cut frame)
raises: the change log has none.
"""

from __future__ import annotations

import numpy as np

from .digests import blake2b_extents

TYPE_CHANGE = 1
_VARINT, _LEN = 0, 2  # protobuf wire types
# by field number: the record's slot (subset, key, change, from, to,
# value) and the field's wire type; -1 where no field has the number
_SLOT = np.array([-1, 0, 1, 2, 3, 4, 5, -1])
_WIRE_TYPE = np.array([-1, _LEN, _LEN, _VARINT, _VARINT, _VARINT, _LEN, -1])
_MAX_VARINT = 10  # bytes


def _varints(buf: np.ndarray, at: np.ndarray) -> tuple[np.ndarray,
                                                       np.ndarray]:
    """The unsigned varint at each offset ``at``: its value and the
    offset past it."""
    value = np.zeros(len(at), dtype=np.uint64)
    pos = at.copy()
    idx = np.arange(len(at))
    for k in range(_MAX_VARINT):
        b = buf[pos[idx]].astype(np.uint64)
        value[idx] |= (b & np.uint64(0x7F)) << np.uint64(7 * k)
        pos[idx] += 1
        idx = idx[b >= 0x80]
        if not len(idx):
            return value, pos
    raise ValueError("varint longer than 10 bytes")


def _frames(buf: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The (starts, ends) of every frame's payload; every frame a
    change record."""
    starts, ends = [], []
    at, n = 0, len(buf)
    while at < n:
        length = shift = 0
        while True:
            b = buf[at]
            at += 1
            length |= (b & 0x7F) << shift
            if b < 0x80:
                break
            shift += 7
        if length < 1 or at + length > n:
            raise ValueError(f"cut or empty frame at {at}")
        if buf[at] != TYPE_CHANGE:
            raise ValueError(f"frame type {buf[at]} at {at}: the log holds "
                             f"change records only")
        starts.append(at + 1)
        at += length
        ends.append(at)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def decode_log(data) -> tuple[list[tuple], np.ndarray, np.ndarray]:
    """Every record of the log in wire order, each (subset, key, change,
    from, to, value), and every payload's (starts, ends) in ``data``."""
    raw = bytes(data)
    buf = np.frombuffer(raw, dtype=np.uint8)
    starts, ends = _frames(raw)
    n = len(starts)
    # per slot: a length-delimited field's offset (-1 where absent) and
    # each field's varint (its length, for a length-delimited one)
    offs = np.full((6, n), -1, dtype=np.int64)
    vals = np.full((6, n), -1, dtype=np.int64)
    cur = starts.copy()
    idx = np.arange(n)[cur < ends]
    while len(idx):
        tag, pos = _varints(buf, cur[idx])
        field = np.minimum(tag >> np.uint64(3), np.uint64(7)).astype(np.int64)
        wire_type = (tag & np.uint64(7)).astype(np.int64)
        slot = _SLOT[field]
        if ((slot < 0) | (wire_type != _WIRE_TYPE[field])).any():
            raise ValueError("a field that Change does not have")
        value, pos = _varints(buf, pos)
        if (value >= np.uint64(1 << 32)).any():
            raise ValueError("a varint past 32 bits")
        value = value.astype(np.int64)
        delimited = wire_type == _LEN
        offs[slot, idx] = np.where(delimited, pos, -1)
        vals[slot, idx] = value
        pos = pos + np.where(delimited, value, 0)
        if (pos > ends[idx]).any():
            raise ValueError("a field past its record's end")
        cur[idx] = pos
        idx = idx[pos < ends[idx]]
    if (vals[1:5] < 0).any():
        raise ValueError("a record without a required field")

    def column(slot, default, convert):
        return [convert(raw[o:o + k]) if o >= 0 else default
                for o, k in zip(offs[slot].tolist(), vals[slot].tolist())]

    records = list(zip(column(0, "", bytes.decode),
                       column(1, "", bytes.decode),
                       vals[2].tolist(), vals[3].tolist(), vals[4].tolist(),
                       column(5, b"", bytes)))
    return records, starts, ends


def expected(data) -> dict:
    """``records`` (as :func:`decode_log` gives them) and ``digests``:
    per kind in seq order, every change payload's digest and no blob."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    records, starts, ends = decode_log(buf)
    return {"records": records,
            "digests": {"change": blake2b_extents(buf, starts, ends),
                        "blob": []}}
