"""The plain writer of the dat replication wire, and the session maker.

The wire is the reference's (mafintosh/dat-replication-protocol,
README.md:63-71, ``messages/schema.proto``): frames of
``varint(len(payload) + 1) | type | payload``, type 1 a protobuf
``Change`` record, type 2 a blob's raw bytes.  ``Change`` is proto2::

    optional string subset = 1;  required string key = 2;
    required uint32 change = 3;  required uint32 from = 4;
    required uint32 to = 5;      optional bytes value = 6;

emitted in field order with absent optionals left out.  This module is
the benchmark's own writer: it imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import seeded

TYPE_CHANGE = 1
TYPE_BLOB = 2
KIND_CHANGE = 0
KIND_BLOB = 1

# the seed's streams: change values, blob bytes; the value lengths come
# from one stream of a fixed seed, so every seed gets the same frame
# layout and the same writes
_STREAM_VALUES = 1
_STREAM_BLOBS = 2
_STREAM_LENGTHS = 3
_LAYOUT_SEED = 0


def uvarint(value: int) -> bytes:
    """Unsigned LEB128."""
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def change_payload(key: str, change: int, from_: int, to: int,
                   value: bytes) -> bytes:
    """A ``Change`` record without ``subset``, as protobuf bytes."""
    k = key.encode("utf-8")
    return b"".join((b"\x12", uvarint(len(k)), k, b"\x18", uvarint(change),
                     b"\x20", uvarint(from_), b"\x28", uvarint(to),
                     b"\x32", uvarint(len(value)), value))


def frame_header(payload_len: int, type_id: int) -> bytes:
    return uvarint(payload_len + 1) + bytes((type_id,))


@dataclasses.dataclass
class Wire:
    """One session's wire and its items in wire order.

    ``kinds[i]`` is :data:`KIND_CHANGE` or :data:`KIND_BLOB`;
    ``buf[starts[i]:ends[i]]`` is item ``i``'s payload, whose last byte is
    also its frame's last byte.  ``seqs[i]`` is the item's 0-based index
    among the items of its kind.  ``values[value_offs[i]:value_offs[i +
    1]]`` is change ``i``'s value."""

    buf: np.ndarray
    kinds: np.ndarray
    starts: np.ndarray
    ends: np.ndarray
    seqs: np.ndarray
    values: bytes = b""  # the change values, end to end
    value_offs: list = dataclasses.field(default_factory=lambda: [0])

    @property
    def nbytes(self) -> int:
        return len(self.buf)

    def of_kind(self, kind: int) -> tuple[np.ndarray, np.ndarray]:
        """(starts, ends) of one kind's items, in seq order."""
        sel = self.kinds == kind
        return self.starts[sel], self.ends[sel]

    @property
    def n_changes(self) -> int:
        return len(self.value_offs) - 1

    def change_record(self, i: int) -> tuple:
        """Change ``i`` as the writer wrote it: (key, change, from, to,
        value)."""
        v = self.values[self.value_offs[i]:self.value_offs[i + 1]]
        return (f"row-{i}", i + 1, 0, 1, v)


def make_session(spec: dict, seed: int) -> Wire:
    """A session of ``spec["blobs"]`` blobs of ``spec["blob_bytes"]``,
    each preceded by ``spec.get("changes_per_blob", 0)`` change records:
    key ``row-<i>``, change ``i + 1``, from 0, to 1, and a value of a
    length uniform in ``spec["value_bytes"]`` (both ends included).  The
    value lengths are the same for every seed, so every session has the
    same frame layout; the value and blob bytes come from ``seed``."""
    n_blobs = int(spec["blobs"])
    blob_bytes = int(spec["blob_bytes"])
    per_blob = int(spec.get("changes_per_blob", 0))
    n_changes = n_blobs * per_blob
    value_lens = np.zeros(0, dtype=np.int64)
    if n_changes:
        lo, hi = spec["value_bytes"]
        value_lens = seeded.rng(_LAYOUT_SEED, _STREAM_LENGTHS).integers(
            lo, hi + 1, n_changes)
    values = seeded.rng(seed, _STREAM_VALUES).bytes(int(value_lens.sum()))
    voffs = np.concatenate([[0], np.cumsum(value_lens)]).tolist()

    blob_header = frame_header(blob_bytes, TYPE_BLOB)
    groups = []  # per blob: its change frames + its blob header
    kinds, starts, ends = [], [], []
    at = 0
    for b in range(n_blobs):
        parts = []
        for i in range(b * per_blob, (b + 1) * per_blob):
            payload = change_payload(f"row-{i}", i + 1, 0, 1,
                                     values[voffs[i]:voffs[i + 1]])
            header = frame_header(len(payload), TYPE_CHANGE)
            parts += (header, payload)
            at += len(header)
            kinds.append(KIND_CHANGE)
            starts.append(at)
            at += len(payload)
            ends.append(at)
        parts.append(blob_header)
        at += len(blob_header)
        kinds.append(KIND_BLOB)
        starts.append(at)
        at += blob_bytes
        ends.append(at)
        groups.append(b"".join(parts))

    buf = np.empty(at, dtype=np.uint8)
    blob_jobs = []
    pos = 0
    for b, group in enumerate(groups):
        buf[pos:pos + len(group)] = np.frombuffer(group, dtype=np.uint8)
        pos += len(group)
        blob_jobs.append((buf[pos:pos + blob_bytes], b * blob_bytes))
        pos += blob_bytes
    if blob_bytes % 8:
        raise ValueError("blob_bytes must be a multiple of 8")
    seeded.fill_stream(blob_jobs, seed, _STREAM_BLOBS)

    kinds = np.asarray(kinds, dtype=np.int8)
    seqs = np.empty(len(kinds), dtype=np.int64)
    for kind in (KIND_CHANGE, KIND_BLOB):
        sel = kinds == kind
        seqs[sel] = np.arange(int(sel.sum()))
    return Wire(buf, kinds, np.asarray(starts, dtype=np.int64),
                np.asarray(ends, dtype=np.int64), seqs, values, voffs)
