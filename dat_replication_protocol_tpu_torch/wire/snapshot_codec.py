"""TYPE_SNAPSHOT payload codec — the content-addressed bootstrap messages.

The port's own copy of ``dat_replication_protocol_tpu/wire/snapshot_codec.py``.
A snapshot frame's payload is one message of the snapshot-transfer
protocol (WIRE.md "Snapshot"; the weighted symbol math lives in
:mod:`..ops.rateless`, the driver in :mod:`..runtime.snapshot_driver`).
First byte is the subtype; every message is self-delimiting and a
decoder must reject structural corruption (bad subtype/version,
truncated section, trailing bytes) with ``ValueError`` — the session
decoder maps that to its standard :class:`~.framing.ProtocolError`.

Layouts (all integers little-endian, varints unsigned LEB128)::

    BEGIN   u8 subtype=0 | u8 version=1 | varint n_positions
            | varint n_chunks | varint total_bytes | 32-byte root
            | varint wire_offset | u8 avg_bits | varint min_size
            | varint max_size
            (the manifest summary: n_positions chunk slots totalling
             total_bytes, n_chunks UNIQUE chunks, Merkle root over the
             per-position digests, the live-log wire offset the dataset
             materializes — where an assembled joiner attaches — and
             the CDC parameters the joiner must cut its stale bytes
             with to share chunks)
    SYMBOLS u8 subtype=1 | varint start_index | varint count
            | count x 48-byte weighted coded symbols
            (12 u32 words each: [count | checksum lo | checksum hi
             | sum word 0..8 | length] — ops/rateless.py's weighted
             cell layout verbatim)
    WANT    u8 subtype=2 | u8 mode | mode payload —
            mode 0 (MORE):    varint symbols_seen   (not decoded yet)
            mode 1 (DIGESTS): varint k | k x 32-byte chunk digests
                              (the chunks the joiner is missing)
            mode 2 (ALL):     empty  (cold joiner: every chunk)
    CHUNKS  u8 subtype=3 | varint count
            | count x (32-byte digest | varint length | length bytes)
    DONE    u8 subtype=4 | varint symbols_used | varint n_positions
            | n_positions x varint rank
            (the assembly plan: position i holds the chunk at sorted
             rank[i] of the responder's LEXICOGRAPHICALLY sorted unique
             digest set — an order both sides can compute locally, so
             the manifest's chunk ORDER costs ~log2(n_chunks)/7 bytes
             per position instead of 32)
    FAIL    u8 subtype=5 | varint progress | utf-8 reason (to end of
            payload)

Sent only to peers that advertised ``CAP_SNAPSHOT`` (capability
negotiation is out of band, WIRE.md); a capability-less encoder cannot
emit these frames at all, so the reference wire stays byte-exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.rateless import DIGEST_BYTES, WSYMBOL_BYTES, WSYMBOL_WORDS
from .varint import decode_uvarint, encode_uvarint

SNAPSHOT_VERSION = 1

SN_BEGIN = 0
SN_SYMBOLS = 1
SN_WANT = 2
SN_CHUNKS = 3
SN_DONE = 4
SN_FAIL = 5

WANT_MORE = 0
WANT_DIGESTS = 1
WANT_ALL = 2

_KIND_NAMES = {SN_BEGIN: "begin", SN_SYMBOLS: "symbols", SN_WANT: "want",
               SN_CHUNKS: "chunks", SN_DONE: "done", SN_FAIL: "fail"}
_WANT_NAMES = {WANT_MORE: "more", WANT_DIGESTS: "digests", WANT_ALL: "all"}


@dataclasses.dataclass(frozen=True)
class SnapshotManifest:
    """The BEGIN message's summary of one materialized dataset."""

    n_positions: int       # manifest slots (chunks in dataset order)
    n_chunks: int          # unique chunks (what CHUNKS can ever ship)
    total_bytes: int       # dataset length
    root: bytes            # 32-byte Merkle root over position digests
    wire_offset: int       # live-log offset the dataset materializes
    avg_bits: int          # CDC parameters (joiner must match them)
    min_size: int
    max_size: int


@dataclasses.dataclass(frozen=True)
class SnapshotMsg:
    """One decoded snapshot message.

    ``kind`` is the subtype; populated fields depend on it:
    ``manifest`` (begin), ``start`` + ``cells`` (symbols: run start and
    the ``(count, 12)`` u32 weighted cells), ``mode`` + ``n`` +
    ``digests`` (want), ``chunks`` (chunks: list of ``(digest bytes,
    chunk bytes)``), ``n`` + ``ranks`` (done: symbols used + the
    assembly plan), ``n`` + ``reason`` (fail)."""

    kind: int
    manifest: SnapshotManifest | None = None
    n: int = 0
    start: int = 0
    mode: int = 0
    cells: np.ndarray | None = None
    digests: np.ndarray | None = None
    chunks: list | None = None
    ranks: np.ndarray | None = None
    reason: str = ""

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, str(self.kind))

    @property
    def mode_name(self) -> str:
        return _WANT_NAMES.get(self.mode, str(self.mode))


def encode_begin(man: SnapshotManifest) -> bytes:
    if len(man.root) != DIGEST_BYTES:
        raise ValueError(f"root must be {DIGEST_BYTES} bytes")
    if not 1 <= man.avg_bits <= 255:
        raise ValueError("avg_bits must fit a u8")
    return (bytes((SN_BEGIN, SNAPSHOT_VERSION))
            + encode_uvarint(man.n_positions)
            + encode_uvarint(man.n_chunks)
            + encode_uvarint(man.total_bytes)
            + bytes(man.root)
            + encode_uvarint(man.wire_offset)
            + bytes((man.avg_bits,))
            + encode_uvarint(man.min_size)
            + encode_uvarint(man.max_size))


def encode_symbols(start: int, cells: np.ndarray) -> bytes:
    cells = np.ascontiguousarray(cells, dtype=np.uint32)
    if cells.ndim != 2 or cells.shape[1] != WSYMBOL_WORDS:
        raise ValueError(f"cells must be (k, {WSYMBOL_WORDS}) u32")
    return (bytes((SN_SYMBOLS,)) + encode_uvarint(start)
            + encode_uvarint(len(cells))
            + cells.astype("<u4", copy=False).tobytes())


def encode_want_more(symbols_seen: int) -> bytes:
    return (bytes((SN_WANT, WANT_MORE)) + encode_uvarint(symbols_seen))


def encode_want_digests(digests: np.ndarray) -> bytes:
    digests = np.ascontiguousarray(digests, dtype=np.uint8)
    if digests.ndim != 2 or digests.shape[1] != DIGEST_BYTES:
        raise ValueError(f"digests must be (k, {DIGEST_BYTES}) u8")
    return (bytes((SN_WANT, WANT_DIGESTS)) + encode_uvarint(len(digests))
            + digests.tobytes())


def encode_want_all() -> bytes:
    return bytes((SN_WANT, WANT_ALL))


def encode_chunks(chunks: list) -> bytes:
    """``chunks``: list of ``(digest 32B, bytes-like payload)``."""
    parts = [bytes((SN_CHUNKS,)), encode_uvarint(len(chunks))]
    for digest, data in chunks:
        digest = bytes(digest)
        if len(digest) != DIGEST_BYTES:
            raise ValueError(f"chunk digest must be {DIGEST_BYTES} bytes")
        parts.append(digest)
        parts.append(encode_uvarint(len(data)))
        parts.append(bytes(data))
    return b"".join(parts)


def encode_done_tail(ranks: np.ndarray) -> bytes:
    """The DONE payload minus its ``symbols_used`` prefix: varint
    n_positions + per-rank varints.  Constant per manifest — a source
    caches this blob once and prepends the per-session prefix, instead
    of redoing ~n_positions Python-level varint encodes per session."""
    ranks = np.ascontiguousarray(ranks, dtype=np.int64)
    if ranks.ndim != 1 or (len(ranks) and ranks.min() < 0):
        raise ValueError("ranks must be a 1-D array of >= 0 ints")
    parts = [encode_uvarint(len(ranks))]
    parts.extend(encode_uvarint(int(r)) for r in ranks)
    return b"".join(parts)


def encode_done(symbols_used: int, ranks: np.ndarray | None = None, *,
                tail: bytes | None = None) -> bytes:
    if tail is None:
        tail = encode_done_tail(ranks)
    return bytes((SN_DONE,)) + encode_uvarint(symbols_used) + tail


def encode_fail(progress: int, reason: str) -> bytes:
    return (bytes((SN_FAIL,)) + encode_uvarint(progress)
            + reason.encode("utf-8"))


def _uvarint(payload, at: int, what: str) -> tuple[int, int]:
    try:
        v, used = decode_uvarint(payload, at)
    except Exception as e:
        raise ValueError(f"snapshot {what}: bad varint") from e
    return v, at + used


def decode_snapshot(payload) -> SnapshotMsg:
    """Parse one TYPE_SNAPSHOT payload; ``ValueError`` on any
    structural fault (the decoder maps it to a ProtocolError)."""
    payload = bytes(payload)
    if not payload:
        raise ValueError("empty snapshot payload")
    kind = payload[0]
    if kind == SN_BEGIN:
        if len(payload) < 2:
            raise ValueError("snapshot begin: truncated")
        version = payload[1]
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"snapshot begin: unsupported version {version}")
        npos, at = _uvarint(payload, 2, "begin")
        nchunks, at = _uvarint(payload, at, "begin")
        total, at = _uvarint(payload, at, "begin")
        if len(payload) - at < DIGEST_BYTES + 1:
            raise ValueError("snapshot begin: truncated root")
        root = payload[at:at + DIGEST_BYTES]
        at += DIGEST_BYTES
        wire_offset, at = _uvarint(payload, at, "begin")
        if at >= len(payload):
            raise ValueError("snapshot begin: truncated params")
        avg_bits = payload[at]
        at += 1
        min_size, at = _uvarint(payload, at, "begin")
        max_size, at = _uvarint(payload, at, "begin")
        if at != len(payload):
            raise ValueError("snapshot begin: trailing bytes")
        if nchunks > npos:
            raise ValueError(
                "snapshot begin: more unique chunks than positions")
        return SnapshotMsg(kind=SN_BEGIN, manifest=SnapshotManifest(
            n_positions=npos, n_chunks=nchunks, total_bytes=total,
            root=root, wire_offset=wire_offset, avg_bits=avg_bits,
            min_size=min_size, max_size=max_size))
    if kind == SN_SYMBOLS:
        start, at = _uvarint(payload, 1, "symbols")
        count, at = _uvarint(payload, at, "symbols")
        need = count * WSYMBOL_BYTES
        if len(payload) - at != need:
            raise ValueError(
                f"snapshot symbols: {len(payload) - at} cell bytes for "
                f"{count} symbols (need {need})")
        cells = np.frombuffer(payload, dtype="<u4", offset=at).reshape(
            count, WSYMBOL_WORDS)
        return SnapshotMsg(kind=SN_SYMBOLS, start=start, cells=cells)
    if kind == SN_WANT:
        if len(payload) < 2:
            raise ValueError("snapshot want: truncated")
        mode = payload[1]
        if mode == WANT_MORE:
            seen, at = _uvarint(payload, 2, "want")
            if at != len(payload):
                raise ValueError("snapshot want: trailing bytes")
            return SnapshotMsg(kind=SN_WANT, mode=mode, n=seen)
        if mode == WANT_DIGESTS:
            k, at = _uvarint(payload, 2, "want")
            need = k * DIGEST_BYTES
            if len(payload) - at != need:
                raise ValueError(
                    f"snapshot want: {len(payload) - at} digest bytes "
                    f"for {k} digests (need {need})")
            digests = np.frombuffer(payload, dtype=np.uint8,
                                    offset=at).reshape(k, DIGEST_BYTES)
            return SnapshotMsg(kind=SN_WANT, mode=mode, n=k,
                               digests=digests)
        if mode == WANT_ALL:
            if len(payload) != 2:
                raise ValueError("snapshot want: trailing bytes")
            return SnapshotMsg(kind=SN_WANT, mode=mode)
        raise ValueError(f"snapshot want: unknown mode {mode}")
    if kind == SN_CHUNKS:
        count, at = _uvarint(payload, 1, "chunks")
        chunks = []
        for _ in range(count):
            if len(payload) - at < DIGEST_BYTES:
                raise ValueError("snapshot chunks: truncated digest")
            digest = payload[at:at + DIGEST_BYTES]
            at += DIGEST_BYTES
            ln, at = _uvarint(payload, at, "chunks")
            if len(payload) - at < ln:
                raise ValueError(
                    f"snapshot chunks: {len(payload) - at} payload bytes "
                    f"for a {ln}-byte chunk")
            chunks.append((digest, payload[at:at + ln]))
            at += ln
        if at != len(payload):
            raise ValueError("snapshot chunks: trailing bytes")
        return SnapshotMsg(kind=SN_CHUNKS, n=count, chunks=chunks)
    if kind == SN_DONE:
        used, at = _uvarint(payload, 1, "done")
        npos, at = _uvarint(payload, at, "done")
        # every rank is >= 1 varint byte: bound the claimed count by the
        # bytes actually present BEFORE allocating (a byzantine n here
        # must fail structured, not MemoryError/OOM)
        if npos > len(payload) - at:
            raise ValueError(
                f"snapshot done: {npos} positions claimed, "
                f"{len(payload) - at} payload bytes remain")
        ranks = np.empty(npos, dtype=np.int64)
        for i in range(npos):
            r, at = _uvarint(payload, at, "done")
            ranks[i] = r
        if at != len(payload):
            raise ValueError("snapshot done: trailing bytes")
        return SnapshotMsg(kind=SN_DONE, n=used, ranks=ranks)
    if kind == SN_FAIL:
        progress, at = _uvarint(payload, 1, "fail")
        try:
            reason = payload[at:].decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError("snapshot fail: non-UTF-8 reason") from e
        return SnapshotMsg(kind=SN_FAIL, n=progress, reason=reason)
    raise ValueError(f"unknown snapshot subtype {kind}")
