"""TYPE_RECONCILE payload codec — the anti-entropy control messages.

The port's own copy of ``dat_replication_protocol_tpu/wire/reconcile_codec.py``.
A reconcile frame's payload is one message of the rateless
reconciliation protocol (WIRE.md "Reconcile"; the symbol math lives in
:mod:`..ops.rateless`, the driver in :mod:`..runtime.reconcile_driver`).
First byte is the subtype; every message is self-delimiting and a
decoder must reject structural corruption (bad subtype/version,
truncated section, trailing bytes) with ``ValueError`` — the session
decoder maps that to its standard :class:`~.framing.ProtocolError`.

Layouts (all integers little-endian, varints unsigned LEB128)::

    BEGIN   u8 subtype=0 | u8 version=1 | varint n_elements
    SYMBOLS u8 subtype=1 | varint start_index | varint count
            | count x 44-byte coded symbols
            (11 u32 words each: [count | checksum lo | checksum hi
             | sum word 0..8) — ops/rateless.py's cell layout verbatim)
    DONE    u8 subtype=2 | varint symbols_used | varint n_digests
            | n_digests x 32-byte digests   (the records the DECODING
            side is missing — "send me these")
    MORE    u8 subtype=3 | varint symbols_seen   (not decoded yet)
    FAIL    u8 subtype=4 | varint symbols_seen | utf-8 reason (to end
            of payload)

Sent only to peers that advertised ``CAP_RECONCILE`` (capability
negotiation is out of band, WIRE.md); a capability-less encoder cannot
emit these frames at all, so the reference wire stays byte-exact.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.rateless import DIGEST_BYTES, SYMBOL_BYTES, SYMBOL_WORDS
from .varint import decode_uvarint, encode_uvarint

RECONCILE_VERSION = 1

RC_BEGIN = 0
RC_SYMBOLS = 1
RC_DONE = 2
RC_MORE = 3
RC_FAIL = 4

_KIND_NAMES = {RC_BEGIN: "begin", RC_SYMBOLS: "symbols", RC_DONE: "done",
               RC_MORE: "more", RC_FAIL: "fail"}


@dataclasses.dataclass(frozen=True)
class ReconcileMsg:
    """One decoded reconcile message.

    ``kind`` is the subtype; the populated fields depend on it:
    ``n`` (begin: sender's element count; more/done/fail:
    symbols seen/used), ``start`` + ``cells`` (symbols: run start index
    and the ``(count, 11)`` u32 cells), ``digests`` (done: the
    ``(k, 32)`` u8 digests being requested), ``reason`` (fail)."""

    kind: int
    n: int = 0
    start: int = 0
    cells: np.ndarray | None = None
    digests: np.ndarray | None = None
    reason: str = ""

    @property
    def kind_name(self) -> str:
        return _KIND_NAMES.get(self.kind, str(self.kind))


def encode_begin(n_elements: int) -> bytes:
    return (bytes((RC_BEGIN, RECONCILE_VERSION))
            + encode_uvarint(n_elements))


def encode_symbols(start: int, cells: np.ndarray) -> bytes:
    cells = np.ascontiguousarray(cells, dtype=np.uint32)
    if cells.ndim != 2 or cells.shape[1] != SYMBOL_WORDS:
        raise ValueError(f"cells must be (k, {SYMBOL_WORDS}) u32")
    if not cells.flags.c_contiguous:
        cells = np.ascontiguousarray(cells)
    return (bytes((RC_SYMBOLS,)) + encode_uvarint(start)
            + encode_uvarint(len(cells))
            + cells.astype("<u4", copy=False).tobytes())


def encode_done(symbols_used: int, digests: np.ndarray) -> bytes:
    digests = np.ascontiguousarray(digests, dtype=np.uint8)
    if digests.ndim != 2 or digests.shape[1] != DIGEST_BYTES:
        raise ValueError(f"digests must be (k, {DIGEST_BYTES}) u8")
    return (bytes((RC_DONE,)) + encode_uvarint(symbols_used)
            + encode_uvarint(len(digests)) + digests.tobytes())


def encode_more(symbols_seen: int) -> bytes:
    return bytes((RC_MORE,)) + encode_uvarint(symbols_seen)


def encode_fail(symbols_seen: int, reason: str) -> bytes:
    return (bytes((RC_FAIL,)) + encode_uvarint(symbols_seen)
            + reason.encode("utf-8"))


def _uvarint(payload, at: int, what: str) -> tuple[int, int]:
    try:
        v, used = decode_uvarint(payload[at:])
    except Exception as e:
        raise ValueError(f"reconcile {what}: bad varint") from e
    return v, at + used


def decode_reconcile(payload) -> ReconcileMsg:
    """Parse one TYPE_RECONCILE payload; ``ValueError`` on any
    structural fault (the decoder maps it to a ProtocolError)."""
    payload = bytes(payload)
    if not payload:
        raise ValueError("empty reconcile payload")
    kind = payload[0]
    if kind == RC_BEGIN:
        if len(payload) < 2:
            raise ValueError("reconcile begin: truncated")
        version = payload[1]
        if version != RECONCILE_VERSION:
            raise ValueError(
                f"reconcile begin: unsupported version {version}")
        n, at = _uvarint(payload, 2, "begin")
        if at != len(payload):
            raise ValueError("reconcile begin: trailing bytes")
        return ReconcileMsg(kind=RC_BEGIN, n=n)
    if kind == RC_SYMBOLS:
        start, at = _uvarint(payload, 1, "symbols")
        count, at = _uvarint(payload, at, "symbols")
        need = count * SYMBOL_BYTES
        if len(payload) - at != need:
            raise ValueError(
                f"reconcile symbols: {len(payload) - at} cell bytes for "
                f"{count} symbols (need {need})")
        cells = np.frombuffer(payload, dtype="<u4", offset=at).reshape(
            count, SYMBOL_WORDS)
        return ReconcileMsg(kind=RC_SYMBOLS, start=start, cells=cells)
    if kind == RC_DONE:
        used, at = _uvarint(payload, 1, "done")
        k, at = _uvarint(payload, at, "done")
        need = k * DIGEST_BYTES
        if len(payload) - at != need:
            raise ValueError(
                f"reconcile done: {len(payload) - at} digest bytes for "
                f"{k} digests (need {need})")
        digests = np.frombuffer(payload, dtype=np.uint8,
                                offset=at).reshape(k, DIGEST_BYTES)
        return ReconcileMsg(kind=RC_DONE, n=used, digests=digests)
    if kind == RC_MORE:
        seen, at = _uvarint(payload, 1, "more")
        if at != len(payload):
            raise ValueError("reconcile more: trailing bytes")
        return ReconcileMsg(kind=RC_MORE, n=seen)
    if kind == RC_FAIL:
        seen, at = _uvarint(payload, 1, "fail")
        try:
            reason = payload[at:].decode("utf-8")
        except UnicodeDecodeError as e:
            raise ValueError("reconcile fail: non-UTF-8 reason") from e
        return ReconcileMsg(kind=RC_FAIL, n=seen, reason=reason)
    raise ValueError(f"unknown reconcile subtype {kind}")
