"""Multibuffer framing — the reference wire's frame types and the
negotiated ``ChangeBatch`` frame.

Every frame on the wire is::

    | varint( len(payload) + 1 ) | 1-byte type id | payload |

The framed length counts the id byte.  The port carries the reference
wire's ``TYPE_CHANGE`` and ``TYPE_BLOB`` and the JAX package's three
negotiated extensions: the columnar ``TYPE_CHANGE_BATCH``
(``wire/batch_codec.py``), the rateless anti-entropy messages of
``TYPE_RECONCILE`` (``wire/reconcile_codec.py``) and the snapshot
bootstrap messages of ``TYPE_SNAPSHOT`` (``wire/snapshot_codec.py``).
An encoder emits each only to a peer that advertised its capability
bit; a frame of any other id is a protocol error.
"""

from __future__ import annotations

from .varint import MAX_VARINT_LEN, decode_uvarint, encode_uvarint

TYPE_HEADER = 0  # parser state only; never a valid frame id
TYPE_CHANGE = 1
TYPE_BLOB = 2
# columnar bulk-change frame: the JAX package's negotiated extension, not
# part of the reference wire; a peer that did not advertise
# CAP_CHANGE_BATCH fails on it with its unknown-type error
TYPE_CHANGE_BATCH = 3
# rateless reconciliation: coded-symbol runs and the begin/more/done/fail
# control messages of the anti-entropy protocol
TYPE_RECONCILE = 4
# content-addressed snapshot bootstrap: manifest, weighted coded-symbol
# chunk reconciliation and verified chunk transfer
TYPE_SNAPSHOT = 5

KNOWN_TYPES = (TYPE_CHANGE, TYPE_BLOB, TYPE_CHANGE_BATCH, TYPE_RECONCILE,
               TYPE_SNAPSHOT)

# Capability masks travel out of band (session setup): the receiving
# peer advertises what it parses, and an encoder never told anything
# assumes 0, the reference wire byte for byte.
CAP_CHANGE_BATCH = 1  # peer parses TYPE_CHANGE_BATCH frames
CAP_RECONCILE = 2  # peer parses TYPE_RECONCILE frames
CAP_SNAPSHOT = 4  # peer parses TYPE_SNAPSHOT frames

# everything this package's Decoder parses: the mask a receiver advertises
LOCAL_CAPS = CAP_CHANGE_BATCH | CAP_RECONCILE | CAP_SNAPSHOT

# Upper bound on header size: 10 varint bytes + 1 id byte.
MAX_HEADER_LEN = MAX_VARINT_LEN + 1


def frame_header(payload_len: int, type_id: int) -> bytes:
    """The wire header for a frame with ``payload_len`` payload bytes."""
    if payload_len < 127:
        return bytes((payload_len + 1, type_id))
    return encode_uvarint(payload_len + 1) + bytes((type_id,))


def frame(type_id: int, payload: bytes) -> bytes:
    """A complete frame: header + payload."""
    return frame_header(len(payload), type_id) + payload


def header_len(payload_len: int) -> int:
    """Byte length of ``frame_header(payload_len, ·)``: the varint of
    ``payload_len + 1`` plus the id byte."""
    if payload_len < 127:
        return 2
    v = payload_len + 1
    n = 1
    while v >= 0x80:
        v >>= 7
        n += 1
    return n + 1


def frame_wire_len(payload_len: int) -> int:
    """Total wire bytes of a frame with ``payload_len`` payload bytes."""
    return header_len(payload_len) + payload_len


def iter_frames(wire):
    """Walk a complete recorded frame stream: yields ``(start, type_id,
    payload_start, end)`` per frame, where ``wire[payload_start:end]``
    is the payload and ``wire[start:end]`` the whole frame."""
    at = 0
    total = len(wire)
    while at < total:
        flen, used = decode_uvarint(wire[at:at + MAX_VARINT_LEN])
        end = at + used + flen
        yield at, wire[at + used], at + used + 1, end
        at = end


class ProtocolError(Exception):
    """Raised (and passed to destroy) on malformed wire data.

    ``frame`` (0-based index of the frame being parsed), ``offset``
    (wire bytes accepted up to the fault) and ``cause`` (the underlying
    exception, such as the ``OSError`` of a dead transport) are optional
    context, folded into ``str(err)`` when present.
    """

    def __init__(self, message: str = "", *, frame: int | None = None,
                 offset: int | None = None,
                 cause: BaseException | None = None):
        self.frame = frame
        self.offset = offset
        self.cause = cause
        context = []
        if frame is not None:
            context.append(f"frame={frame}")
        if offset is not None:
            context.append(f"byte={offset}")
        if cause is not None:
            context.append(f"cause={type(cause).__name__}: {cause}")
        super().__init__(
            f"{message} [{', '.join(context)}]" if context else message
        )
