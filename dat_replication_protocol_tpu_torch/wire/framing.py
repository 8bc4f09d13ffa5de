"""Multibuffer framing — the reference wire's frame types and the
negotiated ``ChangeBatch`` frame.

Every frame on the wire is::

    | varint( len(payload) + 1 ) | 1-byte type id | payload |

The framed length counts the id byte.  The port carries the reference
wire's ``TYPE_CHANGE`` and ``TYPE_BLOB`` and the JAX package's columnar
``TYPE_CHANGE_BATCH`` (``wire/batch_codec.py``), which an encoder emits
only to a peer that advertised ``CAP_CHANGE_BATCH``.  The JAX package's
reconcile and snapshot frames are not parsed here: a frame of any other
id is a protocol error.
"""

from __future__ import annotations

from .varint import MAX_VARINT_LEN, encode_uvarint

TYPE_HEADER = 0  # parser state only; never a valid frame id
TYPE_CHANGE = 1
TYPE_BLOB = 2
# columnar bulk-change frame: the JAX package's negotiated extension, not
# part of the reference wire; a peer that did not advertise
# CAP_CHANGE_BATCH fails on it with its unknown-type error
TYPE_CHANGE_BATCH = 3

# Capability masks travel out of band (session setup): the receiving
# peer advertises what it parses, and an encoder never told anything
# assumes 0, the reference wire byte for byte.
CAP_CHANGE_BATCH = 1  # peer parses TYPE_CHANGE_BATCH frames

# everything this package's Decoder parses: the mask a receiver
# advertises (the JAX package's reconcile and snapshot bits are not
# carried, since their frames are not parsed here)
LOCAL_CAPS = CAP_CHANGE_BATCH

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


class ProtocolError(Exception):
    """Raised (and passed to destroy) on malformed wire data.

    ``frame`` (0-based index of the frame being parsed) and ``offset``
    (wire bytes accepted up to the fault) are optional context, folded
    into ``str(err)`` when present.
    """

    def __init__(self, message: str = "", *, frame: int | None = None,
                 offset: int | None = None):
        self.frame = frame
        self.offset = offset
        context = []
        if frame is not None:
            context.append(f"frame={frame}")
        if offset is not None:
            context.append(f"byte={offset}")
        super().__init__(
            f"{message} [{', '.join(context)}]" if context else message
        )
