"""Multibuffer framing — the reference wire's two frame types.

Every frame on the wire is::

    | varint( len(payload) + 1 ) | 1-byte type id | payload |

The framed length counts the id byte.  The port carries only the
reference wire's ``TYPE_CHANGE`` and ``TYPE_BLOB``; the JAX package's
negotiated extensions (batch, reconcile, snapshot frames) are later
slices, and a frame of any other id is a protocol error here.
"""

from __future__ import annotations

from .varint import MAX_VARINT_LEN, encode_uvarint

TYPE_HEADER = 0  # parser state only; never a valid frame id
TYPE_CHANGE = 1
TYPE_BLOB = 2

# Upper bound on header size: 10 varint bytes + 1 id byte.
MAX_HEADER_LEN = MAX_VARINT_LEN + 1


def frame_header(payload_len: int, type_id: int) -> bytes:
    """The wire header for a frame with ``payload_len`` payload bytes."""
    if payload_len < 127:
        return bytes((payload_len + 1, type_id))
    return encode_uvarint(payload_len + 1) + bytes((type_id,))


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
