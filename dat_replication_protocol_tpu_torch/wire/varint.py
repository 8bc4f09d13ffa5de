"""Unsigned LEB128 varints — the length prefix of every wire frame.

The port's own copy of ``dat_replication_protocol_tpu/wire/varint.py``
(the port imports nothing of the JAX package).  A varint stores an
unsigned integer 7 bits at a time, least-significant group first; the
high bit of each byte is a continuation flag.
"""

from __future__ import annotations

MAX_VARINT_LEN = 10  # enough for any uint64


class NeedMoreData(Exception):
    """Raised when a decode needs more bytes than the buffer holds."""


def encode_uvarint(value: int) -> bytes:
    """Encode a non-negative integer as an unsigned LEB128 varint."""
    if value < 0:
        raise ValueError(f"varint cannot encode negative value {value}")
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_uvarint(buf, offset: int = 0) -> tuple[int, int]:
    """Decode a varint from ``buf`` at ``offset``: ``(value, consumed)``.

    Raises :class:`NeedMoreData` if the buffer ends mid-varint and
    ``ValueError`` on a varint longer than MAX_VARINT_LEN.
    """
    value = 0
    shift = 0
    i = offset
    n = len(buf)
    while True:
        if i >= n:
            raise NeedMoreData("truncated varint")
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            if value >= 1 << 64:
                raise ValueError("varint exceeds 64 bits")
            return value, i - offset
        shift += 7
        if i - offset >= MAX_VARINT_LEN:
            raise ValueError("varint too long (corrupt frame header)")


def uvarint_length(value: int) -> int:
    """Number of bytes :func:`encode_uvarint` would produce."""
    return max(1, (value.bit_length() + 6) // 7)
