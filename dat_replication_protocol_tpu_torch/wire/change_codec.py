"""The ``Change`` record and its protobuf (proto2) wire codec.

The port's own copy of the pure-Python path of
``dat_replication_protocol_tpu/wire/change_codec.py`` (the C fast path
is not carried).  The schema::

    message Change {
      optional string subset = 1;
      required string key    = 2;
      required uint32 change = 3;
      required uint32 from   = 4;
      required uint32 to     = 5;
      optional bytes  value  = 6;
    }

Fields are emitted in ascending field-number order with absent
optionals omitted, byte-compatible with standard protobuf encoders.
Decoded absent optionals default to ``''`` / ``b''``.
"""

from __future__ import annotations

import dataclasses

from .varint import NeedMoreData, decode_uvarint, encode_uvarint

_UINT32_MAX = 0xFFFFFFFF

# proto2 tags: (field_number << 3) | wire_type
_TAG_SUBSET = (1 << 3) | 2
_TAG_KEY = (2 << 3) | 2
_TAG_CHANGE = (3 << 3) | 0
_TAG_FROM = (4 << 3) | 0
_TAG_TO = (5 << 3) | 0
_TAG_VALUE = (6 << 3) | 2


@dataclasses.dataclass(slots=True)
class Change:
    """One replicated row mutation (``from_`` because ``from`` is a
    keyword; dict conversion uses the wire names)."""

    key: str
    change: int
    from_: int
    to: int
    value: bytes | None = None
    subset: str | None = None

    @classmethod
    def from_dict(cls, d: dict) -> "Change":
        if "from" in d:
            from_ = d["from"]
        elif "from_" in d:
            from_ = d["from_"]
        else:
            raise KeyError("from")
        return cls(key=d["key"], change=d["change"], from_=from_, to=d["to"],
                   value=d.get("value"), subset=d.get("subset"))

    def to_dict(self) -> dict:
        return {"subset": self.subset, "key": self.key,
                "change": self.change, "from": self.from_, "to": self.to,
                "value": self.value}


def _check_uint32(name: str, v: int) -> int:
    if not isinstance(v, int) or v < 0 or v > _UINT32_MAX:
        raise ValueError(f"Change.{name} must be a uint32, got {v!r}")
    return v


def encode_change(change: Change | dict) -> bytes:
    """Serialize a Change to protobuf bytes (proto2 wire format)."""
    if isinstance(change, dict):
        change = Change.from_dict(change)
    out = bytearray()
    if change.subset is not None:
        raw = change.subset.encode("utf-8")
        out.append(_TAG_SUBSET)
        out += encode_uvarint(len(raw))
        out += raw
    if change.key is None:
        raise ValueError("Change.key is required")
    raw = change.key.encode("utf-8")
    out.append(_TAG_KEY)
    out += encode_uvarint(len(raw))
    out += raw
    out.append(_TAG_CHANGE)
    out += encode_uvarint(_check_uint32("change", change.change))
    out.append(_TAG_FROM)
    out += encode_uvarint(_check_uint32("from", change.from_))
    out.append(_TAG_TO)
    out += encode_uvarint(_check_uint32("to", change.to))
    if change.value is not None:
        raw = bytes(change.value)
        out.append(_TAG_VALUE)
        out += encode_uvarint(len(raw))
        out += raw
    return bytes(out)


def decode_change(buf) -> Change:
    """Parse protobuf bytes into a Change.

    Unknown fields are skipped (proto2 semantics); missing required
    fields raise ``ValueError``.
    """
    buf = memoryview(buf)
    n = len(buf)
    i = 0
    subset = key = value = None
    change_seq = from_ = to = None
    try:
        while i < n:
            tag, used = decode_uvarint(buf, i)
            i += used
            wire_type = tag & 7
            if wire_type == 0:  # varint; uint32 truncates wider values
                v, used = decode_uvarint(buf, i)
                i += used
                if tag == _TAG_CHANGE:
                    change_seq = v & _UINT32_MAX
                elif tag == _TAG_FROM:
                    from_ = v & _UINT32_MAX
                elif tag == _TAG_TO:
                    to = v & _UINT32_MAX
            elif wire_type == 2:  # length-delimited
                ln, used = decode_uvarint(buf, i)
                i += used
                if i + ln > n:
                    raise NeedMoreData("truncated length-delimited field")
                raw = bytes(buf[i: i + ln])
                i += ln
                if tag == _TAG_SUBSET:
                    subset = raw.decode("utf-8")
                elif tag == _TAG_KEY:
                    key = raw.decode("utf-8")
                elif tag == _TAG_VALUE:
                    value = raw
            elif wire_type == 5:  # fixed32 (unknown field skip)
                if i + 4 > n:
                    raise NeedMoreData("truncated fixed32 field")
                i += 4
            elif wire_type == 1:  # fixed64 (unknown field skip)
                if i + 8 > n:
                    raise NeedMoreData("truncated fixed64 field")
                i += 8
            else:
                raise ValueError(f"unsupported protobuf wire type {wire_type}")
    except NeedMoreData as e:
        raise ValueError(f"corrupt Change payload: {e}") from e
    if key is None or change_seq is None or from_ is None or to is None:
        raise ValueError("Change payload missing required fields")
    return Change(key=key, change=change_seq, from_=from_, to=to,
                  value=value if value is not None else b"",
                  subset=subset if subset is not None else "")
