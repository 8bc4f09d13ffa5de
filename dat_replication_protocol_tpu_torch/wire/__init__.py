"""Wire layer: varints, framing, the Change codec and the negotiated
frames' codecs (``wire.batch_codec``, ``wire.reconcile_codec``,
``wire.snapshot_codec``, imported by their consumers)."""

from .change_codec import Change, decode_change, encode_change
from .framing import (CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT,
                      KNOWN_TYPES, LOCAL_CAPS, MAX_HEADER_LEN, TYPE_BLOB,
                      TYPE_CHANGE, TYPE_CHANGE_BATCH, TYPE_HEADER,
                      TYPE_RECONCILE, TYPE_SNAPSHOT, ProtocolError, frame,
                      frame_header)
from .varint import (NeedMoreData, decode_uvarint, encode_uvarint,
                     uvarint_length)

__all__ = ["CAP_CHANGE_BATCH", "CAP_RECONCILE", "CAP_SNAPSHOT", "Change",
           "KNOWN_TYPES", "LOCAL_CAPS", "MAX_HEADER_LEN", "NeedMoreData",
           "ProtocolError", "TYPE_BLOB", "TYPE_CHANGE", "TYPE_CHANGE_BATCH",
           "TYPE_HEADER", "TYPE_RECONCILE", "TYPE_SNAPSHOT",
           "decode_change", "decode_uvarint", "encode_change",
           "encode_uvarint", "frame", "frame_header", "uvarint_length"]
