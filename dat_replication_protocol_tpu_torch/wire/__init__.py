"""Wire layer: varints, framing, the Change codec and the negotiated
``ChangeBatch`` frame (``wire.batch_codec``)."""

from .change_codec import Change, decode_change, encode_change
from .framing import (CAP_CHANGE_BATCH, LOCAL_CAPS, TYPE_BLOB, TYPE_CHANGE,
                      TYPE_CHANGE_BATCH, ProtocolError, frame, frame_header)

__all__ = ["CAP_CHANGE_BATCH", "Change", "LOCAL_CAPS", "ProtocolError",
           "TYPE_BLOB", "TYPE_CHANGE", "TYPE_CHANGE_BATCH", "decode_change",
           "encode_change", "frame", "frame_header"]
