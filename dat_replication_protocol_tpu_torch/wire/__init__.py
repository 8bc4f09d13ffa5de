"""Wire layer: varints, reference framing and the Change codec."""

from .change_codec import Change, decode_change, encode_change
from .framing import TYPE_BLOB, TYPE_CHANGE, ProtocolError

__all__ = ["Change", "ProtocolError", "TYPE_BLOB", "TYPE_CHANGE",
           "decode_change", "encode_change"]
