"""Session layer: Encoder / Decoder, the loopback pipe, the blocking
socket transport and the retry policy."""

from .decoder import BlobReader, Decoder, DecoderDestroyedError
from .encoder import (BatchPolicy, BlobLengthError, BlobWriter, Encoder,
                      EncoderDestroyedError)
from .pipe import Pipe, pipe
from .reconnect import BackoffPolicy, retrying
from .resume import ResumeError
from .transport import SocketSession, session_over_socketpair

__all__ = ["BackoffPolicy", "BatchPolicy", "BlobLengthError", "BlobReader",
           "BlobWriter", "Decoder", "DecoderDestroyedError", "Encoder",
           "EncoderDestroyedError", "Pipe", "ResumeError", "SocketSession",
           "pipe", "retrying", "session_over_socketpair"]
