"""Session layer: Encoder / Decoder, the loopback pipe, the blocking
socket transport (and the asyncio one, :mod:`.aio`), and the
fault-and-recovery layer (faults, resume, reconnect)."""

from .decoder import BlobReader, Decoder, DecoderDestroyedError
from .encoder import (BatchPolicy, BlobLengthError, BlobWriter, Encoder,
                      EncoderDestroyedError)
from .faults import (AsyncFaultyReader, FaultPlan, FaultyReader,
                     FaultyWriter, TransportFault)
from .pipe import Pipe, pipe
from .reconnect import BackoffPolicy, retrying, run_resumable
from .resume import ResumeError, SessionCheckpoint, WireJournal
from .transport import SocketSession, session_over_socketpair

__all__ = ["AsyncFaultyReader", "BackoffPolicy", "BatchPolicy", "BlobLengthError", "BlobReader",
           "BlobWriter", "Decoder", "DecoderDestroyedError", "Encoder",
           "EncoderDestroyedError", "FaultPlan", "FaultyReader",
           "FaultyWriter", "Pipe", "ResumeError", "SessionCheckpoint",
           "SocketSession", "TransportFault", "WireJournal", "pipe",
           "retrying", "run_resumable", "session_over_socketpair"]
