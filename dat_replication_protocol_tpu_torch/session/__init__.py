"""Session layer: Encoder / Decoder and the loopback pipe."""

from .decoder import BlobReader, Decoder, DecoderDestroyedError
from .encoder import (BatchPolicy, BlobLengthError, BlobWriter, Encoder,
                      EncoderDestroyedError)
from .pipe import Pipe, pipe

__all__ = ["BatchPolicy", "BlobLengthError", "BlobReader", "BlobWriter",
           "Decoder", "DecoderDestroyedError", "Encoder",
           "EncoderDestroyedError", "Pipe", "pipe"]
