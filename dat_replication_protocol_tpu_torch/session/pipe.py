"""In-process loopback pump connecting an Encoder to a Decoder.

The port's copy of ``dat_replication_protocol_tpu/session/pipe.py``,
the analogue of Node's ``encode.pipe(decode)`` (reference: example.js:53):
a reactive pump that honors both sides' backpressure without an event
loop.  If the decoder stalls on an outstanding app ``done``, the pump
parks and continues when the app drains.
"""

from __future__ import annotations

from .decoder import Decoder
from .encoder import Encoder

DEFAULT_CHUNK = 64 * 1024


class Pipe:
    """Reactive pump with backpressure in both directions."""

    def __init__(self, encoder: Encoder, decoder: Decoder,
                 chunk_size: int = DEFAULT_CHUNK):
        self.encoder = encoder
        self.decoder = decoder
        self.chunk_size = chunk_size
        self._pumping = False
        self._eof_sent = False

    @property
    def done(self) -> bool:
        """True once the session fully completed (or tore down)."""
        return (self.decoder.finished or self.decoder.destroyed
                or self.encoder.destroyed)

    def pump(self) -> bool:
        """Move bytes until the source is dry, the sink stalls, or EOF.
        Returns True when the session fully completed."""
        if self._pumping:
            return self.done
        if self.done or self._eof_sent:
            self._release()
            return self.done
        self._pumping = True
        try:
            while True:
                if self.decoder.destroyed or self.encoder.destroyed:
                    self._release()
                    break
                if not self.decoder.writable():
                    # park: continue pumping when the app drains the decoder
                    self.decoder._write_cbs.append(self._on_drain)
                    break
                data = self.encoder.read(self.chunk_size)
                if data is None:  # EOF
                    self._eof_sent = True
                    self._release()
                    self.decoder.end()
                    break
                if not data:
                    break  # source dry: the readable hook pumps again
                self.decoder.write(data)
        finally:
            self._pumping = False
        return self.done

    def _release(self) -> None:
        """Free the encoder's readable-hook slot once this pipe is done."""
        if self.encoder._on_readable == self.pump:
            self.encoder._detach_readable()

    def _on_drain(self) -> None:
        self.pump()


def pipe(encoder: Encoder, decoder: Decoder,
         chunk_size: int = DEFAULT_CHUNK) -> Pipe:
    """Connect and start pumping; later writes keep flowing through the
    encoder's readable hook."""
    p = Pipe(encoder, decoder, chunk_size)
    encoder._attach_readable(p.pump)
    decoder.on_error(lambda _e: p._release())
    p.pump()
    return p
