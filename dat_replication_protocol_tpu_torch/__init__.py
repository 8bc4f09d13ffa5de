"""dat_replication_protocol_tpu_torch — the PyTorch/CUDA port.

The port of ``dat_replication_protocol_tpu`` (JAX on a TPU) to PyTorch
with hand-written CUDA kernels for an NVIDIA H100.  This package imports
``torch`` and never ``jax``, and nothing of the JAX package: it keeps its
own copies of the wire and session code it needs.

Entry points mirror the reference's two factories (reference:
index.js:1-2)::

    import dat_replication_protocol_tpu_torch as protocol
    enc = protocol.encode()
    dec = protocol.decode(backend="cuda")          # digests on the card
    dec = protocol.decode(backend="cuda", device="cpu")  # plain versions
    protocol.pipe(enc, dec)

``backend="cuda"`` content-hashes every change payload and blob with
batched BLAKE2b-256 on ``device`` (default ``"cuda"``; without a card
that raises).

A receiver that advertised ``Decoder.capabilities()`` (which holds
``CAP_CHANGE_BATCH``) is sent columnar batch frames by an encoder built
with ``protocol.encode(peer_caps=CAP_CHANGE_BATCH)`` or told later by
``enc.negotiate(...)``; ``runtime.replay_log`` replays a whole log of
either framing to columns, and ``batch.leaves_from_columns`` hashes them
to Merkle leaves on B1.

Two replicas converge over a socket with the anti-entropy drivers
(``runtime.reconcile_driver``: rateless reconciliation of change logs;
``runtime.snapshot_driver``: content-addressed bootstrap of a dataset),
served by ``python -m dat_replication_protocol_tpu_torch.sidecar --tcp
HOST:PORT --reconcile LOG`` or ``--snapshot DATA``.

Content addressing (dat's chunked dedup exchange)::

    s = protocol.content_address(blob)            # cuts, digests, root
    need = protocol.delta(old_summary, s)         # chunks to ship
    cuts = protocol.chunk_stream(blob, route="bitmask")
"""

from __future__ import annotations

from .ops.rabin import chunk_stream
from .runtime.content import (content_address, content_digests, delta,
                              reassemble)
from .session import (BatchPolicy, BlobLengthError, BlobReader, BlobWriter,
                      Decoder, Encoder, Pipe, pipe)
from .wire import (CAP_CHANGE_BATCH, CAP_RECONCILE, CAP_SNAPSHOT, Change,
                   ProtocolError, decode_change, encode_change)

__version__ = "0.1.0"


def encode(backend: str = "host", device="cuda", **kwargs) -> Encoder:
    """The producing end of a session (reference: index.js:1).

    ``backend='cuda'`` hashes outgoing payloads on ``device``."""
    if backend == "host":
        return Encoder(**kwargs)
    if backend == "cuda":
        from .backend.cuda_backend import CudaEncoder

        return CudaEncoder(device=device, **kwargs)
    raise ValueError(f"unknown backend {backend!r}")


def decode(backend: str = "host", device="cuda", **kwargs) -> Decoder:
    """The consuming end of a session (reference: index.js:2).

    ``backend='cuda'`` hashes incoming payloads on ``device``."""
    if backend == "host":
        return Decoder(**kwargs)
    if backend == "cuda":
        from .backend.cuda_backend import CudaDecoder

        return CudaDecoder(device=device, **kwargs)
    raise ValueError(f"unknown backend {backend!r}")


__all__ = ["BatchPolicy", "BlobLengthError", "BlobReader", "BlobWriter",
           "CAP_CHANGE_BATCH", "CAP_RECONCILE", "CAP_SNAPSHOT", "Change",
           "Decoder", "Encoder", "Pipe", "ProtocolError", "chunk_stream",
           "content_address", "content_digests", "decode", "decode_change",
           "delta", "encode", "encode_change", "pipe", "reassemble"]
