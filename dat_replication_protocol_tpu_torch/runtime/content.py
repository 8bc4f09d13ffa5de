"""Content addressing: chunk -> hash -> Merkle root, and version deltas.

The counterpart of ``dat_replication_protocol_tpu/runtime/content.py``
(:41-304).  :func:`content_address` cuts a blob into content-defined
chunks, hashes every chunk with BLAKE2b-256 and folds the digests to a
Merkle root; :func:`delta` and :func:`reassemble` are dat's dedup
exchange on top.  A blob under ``RESIDENCY_CAP`` takes the
single-residency route (:func:`..ops.fused_cdc_hash.content_begin`, root
folded on the device by B2); a larger one is chunked in slabs
(:func:`..ops.rabin.chunk_stream`), its chunks hashed by
:func:`..batch.feed.hash_extents` from windows of the host buffer
uploaded once and gathered on the device, and folded by ``root_host``,
as the reference routes it on a device.

Telemetry: :func:`content_address` runs inside a
``device.content.address`` span and counts the digests and root it
reads back in ``device.d2h.bytes``; both entry points note the
``cdc.hash`` engine (``<route>-<device>`` single residency, or
``two-pass-<device>``).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..obs.device import note_engine as _note_engine
from ..obs.metrics import OBS as _OBS
from ..obs.metrics import counter as _counter
from ..obs.tracing import trace_span as _trace_span
from ..ops.rabin import _as_u8, default_sizes

_M_D2H = _counter("device.d2h.bytes")


def _extents_from_cuts(cuts) -> tuple[np.ndarray, np.ndarray]:
    """Chunk end-offsets -> (offsets, lengths)."""
    ends = np.asarray(cuts, dtype=np.int64)
    offs = np.concatenate([np.zeros(1, np.int64), ends[:-1]])
    return offs, ends - offs


@dataclasses.dataclass(frozen=True, eq=False)
class ContentSummary:
    """One blob version's content-addressed identity.

    ``cuts``: chunk end-offsets (exclusive, ascending, last == length);
    ``digests``: (nchunks, 32) uint8 BLAKE2b-256 of each chunk;
    ``root``: 32-byte Merkle root over the digests, zero-padded to a
    power of two.  Equality and hash use (length, cuts, root): the root
    commits to every digest.
    """

    length: int
    cuts: list[int]
    digests: np.ndarray
    root: bytes

    def __eq__(self, other) -> bool:
        if not isinstance(other, ContentSummary):
            return NotImplemented
        return (self.length == other.length and self.cuts == other.cuts
                and self.root == other.root)

    def __hash__(self) -> int:
        return hash((self.length, tuple(self.cuts), self.root))

    @property
    def nchunks(self) -> int:
        return len(self.cuts)

    def extents(self) -> tuple[np.ndarray, np.ndarray]:
        """(offsets, lengths) of the chunks."""
        return _extents_from_cuts(self.cuts)


def content_digests(data, avg_bits: int = 13, min_size: int | None = None,
                    max_size: int | None = None, route: str = "fused1p",
                    device="cuda"):
    """Chunk cuts and per-chunk BLAKE2b-256 digests of a byte stream.

    Returns ``(cuts, digests)``: end-offsets (list[int]) and (nchunks,
    32) uint8.  ``route``: ``"fused1p"``, the single-residency pipeline
    with the checked extraction kernel B6 (for blobs under
    ``RESIDENCY_CAP``; larger ones take the two-pass route), or
    ``"2p"``, the two-pass route: :func:`..ops.rabin.chunk_stream`, then
    :func:`..batch.feed.hash_extents` from uploaded windows of the host
    buffer.
    """
    from ..batch.feed import hash_extents
    from ..ops.fused_cdc_hash import RESIDENCY_CAP, content_begin
    from ..ops.merkle import digest_matrix
    from ..ops.rabin import chunk_stream
    from ..utils.device import resolve_device

    if route not in ("fused1p", "2p"):
        raise ValueError(f"unknown content route {route!r}; expected "
                         "'fused1p' or '2p'")
    dev = resolve_device(device)
    buf = _as_u8(data)
    if buf.size == 0:
        return [], np.empty((0, 32), np.uint8)
    min_size, max_size = default_sizes(avg_bits, min_size, max_size)
    if route == "fused1p" and buf.size < RESIDENCY_CAP:
        cuts, hh, hl = content_begin(buf, avg_bits, min_size, max_size,
                                     route="fused1p", device=dev)()
        if _OBS.on:
            _M_D2H.inc(32 * len(cuts))
            _note_engine("cdc.hash", f"fused1p-{dev.type}", bytes=buf.size)
        return cuts, digest_matrix(hh, hl)
    if _OBS.on:
        _note_engine("cdc.hash", f"two-pass-{dev.type}", bytes=buf.size)
    cuts = chunk_stream(buf, avg_bits, min_size, max_size, device=dev)
    offs, lens = _extents_from_cuts(cuts)
    return cuts, hash_extents(buf, offs, lens, device=dev)


def content_address(data, avg_bits: int = 13, min_size: int | None = None,
                    max_size: int | None = None, route: str = "bitmask",
                    device="cuda") -> ContentSummary:
    """Chunk, hash and root a byte stream on ``device``.

    ``route`` picks the candidate-extraction kernel (``bitmask``,
    ``first``, ``fused``, ``fused1p``); every route gives the same cuts.
    Below ``RESIDENCY_CAP`` the blob is uploaded once and the digests
    stay on the device through the Merkle fold (``pad_leaves`` + ``root``
    on B2); above it the slabbed route hashes the chunks from uploaded
    windows of the blob (``hash_extents``) and feeds ``root_host``.
    Empty input has no chunks and the all-zero root.
    """
    from ..batch.feed import hash_extents
    from ..ops import merkle
    from ..ops.fused_cdc_hash import RESIDENCY_CAP, content_begin
    from ..ops.rabin import check_route, chunk_stream
    from ..utils.device import resolve_device

    check_route(route)
    dev = resolve_device(device)
    buf = _as_u8(data)
    n = int(buf.size)
    if n == 0:
        return ContentSummary(0, [], np.empty((0, 32), np.uint8),
                              b"\0" * 32)
    min_size, max_size = default_sizes(avg_bits, min_size, max_size)
    with _trace_span("device.content.address", bytes=n):
        if n < RESIDENCY_CAP:
            if _OBS.on:
                _note_engine("cdc.hash", f"{route}-{dev.type}", bytes=n)
            cuts, hh, hl = content_begin(buf, avg_bits, min_size, max_size,
                                         route=route, device=dev)()
            (root,) = merkle.digests_from_device(
                *merkle.root(*merkle.pad_leaves(hh, hl)))
            if _OBS.on:
                _M_D2H.inc(32 * len(cuts) + 32)  # chunk digests + the root
            return ContentSummary(n, cuts, merkle.digest_matrix(hh, hl),
                                  root)
        if _OBS.on:
            _note_engine("cdc.hash", f"two-pass-{dev.type}", bytes=n)
        cuts = chunk_stream(buf, avg_bits, min_size, max_size, route=route,
                            device=dev)
        offs, lens = _extents_from_cuts(cuts)
        digests = hash_extents(buf, offs, lens, device=dev)
        return ContentSummary(n, cuts, digests, merkle.root_host(digests))


def delta(old: ContentSummary, new: ContentSummary) -> list[int]:
    """Chunk indices of ``new`` whose digests ``old`` does not hold."""
    if old.root == new.root and old.cuts == new.cuts:
        return []
    have = {old.digests[i].tobytes() for i in range(old.nchunks)}
    return [i for i in range(new.nchunks)
            if new.digests[i].tobytes() not in have]


def reassemble(new: ContentSummary, old_data, old: ContentSummary,
               sent: dict[int, bytes]) -> bytes:
    """Rebuild ``new``'s bytes from ``old``'s chunks and the delta.

    ``sent`` maps chunk index -> bytes for every index of
    ``delta(old, new)``.  Raises ``KeyError`` when a chunk is neither
    held nor sent, ``ValueError`` when a sent chunk's digest does not
    match the summary.
    """
    old_buf = _as_u8(old_data)
    by_digest: dict[bytes, tuple[int, int]] = {}
    o_offs, o_lens = old.extents()
    for i in range(old.nchunks):
        by_digest[old.digests[i].tobytes()] = (int(o_offs[i]),
                                               int(o_lens[i]))
    out = bytearray()
    for i in range(new.nchunks):
        d = new.digests[i].tobytes()
        if i in sent:
            piece = sent[i]
            if hashlib.blake2b(piece, digest_size=32).digest() != d:
                raise ValueError(f"chunk {i} digest mismatch")
        else:
            off, ln = by_digest[d]
            piece = memoryview(old_buf[off:off + ln])
        out += piece
    return bytes(out)
